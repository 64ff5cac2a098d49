"""``env_step_device_ms``: the device milliseconds (the union of their
intervals) of the operations launched inside the span around the
driver's env step (``OffPolicyDriver._step_once``: policy act, engine
step with the filter, replay add or the dual buffer's flush,
auto-reset), per lockstep step of all S x E instances."""


def read(trace):
    n = len(trace.spans.get("env_step") or [])
    if not n or not trace.ops:
        return None
    return trace.span_device_s("env_step") * 1e3 / n
