"""``launches_per_chunk``: the device operations (kernels, copies,
fills) launched inside the span around the driver's chunk
(``OffPolicyDriver._chunk``, its env steps and updates included), per
traced chunk."""

INSIDE = ("chunk", "env_step", "update")


def read(trace):
    n_chunks = len(trace.spans.get("chunk") or [])
    if not n_chunks or not trace.ops:
        return None
    n = sum(1 for _, _, _, span in trace.ops if span in INSIDE)
    return n / n_chunks
