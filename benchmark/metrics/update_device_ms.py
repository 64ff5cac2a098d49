"""``update_device_ms``: the device milliseconds (the union of their
intervals) of the operations launched inside the span around the
algorithm's ``update`` (targets, critics' and actor's forward and
backward, Adam and the soft update of all S seeds), per update."""


def read(trace):
    n = len(trace.spans.get("update") or [])
    if not n or not trace.ops:
        return None
    return trace.span_device_s("update") * 1e3 / n
