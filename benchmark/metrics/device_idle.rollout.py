"""``device_idle.train``: 1 - the union of the device operations'
intervals over the traced calls's length."""


def read(trace):
    if trace.window_s <= 0 or not trace.ops:
        return None
    return 1.0 - trace.busy_s / trace.window_s
