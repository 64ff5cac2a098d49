"""``device_idle.train``: 1 - the union of the device operations'
intervals over the traced chunks' length (the window's evaluations are
not in them: ``eval_share`` reads those)."""


def read(trace):
    if trace.window_s <= 0 or not trace.ops:
        return None
    return 1.0 - trace.busy_s / trace.window_s
