"""``eval_share``: the share of the window's host seconds spent inside
the benchmark's timing wrapper around ``OffPolicyDriver.evaluate`` (the
lockstep loop's evaluations), read in the traced run from the window
that precedes the profiled chunks."""


def read(trace):
    c = trace.counts
    if not c.get("eval_s") or not c.get("window_s"):
        return None
    return c["eval_s"] / c["window_s"]
