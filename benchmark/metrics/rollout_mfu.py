"""``rollout_mfu``: the whole window's share of the chip's peak in the
rollout cells: the kernel's operations (``counts/rollout_ops.py``) of
every call of the window over the window's host seconds and the
published issue rate (132 SMs x 128 lanes x 1.98 GHz, the rate behind
67 TFLOP/s), in percent.  It bounds the kernel's roofline share: a call
whose host read or launch gap grows shows here and not there."""

from benchmark.counts import rollout_ops


def read(trace):
    c, k = trace.counts, trace.counters
    if "ops_per_call" not in c or not k.get("window_s"):
        return None
    return (100.0 * c["ops_per_call"] * k["window_calls"] / k["window_s"]
            / rollout_ops.ISSUE_PER_S)
