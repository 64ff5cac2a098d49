"""What the rollout kernels' roofline readers share: the least time of a
call (``counts/rollout_ops.least_time``) over the kernel's mean device
time per launch in the traced calls, in percent."""

from benchmark.counts import rollout_ops


def roofline(trace, kernel: str):
    c = trace.counts
    if trace.counters.get("kernel") != kernel or "ops_per_call" not in c:
        return None
    durs = [d for name, _, d, _ in trace.ops
            if "rollout" in name.lower() and kernel in name.lower()]
    if not durs:
        return None
    least, _ = rollout_ops.least_time(c["ops_per_call"], c["mufu_per_call"],
                                   c["bytes_per_call"])
    return 100.0 * least / (sum(durs) / len(durs) * 1e-6)
