"""``roadway_rollout_roofline``: B4's (``ops/roadway_rollout.py``)
least time of a call, the larger of its operations (counted at the
call's inputs on a sample of its instances, ``counts/rollout_ops.
roadway_ops``) over the published issue rate and of its MUFU operations
over the MUFU rate, over its mean device time per launch, in percent."""

from benchmark.metrics import _roofline


def read(trace):
    return _roofline.roofline(trace, "roadway")
