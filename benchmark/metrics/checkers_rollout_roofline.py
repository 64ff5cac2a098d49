"""``checkers_rollout_roofline``: B2's (``ops/checkers_rollout.py``)
least time of a call, 86 operations per instance-step over the published
issue rate (the binding bound; bytes are 8 a instance), over its mean
device time per launch, in percent."""

from benchmark.metrics import _roofline


def read(trace):
    return _roofline.roofline(trace, "checkers")
