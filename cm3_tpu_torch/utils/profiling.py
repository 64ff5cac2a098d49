"""Tracing / profiling utilities (``cm3_tpu.utils.profiling``).

The reference's only instrumentation is wall-clock columns in
``log_century.csv`` (``train_offpolicy.py:221,403``) and the env/train
split timers of the on-policy loop (``train_onpolicy.py:304-378``).
Kept here, plus trace capture and a steps/sec counter: ``trace`` runs
``torch.profiler`` (the host's operators, and the device's kernels
where a CUDA device is there) and writes a Chrome trace,
``trace.json`` in its directory (open it in ``chrome://tracing`` or
Perfetto); ``annotate`` names a span in it
(``torch.profiler.record_function``).
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Optional

import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block and write ``log_dir/trace.json`` (a Chrome
    trace); yields the ``torch.profiler.profile``, whose
    ``key_averages()`` tabulates it."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


@contextlib.contextmanager
def annotate(name: str):
    """A named span in a ``trace``."""
    with torch.profiler.record_function(name):
        yield


class Throughput:
    """Windowed steps/sec counter."""

    def __init__(self):
        self.t0 = time.time()
        self.units = 0

    def add(self, n: int):
        self.units += n

    def rate(self) -> float:
        dt = time.time() - self.t0
        return self.units / dt if dt > 0 else 0.0

    def reset(self):
        self.t0 = time.time()
        self.units = 0


class SplitTimer:
    """env/train wall-clock split (train_onpolicy.py:304,324,358,378).
    With ``device`` a CUDA device, each section synchronizes it before
    it starts and before it ends, so that a section's time includes the
    device work it queued and not the work queued before it."""

    def __init__(self, device: Optional[torch.device] = None):
        self.totals: Dict[str, float] = {}
        dev = None if device is None else torch.device(device)
        self._cuda = dev if dev is not None and dev.type == "cuda" else None

    def _sync(self):
        if self._cuda is not None:
            torch.cuda.synchronize(self._cuda)

    @contextlib.contextmanager
    def section(self, name: str):
        self._sync()
        t0 = time.time()
        try:
            yield
        finally:
            self._sync()
            self.totals[name] = self.totals.get(name, 0.0) + time.time() - t0

    def summary(self) -> Dict[str, float]:
        return dict(self.totals)
