"""Tracing utilities (``cm3_tpu.utils.profiling``): the program's spans,
their in-memory record, and trace capture.

The reference's only instrumentation is wall-clock columns in
``log_century.csv`` (``train_offpolicy.py:221,403``) and the env/train
split of the on-policy loop (``train_onpolicy.py:304-378``).  The port
names its layers with spans instead (``annotate``), each named
``cm3.<layer>``, where the work happens: the lockstep loop's period row
and host reads (``train/multiseed.py``), the driver's chunk, env step
and its parts, minibatch sample, update and evaluation
(``train/offpolicy.py``), the update's parts (``algs/cm3.py``), every
backward pass (``algs/base.py``) and the fused rollouts' launch
(``ops/_rollout.py``).

Off (no profiler recording and no ``record()`` block) a span costs one
check of the flag torch keeps for fast checks and nothing else.  On, a
span opens ``torch.profiler.record_function(name)``, so that it lands
in a profiler's trace on the device trace's clock, and adds to the
record, per span path (the names of the open spans, outermost first,
joined by "/", e.g. ``cm3.chunk/cm3.update/cm3.backward``): its count,
inclusive host seconds and self host seconds (inclusive less its child
spans').  Inside ``record()`` and ``trace()``, where CUDA is in use, it
also keeps stream seconds: the current stream's elapsed time from the
span's start to its end, from a pair of pooled CUDA events recorded
there.  Stream time counts the stream's idle time inside the span too,
so it is at least the device time of the operations launched inside
it.  The events are read once ``_PENDING_MAX`` pairs wait, those that
have completed, with no wait, and at ``summary()``, after one
synchronise; so at most twice that many are held.  Under a profiler
started by other code a span records no events: its trace has the
device's time.

The record starts afresh when recording turns on: at ``record()`` and
``trace()``, and at the first span entered under a profiler started by
other code after a span ran with recording off or a ``record()`` block
ended.  ``summary()`` returns
it; ``trace(log_dir)`` writes it as ``spans.json`` beside
``trace.json``.  The record is one per process and follows one thread's
spans.  ``spanned(name)`` puts a whole function in a span.
"""

from __future__ import annotations

import contextlib
import functools
import json
import os
import time
from typing import Dict, Optional

import torch
from torch.autograd import profiler as _autograd_profiler

_PENDING_MAX = 4096     # CUDA event pairs held before the completed are read


class _Record:
    """The spans recorded since recording last turned on."""

    def __init__(self):
        self.explicit = False   # inside record() or trace()
        self.stale = True       # a span ran with recording off
        self.top = None         # the innermost open span
        self.free = []          # CUDA events to reuse
        self.reset()

    def reset(self):
        for _, start, end in getattr(self, "pending", ()):
            self.free += (start, end)
        self.stats: Dict[str, list] = {}   # path: [count, host, self, stream]
        self.pending = []                   # (path, start event, end event)
        self.stale = False

    def event(self):
        return (self.free.pop() if self.free
                else torch.cuda.Event(enable_timing=True))

    def resolve(self, wait: bool = True):
        """Add the stream seconds of the pending event pairs to their
        paths and pool their events: all of them after one synchronise,
        or (not ``wait``) the oldest that have completed."""
        if wait and self.pending:
            torch.cuda.synchronize()
        n = 0
        for path, start, end in self.pending:
            if not (wait or end.query()):
                break
            self.stats[path][3] += start.elapsed_time(end) * 1e-3
            self.free += (start, end)
            n += 1
        del self.pending[:n]


_RECORD = _Record()


class _Off:
    """The span while recording is off."""

    __slots__ = ()

    def __enter__(self):
        _RECORD.stale = True

    def __exit__(self, *exc):
        return None


_OFF = _Off()


class _Span:
    __slots__ = ("name", "path", "parent", "fn", "stream", "start", "t0",
                 "children")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        rec = _RECORD
        if rec.stale:
            rec.reset()
        self.parent = rec.top
        self.path = (self.name if self.parent is None
                     else self.parent.path + "/" + self.name)
        rec.top = self
        self.children = 0.0
        self.fn = torch.profiler.record_function(self.name)
        self.fn.__enter__()
        self.stream = self.start = None
        if rec.explicit and torch.cuda.is_initialized():
            self.stream = torch.cuda.current_stream()
            self.start = rec.event()
            self.start.record(self.stream)
        self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        host = time.perf_counter() - self.t0
        rec = _RECORD
        stat = rec.stats.get(self.path)
        if stat is None:
            stat = rec.stats[self.path] = [0, 0.0, 0.0, None]
        if self.start is not None:
            end = rec.event()
            end.record(self.stream)
            rec.pending.append((self.path, self.start, end))
            stat[3] = stat[3] or 0.0
            if len(rec.pending) >= _PENDING_MAX:
                rec.resolve(wait=len(rec.pending) >= 2 * _PENDING_MAX)
        self.fn.__exit__(*exc)
        rec.top = self.parent
        if self.parent is not None:
            self.parent.children += host
        stat[0] += 1
        stat[1] += host
        stat[2] += host - self.children
        return None


def annotate(name: str):
    """The span ``name`` (``cm3.<layer>``), as a context manager."""
    if _autograd_profiler._is_profiler_enabled or _RECORD.explicit:
        return _Span(name)
    return _OFF


def spanned(name: str):
    """A decorator that runs the whole function in the span ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with annotate(name):
                return fn(*args, **kwargs)
        return inner
    return wrap


def summary() -> Dict[str, Dict[str, Optional[float]]]:
    """The record: {span path: {"count", "host_s", "self_s",
    "stream_s"}}, ``stream_s`` None where the span ran without CUDA or
    outside ``record()`` and ``trace()``; empty when nothing was
    recorded."""
    _RECORD.resolve()
    return {path: {"count": count, "host_s": host, "self_s": own,
                   "stream_s": stream}
            for path, (count, host, own, stream) in _RECORD.stats.items()}


@contextlib.contextmanager
def record():
    """Record the program's spans inside the block, stream time included,
    with or without a profiler: the record starts afresh, and
    ``summary()`` reads it after."""
    _RECORD.reset()
    _RECORD.explicit = True
    try:
        yield
    finally:
        _RECORD.explicit = False
        _RECORD.stale = True    # the next recording starts afresh


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block and write ``log_dir/trace.json`` (a Chrome
    trace, for ``chrome://tracing`` or Perfetto) and ``log_dir/spans.json``
    (``summary()`` of the block's spans); yields the
    ``torch.profiler.profile``, whose ``key_averages()`` tabulates it."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=acts)
    with record():
        prof.start()
        try:
            yield prof
        finally:
            prof.stop()
            prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
            with open(os.path.join(log_dir, "spans.json"), "w") as f:
                json.dump(summary(), f, indent=1, sort_keys=True)
