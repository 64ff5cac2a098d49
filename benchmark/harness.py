"""What every cell's run shares: the files found by name, the checks
before and after a run, the spans around calls into the program, and the
reduction of a profiler trace to what the per-layer readers read.

Spans.  The benchmark records its spans from its own wrappers around
the calls into each layer (``wrap``), as ``torch.profiler``'s user
annotations, so they exist in the traced run only and share the trace's
clock with the kernels and their launches.  A kernel belongs to the
innermost span open on the host when it was launched.

The trace (``Trace``): the device operations (kernels, copies, fills)
of a traced stretch of chunks or calls, each with its span; the
spans themselves; the stretch's length; and the driver's counters and
counts.  A per-layer reader (``metrics/<name>.py``) takes it and returns
its number, or None where it finds nothing to read."""

from __future__ import annotations

import bisect
import functools
import importlib.util
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, "benchmark")
FORBIDDEN = ("jax", "jaxlib", "flax", "cm3_tpu")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def load_json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def load_module(kind: str, name: str):
    """``benchmark/<kind>/<name>.py`` as a module (a name may hold dots)."""
    path = os.path.join(HERE, kind, name + ".py")
    spec = importlib.util.spec_from_file_location(
        f"benchmark_{kind}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell(name: str):
    """(BENCHMARK.json, its workload entry, the cell's file, the
    configuration's file) of the cell ``name``."""
    bench = load_json(ROOT, "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    return (bench, entry, load_json(HERE, "workloads", name + ".json"),
            load_json(ROOT, conf["file"]))


def forbidden_modules():
    """The modules of JAX or the JAX package loaded in this process, by
    whole top-level name (``cm3_tpu_torch`` is not ``cm3_tpu``)."""
    return sorted({m for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN})


# ---- spans ---- #

def wrap(obj, attr: str, span: str):
    """Wrap ``obj.attr`` (a class's function or an instance's method) in
    the span ``span``; returns a function that restores it."""
    import torch

    inner = getattr(obj, attr)

    @functools.wraps(inner)
    def spanned(*args, **kwargs):
        with torch.profiler.record_function(span):
            return inner(*args, **kwargs)

    had = attr in vars(obj)
    setattr(obj, attr, spanned)

    def restore():
        if had:
            setattr(obj, attr, inner)
        else:
            delattr(obj, attr)
    return restore


# ---- the trace ---- #

class Trace:
    """A traced stretch, reduced: ``ops`` [(name, start_us, dur_us,
    span)] of the device, ``spans`` {name: [(start_us, end_us)]} of the
    host, ``window`` (start_us, end_us), and the driver's ``counters``
    and ``counts``."""

    def __init__(self, ops, spans, window, counters=None, counts=None):
        self.ops, self.spans, self.window = ops, spans, window
        self.counters = dict(counters or {})
        self.counts = dict(counts or {})

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-6

    def busy_intervals(self):
        """The union of the device operations' intervals inside the
        window, sorted, as (start_us, end_us)."""
        lo, hi = self.window
        out = []
        for _, t, d, _ in sorted(self.ops, key=lambda o: o[1]):
            a, b = max(t, lo), min(t + d, hi)
            if b <= a:
                continue
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) * 1e-6

    def span_device_s(self, span: str) -> float:
        """Device seconds of the operations launched inside the span
        ``span``: the union of their intervals (operations of one span
        that overlap on several streams count once)."""
        ivs, out = sorted((t, t + d) for _, t, d, sp in self.ops
                          if sp == span), []
        for a, b in ivs:
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return sum(b - a for a, b in out) * 1e-6

    def span_at(self, t_us: float) -> str:
        return _innermost(self.spans, t_us)

    def device_ops(self, top: int = 10):
        """[[name, seconds]] of the device operations that took most
        time, summed by name."""
        tot = {}
        for name, _, d, _ in self.ops:
            tot[name] = tot.get(name, 0.0) + d * 1e-6
        return sorted(([k, v] for k, v in tot.items()),
                      key=lambda kv: -kv[1])[:top]

    def idle_gaps(self, top: int = 10):
        """[[span, seconds]] of the device's idle time inside the window,
        summed by the span the host was in at each gap's middle."""
        lo, hi = self.window
        edges = [lo] + [x for iv in self.busy_intervals() for x in iv] + [hi]
        tot = {}
        for a, b in zip(edges[0::2], edges[1::2]):
            if b > a:
                name = self.span_at((a + b) / 2)
                tot[name] = tot.get(name, 0.0) + (b - a) * 1e-6
        return sorted(([k, v] for k, v in tot.items()),
                      key=lambda kv: -kv[1])[:top]


def _innermost(spans, t_us):
    """The name of the innermost span open at ``t_us`` (the one opened
    last), or "outside spans"."""
    best, best_start = "outside spans", None
    for name, ivs in spans.items():
        i = bisect.bisect_right(ivs, (t_us, float("inf"))) - 1
        if i >= 0 and ivs[i][0] <= t_us <= ivs[i][1]:
            if best_start is None or ivs[i][0] > best_start:
                best, best_start = name, ivs[i][0]
    return best


def reduce_trace(path: str, span_names, window_span: str):
    """(ops, spans, window) of a chrome trace written by
    ``torch.profiler``: the device operations with the span their launch
    fell in, the spans named ``span_names`` and the window span's
    interval."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans = {n: [] for n in span_names}
    window = None
    launches = {}
    dev = []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat")
        if cat == "user_annotation":
            name = e.get("name")
            iv = (float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)))
            if name == window_span:
                window = iv
            elif name in spans:
                spans[name].append(iv)
        elif cat in LAUNCH_CATS:
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                launches[corr] = float(e["ts"])
        elif cat in DEVICE_CATS:
            dev.append(e)
    for ivs in spans.values():
        ivs.sort()
    if window is None:
        raise RuntimeError("the trace has no window span")
    ops = []
    for e in dev:
        t = launches.get(e.get("args", {}).get("correlation"))
        ops.append((e.get("name", "?"), float(e["ts"]),
                    float(e.get("dur", 0)),
                    "outside spans" if t is None else _innermost(spans, t)))
    return ops, spans, window


def profile(out_dir: str, device="cuda"):
    """A ``torch.profiler.profile`` of the host and the device (the host
    alone on the CPU), to be entered and exited around the traced
    stretch."""
    import torch
    from torch.profiler import ProfilerActivity

    os.makedirs(out_dir, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)


def synchronize(device):
    """Wait for the device (nothing to wait for on the CPU)."""
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
