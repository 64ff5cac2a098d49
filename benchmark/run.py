"""Run one cell of the port's benchmark once, on the card.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

The cell is an entry of ``BENCHMARK.json`` at the root of the checkout;
its file ``benchmark/workloads/<cell>.json`` names the configuration's
file, its window driver (``benchmark/drivers/<driver>.py``) and its
traffic.  The run builds the program from the configuration, makes its
inputs and weights from ``--seed``, warms up every shape the cell uses
(set-up), measures for ``--seconds`` (the window), and once the window
has closed and the peak memory is read, compares what the timed path
produced with the plain reference (``benchmark/reference/``).  With
``--trace 0`` the result line holds the cell's end-to-end metrics; with
``--trace 1`` a profiled stretch follows the window and the line holds
the cell's per-layer metrics (``benchmark/metrics/<name>.py``), the
device's busy and window seconds and the breakdown.

The last line of standard output is one JSON object; the numbers
compared stand beside their limits as the last lines of standard error
and under ``compared``, the line's last key.  The run exits non-zero,
and prints no result, without a CUDA device (or with fewer than the
cell asks for), and when JAX or the JAX package is loaded.

Caches: the port's kernels build into ``build/`` of the checkout; the
benchmark points ``TORCH_EXTENSIONS_DIR`` and ``TRITON_CACHE_DIR`` there
too, and writes its trace under ``benchmark_out/`` (both gitignored)."""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse      # noqa: E402
import json          # noqa: E402
import os            # noqa: E402
import sys           # noqa: E402
import types         # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _process_age() -> float:
    """Seconds since this process started (the kernel's start time)."""
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return max(0.0, up - start / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


T_PROCESS = T_START - _process_age()


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def merged_config(conf, workload):
    """The configuration's file with the cell's master overrides."""
    conf = json.loads(json.dumps(conf))
    conf["master"].update(workload.get("master", {}))
    return conf


def main(argv=None) -> int:
    args = parse(argv)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    build = os.path.join(ROOT, "build")
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          os.path.join(build, "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(build, "triton"))
    os.environ.setdefault("USE_FLAX", "0")
    from benchmark import harness

    bench, entry, workload, conf = harness.cell(args.workload)

    import torch

    chips = entry["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: the cell needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 1
    driver = harness.load_module("drivers", workload["driver"])
    ctx = types.SimpleNamespace(
        workload=workload, config=merged_config(conf, workload),
        seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
        device="cuda", t_process=T_PROCESS,
        out_dir=os.path.join(ROOT, "benchmark_out", args.workload))
    torch.cuda.reset_peak_memory_stats()
    run = driver.Run(ctx).run()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    t_check = time.perf_counter()
    compared = run.check()
    print(f"benchmark: set-up {run.setup_s:.3f} s, run ended at "
          f"{t_check - T_PROCESS:.3f} s, check "
          f"{time.perf_counter() - t_check:.3f} s", file=sys.stderr)
    correct = all(v <= lim for _, v, lim in compared)

    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": chips, "memory_peak_bytes": int(peak)}
    if args.trace:
        metrics = {}
        for m in bench["per_layer"]:
            if args.workload not in m.get("workloads", [args.workload]):
                continue
            value = harness.load_module("metrics", m["name"]).read(run.trace)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        device.update(busy_s=run.trace.busy_s, window_s=run.trace.window_s)
        extra = {"breakdown": {"device_ops": run.trace.device_ops(),
                               "idle_gaps": run.trace.idle_gaps()}}
    else:
        metrics = {m["name"]: {"value": run.metrics[m["name"]],
                               "unit": m["unit"]}
                   for m in bench["end_to_end"]
                   if args.workload in m.get("workloads", [args.workload])}
        extra = {}

    found = harness.forbidden_modules()
    if found:
        print("benchmark: JAX or the JAX package is loaded: "
              + ", ".join(found), file=sys.stderr)
        return 1
    for name, value, limit in compared:
        print(f"compared {name} {value!r} limit {limit!r}", file=sys.stderr)
    line = {"correct": correct, "attempted": run.attempted,
            "failed": run.failed, "metrics": metrics, "device": device}
    line.update(extra)
    line["compared"] = {name: {"value": value, "limit": limit}
                        for name, value, limit in compared}
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
