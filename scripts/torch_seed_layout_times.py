#!/usr/bin/env python3
"""The one-seed training chunk in the port's two parameter layouts, in
turns on the card.

``CM3(n_seeds=None)`` keeps each network as a module whose parameters
are views into one flat buffer and calls it directly;
``CM3(n_seeds=1)`` keeps it as a ``nets.SeedStack`` of one seed and maps
every step over the seed axis with ``torch.func.vmap`` of
``functional_call`` (the seed-batched program at S = 1, its data with a
leading [1]).  Both run ``cm3_tpu_torch.bench.train_program``'s chunk
at full width (256 envs, 10 env steps, 8 updates on B = 128), for the
optax and the fused optimizer.  Reports, per layout and optimizer:

  * env-steps/s of blocks of ``--reps`` chunks, each block ended by
    reading the episode counts on the host, the layouts alternating
    (module, stack, stack, module) for ``--rounds`` rounds after the
    warm-up chunks of ``bench.train_blocks``;
  * from one ``torch.profiler`` trace of ``--traced`` chunks: kernel
    launches per chunk and device time per chunk.

Run from the root of a checkout on a machine with a CUDA device:

    python3 scripts/torch_seed_layout_times.py [--reps 10] [--rounds 3]
        [--traced 2] [--out PATH.json]
"""

import argparse
import json
import os
import statistics
import sys
import time

sys.dont_write_bytecode = True
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

LAYOUTS = {"module": None, "stack1": 1}


def trace(program, n, epsilon):
    """(kernel launches, device ms) per chunk over ``n`` traced chunks."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    driver, ts, buf, rs, draws = program
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            ts, buf, rs, _ = driver._chunk(ts, buf, rs, epsilon, draws,
                                           True, False)
        torch.cuda.synchronize()
    program[1:4] = ts, buf, rs
    launches, us = 0, 0.0
    for avg in prof.key_averages():
        if getattr(avg, "device_type", None) != torch.autograd.DeviceType.CUDA:
            continue
        launches += avg.count
        t = getattr(avg, "self_device_time_total", None)
        us += t if t is not None else getattr(avg, "self_cuda_time_total", 0.0)
    return launches / n, us * 1e-3 / n


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--traced", type=int, default=2)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        sys.exit("torch_seed_layout_times: no CUDA device")
    import chip_smoke
    from cm3_tpu_torch import bench

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = chip_smoke.smi_line()
    print(f"card: {card}", flush=True)
    res = {"card": card, "n_envs": chip_smoke.N_ENVS, "reps": args.reps}
    for fused in (False, True):
        opt = "fused" if fused else "optax"
        progs = {name: list(bench.train_program(s, chip_smoke.N_ENVS, fused,
                                                dev, seed=chip_smoke.SEED))
                 for name, s in LAYOUTS.items()}
        rates = {name: [] for name in LAYOUTS}
        for r in range(args.rounds):
            for name in ("module", "stack1", "stack1", "module"):
                t0 = time.perf_counter()
                rates[name] += bench.train_blocks(
                    progs[name], args.reps, 1, warmup=3 if r == 0 else 0,
                    epsilon=chip_smoke.EPSILON)
                print(f"{opt} {name} round {r}: {rates[name][-1]:.1f} "
                      f"env-steps/s ({time.perf_counter() - t0:.1f} s)",
                      flush=True)
        for name in LAYOUTS:
            eps = chip_smoke.EPSILON
            if LAYOUTS[name] is not None:
                eps = torch.full((LAYOUTS[name],), eps, device=dev)
            launches, dev_ms = trace(progs[name], args.traced, eps)
            xs = sorted(rates[name])
            res[f"{opt}_{name}"] = {
                "env_steps_per_s_blocks": rates[name],
                "median": statistics.median(xs), "lo": xs[0], "hi": xs[-1],
                "chunk_ms_median": (chip_smoke.N_ENVS * 10 * 1e3
                                    / statistics.median(xs)),
                "kernel_launches_per_chunk": launches,
                "device_ms_per_chunk": dev_ms,
            }
        a, b = res[f"{opt}_module"], res[f"{opt}_stack1"]
        res[f"{opt}_stack1_over_module"] = b["median"] / a["median"]
        print(f"{opt}: module {a['median']:.1f} ({a['lo']:.1f}-{a['hi']:.1f}) "
              f"env-steps/s, {a['kernel_launches_per_chunk']:.0f} launches, "
              f"{a['device_ms_per_chunk']:.2f} ms device a chunk; "
              f"S = 1 stack {b['median']:.1f} ({b['lo']:.1f}-{b['hi']:.1f}), "
              f"{b['kernel_launches_per_chunk']:.0f} launches, "
              f"{b['device_ms_per_chunk']:.2f} ms device; stack / module "
              f"{res[f'{opt}_stack1_over_module']:.3f}", flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    print(json.dumps({k: v for k, v in res.items()
                      if not isinstance(v, dict)}))


if __name__ == "__main__":
    main()
