#!/usr/bin/env python3
"""Where the PyTorch port's training chunk spends its time on the card.

Builds the full-width Checkers stage-2 CM3 chunk as ``chip_smoke.py``
does (n_envs 256, 10 env steps, 8 updates on B=128, fused optimizer)
or, with ``--seeds S``, the chunk of S seeds in lockstep of
``cm3_tpu_torch.bench.train_program`` (``train_env_steps_per_s``'s
program at S = 16: 256 envs per seed, the optax optimizer unless
``--fused``), and reports:

  * host-clock split of a chunk into its env steps (with replay adds
    and auto-resets) and its updates, each ended by a synchronize,
    median over ``--chunks`` chunks;
  * a ``torch.profiler`` trace of ``--traced`` chunks: device time of
    the CUDA kernels against wall time (the device's busy share),
    kernel launches per chunk, the kernels that take most time, and
    the Adam + Polyak kernel's (B1) launches per chunk and device time
    per launch as the chunk calls it, with whatever the L2 holds after
    the backward pass.

Run from the root of a checkout on a machine with a CUDA device:

    python3 scripts/torch_chunk_profile.py [--chunks 10] [--traced 3]
        [--seeds S [--fused]] [--out PATH.json]
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


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--chunks", type=int, default=10)
    ap.add_argument("--traced", type=int, default=3)
    ap.add_argument("--seeds", type=int, default=None)
    ap.add_argument("--fused", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        sys.exit("torch_chunk_profile: no CUDA device")
    import chip_smoke
    from cm3_tpu_torch.core import prng

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = chip_smoke.smi_line()
    if args.seeds is None:
        driver, ts, buf, rs = chip_smoke.build(dev)
        draws = prng.GeneratorDraws(prng.generator(1, dev))
        eps = chip_smoke.EPSILON
    else:
        from cm3_tpu_torch import bench
        driver, ts, buf, rs, draws = bench.train_program(
            args.seeds, chip_smoke.N_ENVS, args.fused, dev)
        eps = torch.full((args.seeds,), chip_smoke.EPSILON, device=dev)
    for _ in range(2):
        ts, buf, rs, _ = driver._chunk(ts, buf, rs, eps, draws, False, True)
    ts, buf, rs, _ = driver._chunk(ts, buf, rs, eps, draws, True, False)
    torch.cuda.synchronize()

    cfg = driver.cfg
    shape = driver.lead[:-1] + (cfg.batch_size, 2, driver.alg.n_actions)
    instances = cfg.n_envs * (args.seeds or 1)
    env_s, upd_s, chunk_s = [], [], []
    for _ in range(args.chunks):
        t0 = time.perf_counter()
        for _ in range(cfg.steps_per_train):
            rs, buf = driver._step_once(ts, rs, buf, eps, draws, False)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for _ in range(cfg.updates_per_chunk):
            batch = driver._replay_sample(buf, draws)
            ts, _ = driver.alg.update(ts, batch, eps, draws.gumbel(shape))
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        env_s.append(t1 - t0)
        upd_s.append(t2 - t1)
        chunk_s.append(t2 - t0)

    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.traced):
            ts, buf, rs, _ = driver._chunk(ts, buf, rs, eps, draws, True,
                                           False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = []
    for avg in prof.key_averages():
        if getattr(avg, "device_type", None) != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(avg, "self_device_time_total", None)
        if us is None:
            us = getattr(avg, "self_cuda_time_total", 0.0)
        kernels.append((avg.key, avg.count, us))
    kernels.sort(key=lambda k: -k[2])
    dev_us = sum(k[2] for k in kernels)
    launches = sum(k[1] for k in kernels)

    b1 = [k for k in kernels if "adam_polyak" in k[0]]
    b1_launches = sum(k[1] for k in b1)
    med = statistics.median
    res = {
        "card": card,
        "seeds": args.seeds,
        "optimizer": "fused" if driver.alg.cfg.fused_opt else "optax",
        "chunk_ms": med(chunk_s) * 1e3,
        "env_steps_ms": med(env_s) * 1e3,
        "updates_ms": med(upd_s) * 1e3,
        "env_steps_per_s": instances * cfg.steps_per_train / med(chunk_s),
        "traced_chunks": args.traced,
        "traced_wall_ms_per_chunk": wall * 1e3 / args.traced,
        "device_ms_per_chunk": dev_us * 1e-3 / args.traced,
        "device_busy_share": (dev_us * 1e-6 / wall) if wall else None,
        "kernel_launches_per_chunk": launches / args.traced,
        "adam_polyak_launches_per_chunk": b1_launches / args.traced,
        "adam_polyak_us_per_launch": (sum(k[2] for k in b1) / b1_launches
                                      if b1_launches else None),
        "top_kernels": [{"name": k[0][:90], "launches_per_chunk":
                         k[1] / args.traced, "device_us_per_chunk":
                         k[2] / args.traced} for k in kernels[:12]],
    }
    print(f"card: {card}; {args.seeds or 1} seed(s) x {cfg.n_envs} envs, "
          f"{res['optimizer']} optimizer")
    print(f"chunk {res['chunk_ms']:.2f} ms = env steps "
          f"{res['env_steps_ms']:.2f} ms + updates {res['updates_ms']:.2f} ms "
          f"(medians of {args.chunks}); {res['env_steps_per_s']:.0f} "
          "env-steps/s")
    print(f"traced: {res['traced_wall_ms_per_chunk']:.2f} ms wall per chunk, "
          f"{res['device_ms_per_chunk']:.3f} ms device, busy share "
          f"{res['device_busy_share']}, "
          f"{res['kernel_launches_per_chunk']:.0f} kernel launches per chunk")
    print(f"adam_polyak: {res['adam_polyak_launches_per_chunk']:.0f} "
          f"launches per chunk, {res['adam_polyak_us_per_launch']} us of "
          "device time per launch")
    for k in res["top_kernels"]:
        print(f"  {k['device_us_per_chunk']:9.1f} us "
              f"{k['launches_per_chunk']:6.1f}x  {k['name']}")
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    print(json.dumps({k: v for k, v in res.items() if k != "top_kernels"}))


if __name__ == "__main__":
    main()
