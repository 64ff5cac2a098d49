#!/usr/bin/env python3
"""Drive the PyTorch port (``cm3_tpu_torch``) on one NVIDIA GPU and
check it.

Run from the root of a checkout:  python3 chip_smoke.py

Three phases, each between progress lines with its elapsed seconds
and held to a time budget (60 + 60 + 40 s, so that a cold run stays
under 3 minutes):

1. kernel vs plain: the Triton ``adam_polyak`` kernel against its plain
   PyTorch version for 5 steps at the three flat-buffer sizes of the
   main path and at ragged sizes, then its time per launch (CUDA events
   after warm-up; back to back, and inside a CUDA graph for the device
   time alone) beside its memory bound, the plain version's time and
   a library yardstick (``torch.optim.Adam(fused=True).step`` plus
   ``torch._foreach_lerp_``; the port never calls it).
2. the slice: the Checkers stage-2 CM3 training chunk at full width
   (n_envs 256, 10 env steps, 8 updates on B=128, buffer 20000,
   fused optimizer), as ``bench.py``'s headline program runs it for one
   seed: 2 random-fill chunks, then training chunks, with the kernel's
   launch count set to 0 just before and read just after.
3. card against CPU: one fill and one training chunk from the same
   seeded state with the same fed draws on the card and on the CPU
   (plain versions there), compared at a stated tolerance.

Prints a ``kernels`` JSON line, the card's name and power limit, and
last ``{"ok": true, "device": {...}}``.  Any failure raises and exits
non-zero; without a CUDA device, or without the package beside it, it
exits non-zero and prints no result.  Writes nothing into the checkout.
"""

import json
import os
import statistics
import subprocess
import sys
import time

sys.dont_write_bytecode = True

SEED = 0
N_ENVS, BATCH, BUFFER, STEPS, UPDATES = 256, 128, 20000, 10, 8
TRAIN_CHUNKS = 10
EPSILON = 0.2
MAIN_SIZES = {"actor": 149645, "Q_global": 144741, "Q_credit": 144709}
RAGGED = (1, 1000, 8193)
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, float32 non-tensor FLOP/s
HBM_BPS, F32_FLOPS = 3.35e12, 67e12
# per element: 5 float32 loads + 4 stores; ~16 float32 operations
BYTES_PER_ELEM, OPS_PER_ELEM = 36, 16
KERNEL_RTOL, KERNEL_ATOL = 1e-6, 1e-7
# card vs CPU after one training chunk: float32 sums in other orders
# (cuDNN/cuBLAS vs CPU kernels, TF32 off) through 8 Adam steps; atol is
# 1% of one Adam step at lr_Q = 1e-3
PARITY_RTOL, PARITY_ATOL = 1e-4, 1e-5

T0 = time.time()


def log(msg):
    print(msg, flush=True)


def run_phase(name, budget_s, fn, *args):
    """Run one phase between two progress lines; fail it if it takes
    more than its share of the 180 s the whole cold run may take."""
    t0 = time.time()
    log(f"phase {name} (budget {budget_s} s) starts at {t0 - T0:.1f} s")
    out = fn(*args)
    took = time.time() - t0
    log(f"phase {name} took {took:.1f} s")
    if took > budget_s:
        raise RuntimeError(f"phase {name} took {took:.1f} s, over its "
                           f"{budget_s} s budget")
    return out


def smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0] if out else "unknown"


def cuda_time_ms(fn, iters, warmup=20):
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_time_ms(fn, per_graph=50, replays=20):
    """Device time per call: ``per_graph`` calls captured in one CUDA
    graph, replayed ``replays`` times, timed by CUDA events.  No host
    dispatch between the kernels."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(per_graph):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * per_graph)


# ------------------------------------------------------------------ #
# phase 1
# ------------------------------------------------------------------ #


def phase_kernel(dev):
    import torch
    from cm3_tpu_torch.algs import common
    from cm3_tpu_torch.ops import fused_opt

    gen = torch.Generator(device=dev).manual_seed(SEED)
    rnd = lambda n: torch.randn(n, device=dev, generator=gen)
    max_err = 0.0
    for n in list(MAIN_SIZES.values()) + list(RAGGED):
        p, t = rnd(n), rnd(n)
        st = common.adam_init(p)
        rp, rt, rst = p.clone(), t.clone(), common.adam_init(p)
        for _ in range(5):
            g = rnd(n)
            fused_opt.adam_polyak(st, p, t, g, 1e-3, 0.01)
            c1, c2 = fused_opt.bias_corrections(rst.count)
            fused_opt.adam_polyak_plain(rp, rt, rst.mu, rst.nu, g, c1, c2,
                                        1e-3, 0.01)
            rst.count += 1
        torch.cuda.synchronize()
        for got, want in ((p, rp), (t, rt), (st.mu, rst.mu),
                          (st.nu, rst.nu)):
            torch.testing.assert_close(got, want, rtol=KERNEL_RTOL,
                                       atol=KERNEL_ATOL)
            max_err = max(max_err, float((got - want).abs().max()))
        log(f"  adam_polyak n={n}: kernel == plain over 5 steps "
            f"(rtol {KERNEL_RTOL}, atol {KERNEL_ATOL})")

    rows = []
    for name, n in MAIN_SIZES.items():
        p, t, g = rnd(n), rnd(n), 1e-3 * rnd(n)
        st = common.adam_init(p)
        kern = lambda: fused_opt.adam_polyak(st, p, t, g, 1e-3, 0.01)
        c1, c2 = fused_opt.bias_corrections(0)
        plain = lambda: fused_opt.adam_polyak_plain(p, t, st.mu, st.nu, g,
                                                    c1, c2, 1e-3, 0.01)
        lp = torch.nn.Parameter(p.clone())
        lp.grad = g.clone()
        lt = t.clone()
        opt = torch.optim.Adam([lp], lr=1e-3, betas=(0.9, 0.999), eps=1e-8,
                               fused=True)

        def library():
            opt.step()
            torch._foreach_lerp_([lt], [lp.detach()], 0.01)

        k_ms = cuda_time_ms(kern, 500)
        p_ms = cuda_time_ms(plain, 200)
        l_ms = cuda_time_ms(library, 200)
        k_dev = graph_time_ms(kern)
        p_dev = graph_time_ms(plain)
        bytes_ms = BYTES_PER_ELEM * n / HBM_BPS * 1e3
        ops_ms = OPS_PER_ELEM * n / F32_FLOPS * 1e3
        b_ms = max(bytes_ms, ops_ms)
        bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
        rows.append((k_ms, p_ms, l_ms, b_ms))
        log(f"  adam_polyak {name} n={n}: back to back: kernel "
            f"{k_ms * 1e3:.2f} us/launch, plain {p_ms * 1e3:.2f} us, library "
            f"Adam(fused)+lerp {l_ms * 1e3:.2f} us; in a CUDA graph: kernel "
            f"{k_dev * 1e3:.2f} us, plain {p_dev * 1e3:.2f} us; bound "
            f"{b_ms * 1e3:.2f} us ({bound_by})")
    mean = lambda i: sum(r[i] for r in rows) / len(rows)
    return {"max_abs_err": max_err, "ms": mean(0), "plain_ms": mean(1),
            "library_ms": mean(2), "bound_ms": mean(3), "bound_by": bound_by}


# ------------------------------------------------------------------ #
# the slice
# ------------------------------------------------------------------ #


def build(device):
    from cm3_tpu_torch.algs.cm3 import CM3
    from cm3_tpu_torch.core import config, prng
    from cm3_tpu_torch.core.tree import tree_map
    from cm3_tpu_torch.envs.checkers import Checkers
    from cm3_tpu_torch.train.experiments import make_hooks
    from cm3_tpu_torch.train.offpolicy import OffPolicyDriver, init_rollout

    env = Checkers(config.checkers_env_config(2, max_steps=50), device=device)
    alg = CM3("checkers", env.spec(),
              config.AlgConfig(n_agents=2, stage=2, fused_opt=True,
                               grad_clip=0.0),
              config.checkers_nn_config(2), device=device)
    cfg = config.TrainConfig(n_envs=N_ENVS, batch_size=BATCH,
                             buffer_size=BUFFER, steps_per_train=STEPS,
                             updates_per_chunk=UPDATES)
    driver = OffPolicyDriver(make_hooks("checkers", env), alg, cfg)
    rs = init_rollout(driver.hooks, N_ENVS)
    ts = alg.init_state(prng.root_key(SEED))
    import torch
    zeros = torch.zeros((N_ENVS, 2), dtype=torch.int64, device=device)
    tr = driver._transition(rs, zeros, env.step(rs.env_state, zeros)[1])
    buf = driver._replay_init(tree_map(lambda x: x[0], tr))
    return driver, ts, buf, rs


def _finite(ts, buf, metrics):
    import torch
    from cm3_tpu_torch.core.tree import tree_leaves
    for name in ("actor", "actor_tgt", "qg", "qg_tgt", "qc", "qc_tgt"):
        assert torch.isfinite(getattr(ts, name).flat).all(), name
    for name in ("opt_actor", "opt_qg", "opt_qc"):
        o = getattr(ts, name)
        assert torch.isfinite(o.mu).all() and torch.isfinite(o.nu).all(), name
    for path, x in tree_leaves(buf.data):
        if x.is_floating_point():
            assert torch.isfinite(x).all(), path
    for k, v in metrics.items():
        assert torch.isfinite(v), k


def phase_slice(device):
    import torch
    from cm3_tpu_torch.core import prng
    from cm3_tpu_torch.ops import fused_opt

    driver, ts, buf, rs = build(device)
    draws = prng.GeneratorDraws(prng.generator(
        prng.for_purpose(prng.root_key(SEED), prng.ROLLOUT), device))
    for _ in range(2):
        ts, buf, rs, _ = driver._chunk(ts, buf, rs, EPSILON, draws, False,
                                       True)
    torch.cuda.synchronize()
    fused_opt.adam_polyak.launches = 0
    times, per_chunk = [], []
    for _ in range(TRAIN_CHUNKS):
        before = fused_opt.adam_polyak.launches
        t0 = time.perf_counter()
        ts, buf, rs, metrics = driver._chunk(ts, buf, rs, EPSILON, draws,
                                             True, False)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        per_chunk.append(fused_opt.adam_polyak.launches - before)
    launches = fused_opt.adam_polyak.launches
    assert per_chunk == [3 * UPDATES] * TRAIN_CHUNKS, (
        f"adam_polyak launches per training chunk: {per_chunk}")
    _finite(ts, buf, metrics)
    assert buf.size == min((2 + TRAIN_CHUNKS) * STEPS * N_ENVS, BUFFER)
    assert ts.step == UPDATES * TRAIN_CHUNKS
    episodes = int(rs.episodes)
    assert episodes > 0
    steady = statistics.median(times[1:])
    log(f"  {TRAIN_CHUNKS} training chunks: first {times[0] * 1e3:.1f} ms, "
        f"median of the rest {steady * 1e3:.2f} ms "
        f"(min {min(times[1:]) * 1e3:.2f}, max {max(times[1:]) * 1e3:.2f}); "
        f"{N_ENVS * STEPS / steady:.0f} env-steps/s; "
        f"{launches} adam_polyak launches ({launches // TRAIN_CHUNKS} per "
        f"chunk); {episodes} episodes; losses "
        + ", ".join(f"{k} {float(v):.4f}" for k, v in metrics.items()))
    return launches


# ------------------------------------------------------------------ #
# card vs CPU
# ------------------------------------------------------------------ #


def phase_parity(device):
    import numpy as np
    import torch
    from cm3_tpu_torch.core import prng
    from cm3_tpu_torch.core.tree import tree_leaves

    rng = np.random.default_rng(SEED + 1)
    fill = [rng.integers(0, 5, (N_ENVS, 2)) for _ in range(STEPS)]
    act = [rng.gumbel(size=(N_ENVS, 2, 5)).astype(np.float32)
           for _ in range(STEPS)]
    size = 2 * STEPS * N_ENVS
    idx = [rng.integers(0, size, BATCH) for _ in range(UPDATES)]
    upd = [rng.gumbel(size=(BATCH, 2, 5)).astype(np.float32)
           for _ in range(UPDATES)]
    out = {}
    for dev in (device, "cpu"):
        driver, ts, buf, rs = build(dev)
        draws = prng.FedDraws(fill + idx, act + upd, device=dev)
        ts, buf, rs, _ = driver._chunk(ts, buf, rs, EPSILON, draws, False,
                                       True)
        ts, buf, rs, m = driver._chunk(ts, buf, rs, EPSILON, draws, True,
                                       False)
        assert draws.remaining() == {"randint": 0, "gumbel": 0}
        out[dev] = (ts, buf, rs, m)
    (ts_c, buf_c, rs_c, m_c), (ts_h, buf_h, rs_h, m_h) = out[device], \
        out["cpu"]
    worst = {}
    for name in ("actor", "actor_tgt", "qg", "qg_tgt", "qc", "qc_tgt"):
        pairs = [(getattr(ts_c, name).flat, getattr(ts_h, name).flat)]
        if not name.endswith("_tgt"):
            o_c, o_h = getattr(ts_c, "opt_" + name), getattr(ts_h,
                                                              "opt_" + name)
            pairs += [(o_c.mu, o_h.mu), (o_c.nu, o_h.nu)]
        for got, want in pairs:
            torch.testing.assert_close(got.cpu(), want, rtol=PARITY_RTOL,
                                       atol=PARITY_ATOL)
        worst[name] = max(float((g.cpu() - w).abs().max()) for g, w in pairs)
    for (path, x), (_, y) in zip(tree_leaves(buf_c.data),
                                 tree_leaves(buf_h.data)):
        if x.is_floating_point():
            torch.testing.assert_close(x.cpu(), y, rtol=PARITY_RTOL,
                                       atol=PARITY_ATOL)
        else:
            assert torch.equal(x.cpu(), y), path
    for k in m_h:
        torch.testing.assert_close(m_c[k].cpu(), m_h[k], rtol=PARITY_RTOL,
                                   atol=PARITY_ATOL)
    assert int(rs_c.episodes) == int(rs_h.episodes)
    log("  card == CPU after a fill and a training chunk (rtol "
        f"{PARITY_RTOL}, atol {PARITY_ATOL}); max abs differences: "
        + ", ".join(f"{k} {v:.3g}" for k, v in worst.items()))


# ------------------------------------------------------------------ #


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    try:
        import cm3_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script ({e})",
              file=sys.stderr)
        return 1
    # the Checkers nets are convolutional; learning runs pin float32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = smi_line()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    kern = run_phase("1 kernel vs plain", 60, phase_kernel, dev)
    launches = run_phase("2 the slice", 60, phase_slice, dev)
    run_phase("3 card vs CPU", 40, phase_parity, dev)
    log(f"all phases done at {time.time() - T0:.1f} s")

    log(json.dumps({"kernels": [dict(
        name="adam_polyak", route="triton",
        source="cm3_tpu_torch/ops/fused_opt.py",
        replaces="cm3_tpu/ops/fused_opt.py:100", launches=launches,
        max_abs_err=kern["max_abs_err"], ms=kern["ms"],
        plain_ms=kern["plain_ms"], bound_ms=kern["bound_ms"],
        bound_by=kern["bound_by"], library_ms=kern["library_ms"])]}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
