#!/usr/bin/env python3
"""Run the port's CUDA C++ kernels on the host, without a GPU or
``nvcc``, and hold them against their plain versions on the CPU.

    python3 scripts/torch_host_rehearsal.py [--batch 300] [--steps 130]

Each ``cm3_tpu_torch/csrc/*_rollout.cu`` and ``flat_update.cu`` is
compiled by ``g++`` as C++20 into its own shared library:

* CUDA's qualifiers (``__global__``, ``__device__``,
  ``__launch_bounds__``) are empty macros and ``__shared__`` is
  ``static``;
* a launch ``kernel<<<grid, threads, 0, stream>>>(args)`` runs its blocks
  one after another, one ``std::thread`` per CUDA thread, so
  ``__syncthreads`` is a ``std::barrier`` and a block's threads share its
  ``__shared__`` memory;
* ``__fmul_rn``/``__fadd_rn``/``__fsub_rn``/``__fdiv_rn``/``__fsqrt_rn``
  round through a ``volatile`` float and ``-ffp-contract=off`` forbids
  fused multiply-adds, so every operation rounds as on the card;
  ``sqrtf`` is glibc's, correctly rounded like CUDA's; ``expf``/``log1pf``
  are glibc's, other approximations than CUDA's (and PyTorch's CPU ones).

The rollout entries then run on host buffers, fed and with Philox draws,
and the results are held against the plain versions on the CPU:
episodes exactly; reward sums bit for bit for Checkers and roadway, and
for the particle game to the tolerance of ``chip_smoke.py``'s CPU
comparison where a contact term's ``exp``/``log1p`` differ.  The
seed-stacked convolution's entries (``cm3_seed_conv_forward``,
``cm3_seed_conv_wgrad``, through the wrapper's ``forward_entry`` and
``wgrad_entry``) run over the port's conv shapes and edge shapes (one
filter, eight, more than 32 taps, a 1x1 kernel, even kernels, more
filters than a launch takes, images past a block's shared memory, more
taps than it holds), weights at a seed stride wider than a seed's block,
and are held against the plain versions in float64 within 1e-5 of the
largest magnitude; a seed's weight gradient in a stack of three against
the same seed alone bit for bit; more filters than a launch takes refused
by the C entry.  The flat
updates' entries (``cm3_adam_polyak``, ``cm3_polyak``) run over ragged
sizes, views at offsets of 1-3 floats, several segments in one launch
and device predicates of 0, 1 and none, and are held against the plain
versions bit for bit, the step counts too.  Exits
non-zero on a mismatch.  Builds under a temporary directory and writes
nothing else.
"""

import argparse
import ctypes
import os
import re
import subprocess
import sys
import tempfile

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import PARTICLE_NEAR  # noqa: E402
from cm3_tpu_torch.core.config import (CheckersEnvConfig,  # noqa: E402
                                       ParticleEnvConfig, RoadwayEnvConfig)
from cm3_tpu_torch.algs import common  # noqa: E402
from cm3_tpu_torch.envs import checkers_packed as cp  # noqa: E402
from cm3_tpu_torch.ops import _nvcc, fused_opt, polyak  # noqa: E402
from cm3_tpu_torch.ops import checkers_rollout as cr  # noqa: E402
from cm3_tpu_torch.ops import particle_rollout as pr  # noqa: E402
from cm3_tpu_torch.ops import roadway_rollout as rr  # noqa: E402
from cm3_tpu_torch.ops import seed_conv  # noqa: E402

# the CUDA runtime and device functions the sources use, for the host
PRELUDE = r"""
#pragma once
#include <algorithm>
#include <barrier>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <strings.h>
#include <thread>
#include <vector>

typedef void* cudaStream_t;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct uint4 { unsigned x, y, z, w; };
struct alignas(16) float4 { float x, y, z, w; };
inline uint4 make_uint4(unsigned x, unsigned y, unsigned z, unsigned w) {
  return {x, y, z, w};
}
struct cudaFuncAttributes { int numRegs; size_t localSizeBytes; };
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline const char* cudaGetErrorString(cudaError_t) { return "host"; }
inline cudaError_t cudaFuncGetAttributes(cudaFuncAttributes* a,
                                         const void*) {
  a->numRegs = 0;
  a->localSizeBytes = 0;
  return cudaSuccess;
}
inline cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(
    int* n, const void*, int, size_t) {
  *n = 1;
  return cudaSuccess;
}

#define __global__
#define __device__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__ static

inline thread_local dim3 threadIdx, blockIdx, gridDim;
inline std::barrier<>* host_block_barrier = nullptr;
inline void __syncthreads() { host_block_barrier->arrive_and_wait(); }

template <class F>
void host_launch(dim3 grid, unsigned threads, F body) {
  for (unsigned by = 0; by < grid.y; ++by)
  for (unsigned bx = 0; bx < grid.x; ++bx) {
    std::barrier<> bar(threads);
    host_block_barrier = &bar;
    std::vector<std::thread> pool;
    for (unsigned tx = 0; tx < threads; ++tx)
      pool.emplace_back([&, bx, by, tx] {
        blockIdx = dim3(bx, by);
        gridDim = grid;
        threadIdx = dim3(tx);
        body();
      });
    for (auto& t : pool) t.join();
  }
}

inline float __fmul_rn(float a, float b) { volatile float r = a * b; return r; }
inline float __fadd_rn(float a, float b) { volatile float r = a + b; return r; }
inline float __fsub_rn(float a, float b) { volatile float r = a - b; return r; }
inline float __fdiv_rn(float a, float b) { volatile float r = a / b; return r; }
inline float __fsqrt_rn(float a) { volatile float r = sqrtf(a); return r; }
inline uint32_t __umulhi(uint32_t a, uint32_t b) {
  return static_cast<uint32_t>((static_cast<uint64_t>(a) * b) >> 32);
}
inline int __ffs(int x) { return ffs(x); }
using std::max;
using std::min;
"""

# kernel<...><<<grid, threads, 0, stream>>>(args);
LAUNCH = re.compile(
    r"(\w+(?:<[^;<>]*>)?)<<<([^,]+),([^,]+),[^>]*>>>\((.*?)\);", re.S)


def host_source(path):
    src = open(path).read()
    return LAUNCH.sub(r"host_launch(\2, \3, [&] { \1(\4); });", src)


def build(tmp, name):
    """One source as a host library, with the entries' ctypes
    signatures."""
    inc = os.path.join(tmp, "include")
    os.makedirs(inc, exist_ok=True)
    with open(os.path.join(inc, "cuda_runtime.h"), "w") as f:
        f.write(PRELUDE)
    cpp = os.path.join(tmp, name + ".cpp")
    with open(cpp, "w") as f:
        f.write(host_source(os.path.join(_nvcc.CSRC, name + ".cu")))
    lib = os.path.join(tmp, f"lib{name}.so")
    subprocess.run(["g++", "-std=c++20", "-O1", "-ffp-contract=off",
                    "-fPIC", "-shared", "-pthread", "-I", inc, "-I",
                    _nvcc.CSRC, "-o", lib, cpp], check=True)
    dll = ctypes.CDLL(lib)
    for entry, (args, res) in _nvcc.SIGNATURES.items():
        if hasattr(dll, entry):
            getattr(dll, entry).argtypes = args
            getattr(dll, entry).restype = res
    return dll


def run(lib, call, actions, batch, n_steps, seed):
    rew = np.empty(batch, np.float32)
    ep = np.empty(batch, np.int32)
    acts = None if actions is None else np.ascontiguousarray(actions)
    code = call(lib, None if acts is None else acts.ctypes.data, batch,
                n_steps, seed, rew.ctypes.data, ep.ctypes.data, None)
    if code != 0:
        raise RuntimeError(f"C entry returned {code}")
    return torch.from_numpy(rew), torch.from_numpy(ep)


def hold(what, got, want, tol=None):
    (k_rew, k_ep), (p_rew, p_ep) = got, want
    ok = torch.equal(k_ep, p_ep)
    bit = torch.equal(k_rew, p_rew)
    err = float((k_rew - p_rew).abs().max())
    if tol is None:
        ok = ok and bit
    else:
        ok = ok and torch.allclose(k_rew, p_rew, rtol=tol[0], atol=tol[1])
    print(f"  {what}: episodes equal {torch.equal(k_ep, p_ep)}, reward sums "
          f"bit-equal {bit}, max abs difference {err:.3g}, "
          f"{int((k_rew != p_rew).sum())} of {k_rew.numel()} differ; "
          f"{'ok' if ok else 'MISMATCH'}")
    return ok


def view(gen, n, off):
    """n standard normal floats, ``off`` floats past a 64-byte aligned
    allocation (a view at an offset when ``off`` > 0)."""
    x = torch.empty(n + off)
    x[off:] = torch.from_numpy(gen.standard_normal(n).astype(np.float32))
    return x[off:]


def hold_flat(what, got, want):
    ok = all(torch.equal(a, b) for a, b in zip(got, want))
    err = max((float((a - b).abs().max()) for a, b in zip(got, want)
               if a.numel()), default=0.0)
    print(f"  {what}: bit-equal {ok}, max abs difference {err:.3g}; "
          f"{'ok' if ok else 'MISMATCH'}")
    return ok


def adam_case(lib, gen, segments, tau=0.01, steps=5, apply=None):
    """``cm3_adam_polyak`` over ``segments`` (n, offsets of p, t, mu, nu
    and g, step count, lr) in one launch per step, against the plain
    version per segment; fresh gradients each step; ``apply`` the
    predicate (None, 0 or 1) of every segment."""
    items, ref = [], []
    for n, offs, count, lr in segments:
        p, t, mu, nu, g = (view(gen, n, off) for off in offs)
        nu.abs_().mul_(0.01)
        items.append((common.AdamState(mu, nu, count), p, t, g, lr))
        ref.append((common.AdamState(mu.clone(), nu.clone(), count),
                    p.clone(), t.clone(), g, lr))
    for _ in range(steps):
        for (_, _, _, g, _) in items:
            g.copy_(torch.from_numpy(
                gen.standard_normal(g.numel()).astype(np.float32)))
        on = None if apply is None else torch.tensor(bool(apply))
        counts = torch.empty(len(items), dtype=torch.int32).unbind()
        code = lib.cm3_adam_polyak(
            *fused_opt.c_args(items, counts, on, tau), None)
        if code != 0:
            raise RuntimeError(f"cm3_adam_polyak returned {code}")
        for (st, *_), count in zip(items, counts):
            st.count = count
        fused_opt.adam_polyak_many(ref, tau, on)
    flat = lambda its: [x for st, p, t, _, _ in its
                        for x in (p, t, st.mu, st.nu, st.count)]
    return hold_flat(
        f"adam_polyak, {len(segments)} segment(s) (n, offsets, count, lr) "
        f"{segments}, predicate {apply}, {steps} steps", flat(items),
        flat(ref))


def polyak_case(lib, gen, n, offs, tau, apply=None):
    t, m = (view(gen, n, off) for off in offs)
    on = None if apply is None else torch.tensor(bool(apply))
    want = polyak.polyak_update_plain(t.clone(), m, tau, on)
    code = lib.cm3_polyak(t.data_ptr(), m.data_ptr(), n, tau, 1.0 - tau,
                          None if on is None else on.data_ptr(), None)
    if code != 0:
        raise RuntimeError(f"cm3_polyak returned {code}")
    return hold_flat(f"polyak n={n} offsets {offs} tau {tau} predicate "
                     f"{apply}", [t], [want])


def flat_cases(lib, gen):
    aligned = (0,) * 5
    ok = True
    for n in (0, 1, 3, 1000, 8193):
        ok &= adam_case(lib, gen, [(n, aligned, 0, 1e-3)])
    for n, offs in ((8193, (1,) * 5), (8193, (0, 0, 0, 0, 3)),
                    (8193, (2, 0, 0, 0, 0)), (1000, (3,) * 5)):
        ok &= adam_case(lib, gen, [(n, offs, 3, 1e-3)])
    ok &= adam_case(lib, gen, [(8193, aligned, 0, 1e-3),
                               (1, (0, 1, 0, 0, 0), 5, 1e-4)])
    ok &= adam_case(lib, gen, [(8193, aligned, 0, 1e-3),
                               (1003, aligned, 5, 1e-4),
                               (3, aligned, 999, 1e-2)])
    ok &= adam_case(lib, gen, [(8193, aligned, 0, 1e-3),
                               (1000, (0, 0, 2, 0, 0), 17, 3e-3),
                               (3, aligned, 999, 1e-2),
                               (4099, aligned, 1, 1e-3)])
    for n in (0, 1, 3, 1000, 8193):
        for offs in ((0, 0), (1, 0), (0, 3)):
            for tau in (0.0, 0.01, 1.0):
                ok &= polyak_case(lib, gen, n, offs, tau)
    # the device predicates: 0 writes nothing (the plain version's
    # update at count 0 divides by c1 = 0 and is dropped), 1 writes
    for apply in (0, 1):
        ok &= adam_case(lib, gen, [(8193, aligned, 0, 1e-3),
                                   (1003, (0, 1, 0, 0, 0), 5, 1e-4)],
                        apply=apply)
        for offs in ((0, 0), (1, 0)):
            ok &= polyak_case(lib, gen, 1003, offs, 0.01, apply)
    return ok


# (H, W, C, F, kh, kw): the port's conv shapes (Checkers' state grid and
# observation, the central-V critic, roadway's grid), then edge shapes: the
# last four are even kernels, filters in two groups, images past a block's
# shared memory and more taps than it holds
SEED_CONV_SHAPES = ((3, 9, 2, 4, 3, 5), (5, 5, 3, 6, 3, 3),
                    (3, 9, 2, 2, 3, 5), (13, 9, 2, 4, 5, 3),
                    (4, 6, 3, 1, 5, 5), (5, 5, 3, 8, 1, 1),
                    (2, 3, 4, 8, 3, 3), (4, 5, 2, 3, 2, 4),
                    (3, 4, 2, 11, 3, 3), (30, 30, 2, 3, 3, 5),
                    (6, 7, 4, 2, 9, 9))


def _fail(code, what):
    if code != 0:
        raise RuntimeError(f"{what} returned {code}")


def seed_conv_case(lib, gen, s, r, shape):
    h, w, c, f, kh, kw = shape
    rand = lambda *d: torch.from_numpy(
        gen.standard_normal(d).astype(np.float32))
    x = rand(s, r, h, w, c)
    # each seed's weights a row of a wider buffer, as in a seed stack
    row = rand(s, f * c * kh * kw + f + 3)
    wt = row[:, :f * c * kh * kw].unflatten(1, (f, c, kh, kw))
    b = row[:, f * c * kh * kw:-3]
    g = rand(s, r, h * w * f)

    def call(*args):
        out = seed_conv.forward_entry(lib, *args[:3], fail=_fail)
        return (out, *seed_conv.wgrad_entry(lib, args[3], out, args[0], kh,
                                            kw, fail=_fail))
    out, dw, db = call(x, wt, b, g)
    d = lambda t: t.double()
    want = [seed_conv.forward_plain(d(x), d(wt), d(b)),
            *seed_conv.wgrad_plain(d(g), d(out), d(x), kh, kw)]
    errs = [float((d(k) - p).abs().max() / p.abs().max().clamp_min(1e-30))
            for k, p in zip((out, dw, db), want)]
    ok = max(errs) <= 1e-5
    if s > 1:
        _, dw1, db1 = call(x[1:2], wt[1:2], b[1:2], g[1:2])
        alone = torch.equal(dw1[0], dw[1]) and torch.equal(db1[0], db[1])
        ok = ok and alone
    print(f"  seed_conv S={s} R={r} (H, W, C, F, kh, kw) {shape}: error "
          f"over the largest magnitude out {errs[0]:.2g}, dw {errs[1]:.2g}, "
          f"db {errs[2]:.2g}"
          + ("" if s == 1 else f"; seed 1 alone bit-equal {alone}")
          + f"; {'ok' if ok else 'MISMATCH'}")
    return ok


def seed_conv_cases(lib, gen):
    ok = True
    for shape in SEED_CONV_SHAPES:
        h, w = shape[:2]
        for s, r in ((1, 1), (3, 37) if h * w < 200 else (3, 2)):
            ok &= seed_conv_case(lib, gen, s, r, shape)
    # more filters than a launch takes are refused by the C entry
    f = seed_conv.MAX_FILTERS + 1
    x, w, b = torch.zeros(1, 1, 3, 9, 2), torch.zeros(1, f, 2, 3, 5), \
        torch.zeros(1, f)
    code = lib.cm3_seed_conv_forward(x.data_ptr(), w.data_ptr(), 0,
                                     b.data_ptr(), 0, x.data_ptr(), 1, 1, 3,
                                     9, 2, f, 3, 5, None)
    refused = code != 0
    print(f"  seed_conv's C entry refuses {f} filters in a launch: "
          f"{refused}; {'ok' if refused else 'MISMATCH'}")
    return ok and refused


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=300)
    ap.add_argument("--steps", type=int, default=130)
    ap.add_argument("--seed", type=int, default=11)
    args = ap.parse_args()
    torch.set_num_threads(1)
    b, t, seed = args.batch, args.steps, args.seed
    gen = np.random.default_rng(seed)
    cases = []
    for name, kw, goal in (
            ("two_agents", dict(n_agents=2, agents_r=(0, 2),
                                agents_c=(8, 8)), (True, False)),
            ("one_agent", dict(n_agents=1, agents_r=(2,), agents_c=(8,)),
             (False,))):
        spec = cp.make_spec(CheckersEnvConfig(max_steps=50, **kw), goal)
        cases.append(("checkers_rollout", f"checkers {name}", cr, spec,
                      len(goal), None))
    particle = {
        "n4": ParticleEnvConfig(prob_random=0.0, initial_std=0.0),
        "n2": ParticleEnvConfig(
            n_agents=2, agents_x=(-0.9, 0.9), agents_y=(-0.9, 0.9),
            landmarks_x=(0.9, -0.9), landmarks_y=(0.9, -0.9),
            prob_random=0.0, initial_std=0.0),
        "n4 start within contact range": ParticleEnvConfig(**PARTICLE_NEAR)}
    for name, cfg in particle.items():
        cases.append(("particle_rollout", f"particle {name}", pr, cfg,
                      cfg.n_agents, (1e-5, 1e-3)))
    for name, cfg in {"n2": RoadwayEnvConfig(depart_stdev=0.0),
                      "n1": RoadwayEnvConfig(
                          n_agents=1, goal_lane=(3,), goal_pos=(190.0,),
                          speed=(30.0,), lane=(1,), init_position=(0.0,),
                          depart_mean=(0.0,), depart_stdev=0.0)}.items():
        cases.append(("roadway_rollout", f"roadway {name}", rr, cfg,
                      cfg.n_agents, None))

    ok = True
    with tempfile.TemporaryDirectory() as tmp:
        libs = {}
        for source, what, mod, cfg, n, tol in cases:
            if source not in libs:
                libs[source] = build(tmp, source)
            lib, call = libs[source], mod._call(cfg)
            acts = gen.integers(0, 5, (t, n, b), dtype=np.int32)
            ok &= hold(f"{what}, fed B={b} T={t}",
                       run(lib, call, acts, b, t, 0),
                       mod.rollout_actions_plain(cfg, torch.from_numpy(acts)),
                       tol)
            ok &= hold(f"{what}, Philox B={b} T={t} seed {seed}",
                       run(lib, call, None, b, t, seed),
                       mod.rollout_prng_plain(cfg, b, t, seed, "cpu"), tol)
        ok &= flat_cases(build(tmp, "flat_update"), gen)
        ok &= seed_conv_cases(build(tmp, "seed_conv"), gen)
    print("host rehearsal:", "all held" if ok else "MISMATCH")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
