#!/usr/bin/env python3
"""Time builds of the particle rollout kernel that differ only in their
compile-time settings, against each other, on one NVIDIA GPU.

    python3 scripts/torch_particle_variants.py \
        [--variants THREADS=256,MIN_BLOCKS=4 THREADS=256,MIN_BLOCKS=8 ...]

Each variant is ``cm3_tpu_torch/csrc/particle_rollout.cu`` compiled by
``nvcc`` with the package's flags plus ``-DCM3_PARTICLE_<NAME>=<VALUE>``
for each of its settings (``THREADS`` and ``MIN_BLOCKS`` set the block
size and ``__launch_bounds__``'s least resident blocks per SM), linked
alone into a library under a temporary directory.  For each it prints
ptxas' registers and spills and the occupancy the runtime reports, then
times ``bench.py``'s particle call (B = 2^20, T = 2048, four agents,
seed 99) with CUDA events, the variants in turns (forward, then
backward, ``--rounds`` times), and holds every variant's outputs equal to
the package's kernel bit for bit.  Prints the card's name and power
limit.  Needs a CUDA device and ``nvcc``; writes nothing outside its
temporary directory.
"""

import argparse
import ctypes
import os
import statistics
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

DEFAULT_VARIANTS = ("THREADS=256,MIN_BLOCKS=4", "THREADS=256,MIN_BLOCKS=6",
                    "THREADS=256,MIN_BLOCKS=8", "THREADS=128,MIN_BLOCKS=12")
B, T, SEED = 1 << 20, 2048, 99


def build(nvcc, tmp, name, settings):
    from cm3_tpu_torch.ops import _nvcc
    src = os.path.join(_nvcc.CSRC, "particle_rollout.cu")
    obj = os.path.join(tmp, name + ".o")
    lib = os.path.join(tmp, f"lib{name}.so")
    cmd = _nvcc.compile_command(nvcc, src, obj)
    cmd[1:1] = [f"-DCM3_PARTICLE_{kv}" for kv in settings.split(",")]
    log = subprocess.run(cmd, capture_output=True, text=True, check=True,
                         cwd=_nvcc.CSRC)
    subprocess.run(_nvcc.link_command(nvcc, [obj], lib), check=True)
    dll = ctypes.CDLL(lib)
    for entry in ("cm3_particle_rollout", "cm3_particle_rollout_occupancy"):
        fn = getattr(dll, entry)
        fn.argtypes, fn.restype = _nvcc.SIGNATURES[entry]
    ptxas = [line.strip() for line in (log.stdout + log.stderr).splitlines()
             if "registers" in line or "spill" in line]
    return dll, ptxas


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--variants", nargs="+", default=list(DEFAULT_VARIANTS))
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        sys.exit("torch_particle_variants: no CUDA device")
    import chip_smoke
    from cm3_tpu_torch.core.config import ParticleEnvConfig
    from cm3_tpu_torch.ops import _nvcc
    from cm3_tpu_torch.ops import particle_rollout as pr

    print(f"card: {chip_smoke.smi_line()}", flush=True)
    cfg = ParticleEnvConfig(prob_random=0.0, initial_std=0.0)
    dev = torch.device("cuda", 0)
    want = pr.rollout_prng(cfg, B, T, SEED, device=dev)
    nvcc = _nvcc.find_nvcc()
    with tempfile.TemporaryDirectory() as tmp:
        libs = {}
        for i, settings in enumerate(args.variants):
            lib, ptxas = build(nvcc, tmp, f"v{i}", settings)
            libs[settings] = lib
            out = (ctypes.c_int * 4)()
            _nvcc.check(lib.cm3_particle_rollout_occupancy(4, 0, out),
                        settings)
            print(f"{settings}: {out[0]} registers, {out[1]} blocks of "
                  f"{out[2]} threads per SM, {out[3]} local bytes (N = 4, "
                  "Philox)", flush=True)
            for line in ptxas:
                print(f"  ptxas: {line}")

        rew = torch.empty(B, dtype=torch.float32, device=dev)
        ep = torch.empty(B, dtype=torch.int32, device=dev)

        def call(lib):
            stream = torch.cuda.current_stream(dev).cuda_stream
            _nvcc.check(pr._call(cfg)(lib, None, B, T, SEED, rew.data_ptr(),
                                      ep.data_ptr(), stream), "variant")

        times = {s: [] for s in libs}
        order = list(libs)
        for _ in range(args.rounds):
            for settings in order + order[::-1]:
                call(libs[settings])                      # warm-up
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                call(libs[settings])
                end.record()
                torch.cuda.synchronize()
                times[settings].append(start.elapsed_time(end))
                assert torch.equal(rew, want[0]) and torch.equal(ep, want[1]), \
                    f"{settings}: outputs differ from the package's kernel"
        for settings, ms in times.items():
            print(f"{settings}: {statistics.median(ms):.3f} ms per call "
                  f"(median of {len(ms)}, {min(ms):.3f}-{max(ms):.3f}); "
                  "bit-equal to the package's kernel", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
