"""Build and load the port's CUDA C++ kernels.

Every ``cm3_tpu_torch/csrc/*.cu`` goes into one shared library with a
plain C interface, built for Hopper (``sm_90a``) and loaded with
``ctypes``: one ``nvcc -c`` per source, all started together, then one
``nvcc -shared`` link of their objects, so the build takes as long as
its slowest source.  The sources include no PyTorch header, so the
build takes seconds (PyTorch's own extension builder takes minutes for
a file that includes its headers) and needs no ``ninja``.

* The library goes to ``build/cm3_tpu_torch/`` at the root of the
  checkout (``.gitignore`` lists ``build/``), named by a hash of the
  sources and headers, the flags and ``nvcc --version``, so a stale
  library is never loaded.  The build writes a temporary name and
  renames it into place, so a process never sees half a library.
* It builds at the first call of ``library()``, once per process; no
  import builds anything.
* ``nvcc`` is looked up on ``PATH``, then as ``$CUDA_HOME/bin/nvcc``,
  then as ``/usr/local/cuda/bin/nvcc``; a failed lookup or build raises
  (the build with nvcc's output).
* Each C entry returns ``cudaGetLastError()`` after its launch;
  ``check`` raises with the library's ``cudaGetErrorString`` text.

The loaded library's ``build_info`` holds the nvcc path and version,
the library path, the build seconds, whether it was built or found by
its hash, the commands and ptxas' register report.
"""

from __future__ import annotations

import ctypes
import functools
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import time

PACKAGE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(PACKAGE, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(PACKAGE), "build", "cm3_tpu_torch")
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
COMPILE_FLAGS = ARCH + ("-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                        "-Xptxas", "-v")
LINK_FLAGS = ARCH + ("-shared",)
FLAGS = COMPILE_FLAGS + LINK_FLAGS      # all of them, for the hash

# the C entries and their ctypes signatures
_P, _I, _U32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32
_LL, _F = ctypes.c_longlong, ctypes.c_float
SIGNATURES = {
    "cm3_error_string": ([_I], ctypes.c_char_p),
    # spec, n_words, n_agents, actions, batch, n_steps, seed, rew, ep,
    # stream
    "cm3_checkers_rollout": ([_P, _I, _I, _P, _I, _I, _U32, _P, _P, _P],
                             _I),
    # params, n_params, n_agents, max_steps, actions, batch, n_steps, seed,
    # rew, ep, stream
    "cm3_particle_rollout": ([_P, _I, _I, _I, _P, _I, _I, _U32, _P, _P, _P],
                             _I),
    # floats, n_floats, ints, n_ints, n_agents, actions, batch, n_steps,
    # seed, rew, ep, stream
    "cm3_roadway_rollout": ([_P, _I, _P, _I, _I, _P, _I, _I, _U32, _P, _P,
                             _P], _I),
    # n_agents, fed, out: registers, blocks per SM, threads, local bytes
    "cm3_checkers_rollout_occupancy": ([_I, _I, _P], _I),
    "cm3_particle_rollout_occupancy": ([_I, _I, _P], _I),
    "cm3_roadway_rollout_occupancy": ([_I, _I, _P], _I),
    # count, (p, t, mu, nu, g, step count, new step count, predicate)
    # pointers per segment, sizes, lr per segment, tau, 1 - tau, stream
    "cm3_adam_polyak": ([_I, _P, _P, _P, _F, _F, _P], _I),
    # t, m, n, tau, 1 - tau, predicate, stream
    "cm3_polyak": ([_P, _P, _LL, _F, _F, _P, _P], _I),
    # out: registers, blocks per SM, threads, local bytes
    "cm3_adam_polyak_occupancy": ([_P], _I),
    "cm3_polyak_occupancy": ([_P], _I),
}


def sources():
    """The translation units, in a fixed order."""
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def headers():
    return sorted(glob.glob(os.path.join(CSRC, "*.cuh")))


def find_nvcc() -> str:
    looked = ["PATH"]
    found = shutil.which("nvcc")
    if found:
        return found
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin",
                                       "nvcc"))
    candidates.append("/usr/local/cuda/bin/nvcc")
    for path in candidates:
        looked.append(path)
        if os.access(path, os.X_OK):
            return path
    raise RuntimeError("nvcc not found; looked in " + ", ".join(looked))


def compile_command(nvcc: str, src: str, obj: str):
    return [nvcc, *COMPILE_FLAGS, "-c", "-o", obj, src]


def link_command(nvcc: str, objs, out: str):
    return [nvcc, *LINK_FLAGS, "-o", out, *objs]


def digest(files, flags, nvcc_version: str) -> str:
    """Hash of the files' names and contents, the flags and the
    compiler's version: the library's name."""
    h = hashlib.sha256()
    for path in files:
        h.update(os.path.basename(path).encode() + b"\0")
        with open(path, "rb") as f:
            h.update(f.read() + b"\0")
    h.update("\0".join(flags).encode() + b"\0")
    h.update(nvcc_version.encode())
    return h.hexdigest()[:16]


def _build(nvcc: str, path: str):
    """Compile every source at once, link the objects into a temporary
    name and rename it into place.  Returns the commands, the seconds
    and ptxas' report."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.tmp{os.getpid()}"
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=os.path.dirname(path)) as objdir:
        objs = [os.path.join(objdir, os.path.basename(src) + ".o")
                for src in sources()]
        cmds = [compile_command(nvcc, src, obj)
                for src, obj in zip(sources(), objs)]
        procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True,
                                  cwd=CSRC) for cmd in cmds]
        logs = [proc.communicate()[0] for proc in procs]
        if all(proc.returncode == 0 for proc in procs):
            cmds.append(link_command(nvcc, objs, tmp))
            procs.append(subprocess.run(cmds[-1], stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True,
                                        cwd=CSRC))
            logs.append(procs[-1].stdout)
    failed = [f"exit {proc.returncode}: {' '.join(cmd)}\n{log}"
              for cmd, proc, log in zip(cmds, procs, logs)
              if proc.returncode != 0]
    if failed:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(f"nvcc failed after {time.perf_counter() - t0:.1f}"
                           " s:\n" + "\n".join(failed))
    os.replace(tmp, path)
    return [" ".join(cmd) for cmd in cmds], time.perf_counter() - t0, \
        "".join(logs)


@functools.cache
def library() -> ctypes.CDLL:
    """The kernel library: built at the first call in a process if no
    library of the same hash exists, then loaded."""
    if not sources():
        raise RuntimeError(f"no CUDA sources in {CSRC}")
    nvcc = find_nvcc()
    version = subprocess.run([nvcc, "--version"], capture_output=True,
                             text=True, check=True).stdout
    files = sources() + headers()
    path = os.path.join(BUILD_DIR,
                        f"libcm3_tpu_torch-{digest(files, FLAGS, version)}.so")
    info = dict(nvcc=nvcc, nvcc_version=version.strip().splitlines()[-1],
                library=path, built=False, seconds=0.0, command=None,
                ptxas="")
    if not os.path.exists(path):
        cmds, seconds, log = _build(nvcc, path)
        info.update(built=True, seconds=seconds, command="; ".join(cmds),
                    ptxas=log)
    lib = ctypes.CDLL(path)
    for name, (args, res) in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = args, res
    lib.build_info = info
    return lib


def occupancy(entry: str, *args):
    """A built kernel's registers per thread, resident blocks per SM,
    threads per block and local (spill) bytes per thread, from the
    library's ``entry`` called with ``args`` and the output array
    (``cudaFuncGetAttributes``,
    ``cudaOccupancyMaxActiveBlocksPerMultiprocessor``)."""
    out = (ctypes.c_int * 4)()
    check(getattr(library(), entry)(*args, out), entry)
    return dict(zip(("registers", "blocks_per_sm", "threads",
                     "local_bytes"), out))


def check(code: int, what: str):
    """Raise if a C entry returned a CUDA error code."""
    if code != 0:
        text = library().cm3_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code}: {text}")


def predicate(apply, device, what: str):
    """A kernel's device predicate as the kernels read it: ``apply`` (a
    0-dim bool or integer tensor on ``device``) as a bool tensor, itself
    when it is one (no launch)."""
    if apply.dim() != 0 or apply.device != device:
        raise ValueError(f"{what}: the predicate must be a 0-dim tensor on "
                         f"{device}, got {tuple(apply.shape)} on "
                         f"{apply.device}")
    return apply.bool()

