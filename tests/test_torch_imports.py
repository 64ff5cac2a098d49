"""The port stands alone: no module of ``cm3_tpu_torch``, not
``chip_smoke.py`` and not the port's scripts import JAX, flax, optax,
orbax, TensorBoard (the event files are hand-encoded) or ``cm3_tpu``,
none of them imports Triton (every kernel is CUDA C++, built by
``nvcc``), and importing the whole package loads neither JAX nor
Triton.  The multi-process layer (``cm3_tpu_torch/parallel/``) and the
code the tests' gloo ranks run import ``torch.distributed`` and nothing
of JAX."""

import ast
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "tensorboard",
             "cm3_tpu")


def _sources():
    scripts = os.path.join(ROOT, "scripts")
    out = [os.path.join(ROOT, "chip_smoke.py")] + [
        os.path.join(scripts, f) for f in sorted(os.listdir(scripts))
        if f.startswith("torch_") and f.endswith(".py")]
    for d, _, files in os.walk(os.path.join(ROOT, "cm3_tpu_torch")):
        out += [os.path.join(d, f) for f in sorted(files) if f.endswith(".py")]
    return out


def _modules():
    return sorted(
        os.path.relpath(p, ROOT)[:-3].replace(os.sep, ".").replace(
            ".__init__", "")
        for p in _sources() if "cm3_tpu_torch" in p)


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            yield node.module or ""


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_imports(path):
    for name in _imports(path):
        assert name.split(".")[0] not in FORBIDDEN, (path, name)


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_triton_imports(path):
    for name in _imports(path):
        assert name.split(".")[0] != "triton", (path, name)


def test_importing_the_port_loads_no_jax_and_no_triton():
    code = ("import importlib, sys\n"
            f"for m in {_modules()!r}: importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN + ('triton',)!r}]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   timeout=120)


@pytest.mark.parametrize("module", ["cm3_tpu_torch.train.checkpoint",
                                    "cm3_tpu_torch.train.logging",
                                    "cm3_tpu_torch.train.runner",
                                    "cm3_tpu_torch.algs.base",
                                    "cm3_tpu_torch.algs.baseline",
                                    "cm3_tpu_torch.algs.qmix",
                                    "cm3_tpu_torch.envs.particle",
                                    "cm3_tpu_torch.train.onpolicy",
                                    "cm3_tpu_torch.parallel",
                                    "cm3_tpu_torch.parallel.dist",
                                    "cm3_tpu_torch.parallel.mesh"])
def test_the_runner_modules_are_scanned(module):
    """The curriculum's, the algorithms', the particle engine's and the
    on-policy driver's modules are among those the scans above read."""
    assert module in _modules()


RANK_CODE = ["cm3_tpu_torch/parallel/dist.py", "cm3_tpu_torch/parallel/mesh.py",
             "tests/torch_dist_cases.py", "tests/torch_dist_worker.py"]


@pytest.mark.parametrize("rel", RANK_CODE)
def test_the_multiprocess_code_imports_torch_distributed_and_no_jax(rel):
    """The parallel package and what a test's gloo rank runs: no JAX,
    no ``cm3_tpu``, no Triton; ``torch.distributed`` is allowed, and the
    parallel modules build on it."""
    names = list(_imports(os.path.join(ROOT, rel)))
    for name in names:
        assert name.split(".")[0] not in FORBIDDEN + ("triton",), (rel, name)
    if rel.startswith("cm3_tpu_torch/parallel/"):
        assert "torch.distributed" in names, rel
