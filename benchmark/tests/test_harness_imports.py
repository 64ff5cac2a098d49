"""No module of the benchmark imports JAX or the JAX package, and the
reference imports nothing of the port: top-level module names compared
whole (``cm3_tpu_torch`` begins with ``cm3_tpu``)."""

import ast
import os
import subprocess
import sys

import pytest

from benchmark import harness

FORBIDDEN = {"jax", "jaxlib", "flax", "cm3_tpu"}
HARNESS_NEVER = {"bench", "chip_smoke", "scripts", "tests"}


def _sources(top):
    for d, _, files in os.walk(top):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def _imported(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


SOURCES = sorted(_sources(harness.HERE))


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: os.path.relpath(p, harness.HERE))
def test_no_jax(path):
    names = set(_imported(path))
    assert not names & FORBIDDEN
    if "/tests/" not in path:
        assert not names & HARNESS_NEVER


@pytest.mark.parametrize(
    "path", [p for p in SOURCES if "/reference/" in p],
    ids=lambda p: os.path.relpath(p, harness.HERE))
def test_reference_imports_no_port(path):
    assert "cm3_tpu_torch" not in set(_imported(path))


def test_forbidden_modules_compares_whole_names():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import cm3_tpu_torch.train.multiseed\n"
            "from benchmark import harness\n"
            "from benchmark.drivers import train_sweep, rollout\n"
            "print(harness.forbidden_modules())" % harness.ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, cwd=harness.ROOT)
    assert out.stdout.strip() == "[]"
