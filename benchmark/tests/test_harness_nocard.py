"""Without a card the run fails and prints no result; without the
program beside it, too."""

import os
import shutil
import subprocess
import sys

import pytest
import torch

from benchmark import harness


def _run(cwd, *extra):
    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "checkers_cm3_s2.rollout", "--seed", str(2 ** 31 + 1), "--seconds",
         "1", "--trace", "0", *extra], cwd=cwd, capture_output=True,
        text=True, timeout=300)


def test_no_card_fails_without_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = _run(harness.ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_benchmark_alone_fails(tmp_path):
    shutil.copy(os.path.join(harness.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(harness.HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(str(tmp_path))
    assert out.returncode != 0
    assert out.stdout.strip() == ""
