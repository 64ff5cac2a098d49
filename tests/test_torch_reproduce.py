"""The port's reproduction tooling against the JAX package's scripts:
the cell table, the run order, the dependencies and ``ALL_SEEDS``
(``scripts/torch_reproduce_paper.py`` against
``scripts/reproduce_paper.py``), the gates' and scores' verdicts and the
ordering rows on every committed row of ``runs/reproduce/results.jsonl``
(read in place), the stage-2 restore choice over a copy of those rows,
``run_cell``'s and ``_per_seed_stats``' rows from the same fed history
(numpy and CPU-tensor leaves), and ``RESULTS.md`` byte for byte."""

import json
import os
import shutil
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "scripts"))

from scripts import ablation_vmapped as jav  # noqa: E402
from scripts import reproduce_paper as jrp  # noqa: E402
from scripts import summarize_reproduce as jsum  # noqa: E402
import torch_ablation_vmapped as tav  # noqa: E402
import torch_reproduce_paper as trp  # noqa: E402
import torch_summarize_reproduce as tsum  # noqa: E402

RESULTS = os.path.join(ROOT, "runs", "reproduce", "results.jsonl")
SAVED = os.path.join(ROOT, "runs", "reproduce", "saved")


@pytest.fixture(scope="module")
def rows():
    return [json.loads(l) for l in open(RESULTS)]


@pytest.mark.parametrize("episodes", [50000, 16000, 1000, 7, 1])
def test_cells_equal_jax(episodes):
    """Every cell's overrides, the period rule max(e // 500, 1) among
    them, at budgets above, at and below 500 episodes."""
    got, want = trp.cells(episodes), jrp.cells(episodes)
    assert list(got) == list(want)
    assert got == want
    assert got["checkers_s1"]["period"] == max(episodes // 500, 1)


def test_tables_equal_jax():
    """The run order, the stage-2 dependencies, the every-seed cells,
    the gate descriptions, the scored cells and the ordering table."""
    assert trp.ORDER == jrp.ORDER
    assert trp.DEPS == jrp.DEPS
    assert trp.ALL_SEEDS == jrp.ALL_SEEDS
    assert list(trp.GATES) == list(jrp.GATES)
    assert {k: d for k, (d, _) in trp.GATES.items()} == {
        k: d for k, (d, _) in jrp.GATES.items()}
    assert list(trp.SCORE) == list(jrp.SCORE)
    assert trp.ORDERING == jrp.ORDERING
    assert trp.WORKDIR == "runs/reproduce_torch" != jrp.WORKDIR


def _score(mod, cell):
    return mod.SCORE.get(cell, lambda r: r["best_eval_global"] or -99)


def test_gate_and_score_verdicts_on_jax_rows(rows):
    """Each of the 124 committed rows gets JAX's gate verdict and score
    from the port's tables (and the rows do not all agree, so the
    check has teeth)."""
    assert len(rows) == 124
    verdicts = set()
    for r in rows:
        got = trp.GATES[r["cell"]][1](dict(r))
        assert got == jrp.GATES[r["cell"]][1](dict(r)), r["dir_name"]
        verdicts.add(bool(got))
        assert _score(trp, r["cell"])(r) == _score(jrp, r["cell"])(r)
    assert verdicts == {True, False}


def test_ordering_rows_equal_jax(rows):
    """The ordering rows over the committed rows, re-gated as the
    summarizers load them: cells, best, mean, seeds and verdict."""
    by_cell = {}
    for r in rows:
        by_cell.setdefault(r["cell"], []).append(r)
    got, want = trp.ordering_rows(by_cell), jrp.ordering_rows(by_cell)
    assert got == want
    assert {p for *_, p in got} == {True, False}


def _workdirs(tmp_path, rows, with_saved=True):
    """Copies of the committed rows under both packages' WORKDIRs in
    ``tmp_path``, with an empty directory for each saved directory that
    the JAX package has."""
    for wd in (jrp.WORKDIR, trp.WORKDIR):
        d = tmp_path / wd
        d.mkdir(parents=True)
        shutil.copy(RESULTS, d / "results.jsonl")
        if with_saved:
            for r in rows:
                if os.path.isdir(os.path.join(SAVED, r["dir_name"])):
                    (d / "saved" / r["dir_name"]).mkdir(parents=True,
                                                        exist_ok=True)


@pytest.mark.parametrize("rows_file", [True, False],
                         ids=["results", "saved_only"])
def test_find_restore_picks_jax_choice(tmp_path, monkeypatch, rows,
                                       rows_file):
    """For every cell, the restore JAX's ``_find_restore`` picks over
    the copied rows (the best-scoring gate-passing seed with a saved
    directory, else the best-scoring one, else the first saved
    directory with the prefix), and with no results.jsonl the prefix
    fallback alone; None where nothing matches."""
    _workdirs(tmp_path, rows)
    if not rows_file:
        for wd in (jrp.WORKDIR, trp.WORKDIR):
            os.remove(tmp_path / wd / "results.jsonl")
    monkeypatch.chdir(tmp_path)
    todo = jrp.cells(50000)
    picks = {}
    for cell in jrp.ORDER:
        prefix = todo[cell]["dir_name"]
        picks[cell] = trp._find_restore(cell, prefix)
        assert picks[cell] == jrp._find_restore(cell, prefix), cell
    assert trp._find_restore("checkers_s1", "no_such_dir") == (
        jrp._find_restore("checkers_s1", "no_such_dir"))
    if rows_file:
        assert picks["checkers_s1"] in ("ck_s1_12343", "ck_s1_12344")
    assert None in picks.values() or not rows_file


def _history(n_periods, n_agents, reach, rng):
    hist = []
    for p in range(n_periods):
        loc = rng.normal(size=n_agents).astype(np.float32) * 3
        row = {"episode": 100 * (p + 1), "r_eval_local": loc,
               "r_eval_global": float(loc.sum())}
        if reach:
            row["eval_reach_rate"] = float(rng.random())
        hist.append(row)
    return hist


def _tensors(history):
    return [{k: torch.as_tensor(v) for k, v in r.items()} for r in history]


@pytest.mark.parametrize("case", ["numpy", "tensor", "reach", "empty"])
def test_run_cell_row_equals_jax(monkeypatch, case):
    """``run_cell``'s row from a fed ``train_function`` result (13
    periods: the last-10 means cover part of the run) equals JAX's, with
    the port's history as numpy values or as CPU tensors."""
    rng = np.random.default_rng(7)
    hist = ([] if case == "empty" else
            _history(13, 2, case == "reach", rng))
    fed = {}
    for mod, h in ((jrp, hist), (trp, _tensors(hist) if case == "tensor"
                                 else hist)):
        def fake(m, workdir, n_episodes, verbose, device=None, h=h,
                 mod=mod):
            fed[mod] = (m, workdir, n_episodes, verbose, device)
            return None, {"episodes": 1300, "history": h}
        monkeypatch.setattr(mod.runner, "train_function", fake)
    ov = dict(jrp.cells(1300)["checkers_s2"], seed=5, dir_name="ck_s2_5")
    got = trp.run_cell("checkers_s2", ov, n_episodes=1300, device="cpu")
    want = jrp.run_cell("checkers_s2", ov, n_episodes=1300)
    assert got == want
    json.dumps(got)
    m, workdir, n, verbose, device = fed[trp]
    assert (workdir, n, verbose, device) == (trp.WORKDIR, 1300, False,
                                              "cpu")
    assert m == fed[jrp][0]


@pytest.mark.parametrize("case", ["numpy", "tensor", "reach"])
def test_per_seed_stats_equal_jax(case):
    """One row per seed from a lockstep history ([S] and [S, N] leaves),
    as JAX's ``_per_seed_stats`` makes them, from numpy or CPU-tensor
    leaves."""
    rng = np.random.default_rng(11)
    s, n = 3, 2
    hist = []
    for p in range(12):
        loc = (rng.normal(size=(s, n)) * 3).astype(np.float32)
        row = {"episode": np.array([64 * (p + 1) + i for i in range(s)]),
               "r_eval_local": loc, "r_eval_global": loc.sum(-1)}
        if case == "reach":
            row["eval_reach_rate"] = rng.random(s).astype(np.float32)
        hist.append(row)
    args = ("checkers_qmix", s, 12341, 0.5, "ck_qmix")
    want = jav._per_seed_stats(args[0], hist, *args[1:])
    got = tav._per_seed_stats(
        args[0], _tensors(hist) if case == "tensor" else hist, *args[1:])
    assert got == want
    assert [r["dir_name"] for r in got] == ["ck_qmix_12341", "ck_qmix_12342",
                                            "ck_qmix_12343"]
    json.dumps(got)


@pytest.mark.parametrize("n_rows", [124, 40])
def test_results_md_bytes_equal_jax(tmp_path, rows, n_rows):
    """``write_results`` over a copy of the committed rows (all, and the
    first 40: cells missing, ordering rows incomplete) writes the bytes
    JAX's writes, and ``load_rows`` re-gates alike."""
    dirs = []
    for name in ("jax", "torch"):
        d = tmp_path / name
        d.mkdir()
        with open(d / "results.jsonl", "w") as f:
            for r in rows[:n_rows]:
                f.write(json.dumps(r) + "\n")
        dirs.append(str(d))
    jsum.write_results(dirs[0])
    tsum.write_results(dirs[1])
    got = open(os.path.join(dirs[1], "RESULTS.md"), "rb").read()
    assert got == open(os.path.join(dirs[0], "RESULTS.md"), "rb").read()
    assert tsum.load_rows(dirs[1]) == jsum.load_rows(dirs[0])
    assert got.count(b"\n| ") > 10
