"""The port's reproduction scripts end to end on the CPU, in a temporary
working directory at narrow widths: ``torch_reproduce_paper.main`` for
``checkers_s1,checkers_s2`` at 2 seeds (stage 2 restores the stage-1
seed ``SCORE`` picks), ``torch_ablation_vmapped`` for ``checkers_qmix``
and ``checkers_s2_lrA`` at 2 seeds (and its cell lock),
``torch_extend_run`` then the ``require_resume`` cell
``checkers_s2_lrA_ext``, ``torch_verify_checkpoints`` over the result
(its ``check`` against JAX's on the same reports), ``RESULTS.md``,
``torch_render_index``; and the Checkers and particle gate probes
against the JAX package's."""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cm3_tpu_torch.core import config as tcfg
from cm3_tpu_torch.train import runner
from tests import torch_parity as tp

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "scripts"))

from scripts import verify_checkpoints as jvc  # noqa: E402
import torch_ablation_vmapped as tav  # noqa: E402
import torch_extend_run as ter  # noqa: E402
import torch_probe_checkers_optimal as tpc  # noqa: E402
import torch_probe_particle as tpp  # noqa: E402
import torch_render_index as tri  # noqa: E402
import torch_reproduce_paper as trp  # noqa: E402
import torch_verify_checkpoints as tvc  # noqa: E402

tp.set_torch_cpu()

EPISODES = 60          # past the 50 fill episodes of master.json
EXT_EPISODES = 110     # the resumed total: warm-up to 110, one period row
SEEDS = (12341, 12342)
CPU = ["--device", "cpu"]


@pytest.fixture(scope="module")
def pipeline(tmp_path_factory):
    """Runs the scripts in order in a fresh directory at narrow widths
    (kept for the module's tests, which restore what the runs saved);
    -> (workdir, the rows, the (cell, overrides) of every ``run_cell``
    call, the verify reports)."""
    wd = tmp_path_factory.mktemp("repro")
    calls = []
    real_run_cell = trp.run_cell
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(runner, "_nn_config",
                   lambda m, e, s: tcfg.NNConfig(**tp.SMALL_NN))
        mp.setattr(trp, "run_cell", lambda name, ov, **kw: (
            calls.append((name, dict(ov))),
            real_run_cell(name, ov, **kw))[1])
        cwd = os.getcwd()
        try:
            os.chdir(wd)
            seeds = ["--seeds", "2"]
            trp.main(["--cells", "checkers_s1,checkers_s2", "--episodes",
                      str(EPISODES)] + seeds + CPU)
            tav.main(["--cells", "checkers_qmix,checkers_s2_lrA",
                      "--episodes", str(EPISODES)] + seeds + CPU)
            for s in SEEDS:
                ter.main(["--cell", "checkers_s2_lrA", "--seed", str(s),
                          "--episodes-done", str(EPISODES)] + CPU)
            trp.main(["--cells", "checkers_s2_lrA_ext", "--episodes",
                      str(EXT_EPISODES)] + seeds + CPU)
            rows = [json.loads(l) for l in open(
                os.path.join(trp.WORKDIR, "results.jsonl"))]
            reports = tvc.verify_rows(rows, n_eval=10, verbose=False,
                                      device="cpu")
            tvc.main(["--check", "--n-eval", "10"] + CPU)
        finally:
            os.chdir(cwd)
        yield wd, rows, calls, reports
    finally:
        mp.undo()


ROW_KEYS = {"cell", "minutes", "episodes", "final_eval_global",
            "best_eval_global", "final_eval_local", "best_min_eval_local",
            "final10_min_eval_local", "best_reach_rate", "final_reach_rate",
            "final10_reach_rate", "seed", "dir_name", "gate", "passed"}


def test_rows_of_every_run(pipeline):
    """One row per run and seed, in order, each with JAX's keys
    (``vmapped`` on the lockstep rows), the episodes reached, a finite
    final evaluation and no gate passed at this budget."""
    wd, rows, calls, _ = pipeline
    cells = [r["cell"] for r in rows]
    assert cells == ["checkers_s1"] * 2 + ["checkers_s2"] * 2 + [
        "checkers_qmix"] * 2 + ["checkers_s2_lrA"] * 2 + [
        "checkers_s2_lrA_ext"] * 2
    for r in rows:
        assert set(r) == ROW_KEYS | ({"vmapped"} if r.get("vmapped")
                                     else set()), r["cell"]
        assert r["seed"] in SEEDS and r["dir_name"].endswith(str(r["seed"]))
        assert r["episodes"] >= (EXT_EPISODES if r["cell"].endswith("_ext")
                                 else EPISODES)
        assert np.isfinite(r["final_eval_global"]) and not r["passed"]
    assert [r["cell"] for r in rows if r.get("vmapped")] == [
        "checkers_qmix"] * 2 + ["checkers_s2_lrA"] * 2
    assert os.path.isfile(wd / trp.WORKDIR / "RESULTS.md")


def test_stage2_restores_the_stage1_seed_score_picks(pipeline, monkeypatch):
    """With no seed through the gate, each stage-2 seed restores the
    stage-1 seed of the best score (the first of equals), as
    ``_find_restore``, which the lockstep cells use, picks it from the
    ledger."""
    wd, rows, calls, _ = pipeline
    s1 = [r for r in rows if r["cell"] == "checkers_s1"]
    best = s1[0]
    for r in s1[1:]:
        if r["best_eval_global"] > best["best_eval_global"]:
            best = r
    s2 = [ov for name, ov in calls if name == "checkers_s2"]
    assert [ov["seed"] for ov in s2] == list(SEEDS)
    assert {ov["dir_restore"] for ov in s2} == {best["dir_name"]}
    monkeypatch.chdir(wd)
    assert trp._find_restore("checkers_s1", "ck_s1") == best["dir_name"]


def test_extend_run_then_require_resume(pipeline, monkeypatch):
    """``torch_extend_run`` wrote each lockstep seed's one-seed autosave
    at the finished count, and ``checkers_s2_lrA_ext`` resumed it: its
    first period row is past that count; a seed without an autosave
    refuses to run."""
    wd, rows, calls, _ = pipeline
    metrics = os.path.join(wd, trp.WORKDIR, "log", "ck_s2lr_12341",
                           "metrics.jsonl")
    eps = [json.loads(l)["episode"] for l in open(metrics)]
    assert eps[-1] >= 100 and eps[0] <= EPISODES < eps[-1]
    ext = [ov for name, ov in calls if name == "checkers_s2_lrA_ext"]
    assert all(ov["require_resume"] and ov["auto_resume"] for ov in ext)
    monkeypatch.chdir(wd)
    with pytest.raises(FileNotFoundError, match="require_resume"):
        trp.run_cell("checkers_s2_lrA_ext", dict(
            trp.cells(EXT_EPISODES)["checkers_s2_lrA_ext"], seed=99,
            dir_name="ck_s2lr_99", dir_restore="ck_s1_12341"),
            n_episodes=EXT_EPISODES, device="cpu")
    with pytest.raises(SystemExit, match="no final checkpoint"):
        ter.main(["--cell", "checkers_s2_lrA", "--seed", "99",
                  "--episodes-done", "5"] + CPU)


def test_cell_lock(pipeline, monkeypatch):
    """The lock is gone after the runs; a held lock refuses a second run
    of the cell; a run that raises still removes its lock."""
    wd, *_ = pipeline
    monkeypatch.chdir(wd)
    lock_dir = os.path.join(trp.WORKDIR, "saved", "ck_qmix_vmapped")
    lock = os.path.join(lock_dir, ".cell_lock")
    assert not os.path.exists(lock)
    base = trp.cells(EPISODES)["checkers_qmix"]
    with open(lock, "w") as f:
        f.write("4242")
    with pytest.raises(SystemExit, match="LOCKED.*4242"):
        tav.run_cell_vmapped("checkers_qmix", base, EPISODES, 2, 12341,
                             device="cpu")
    os.remove(lock)

    def boom(*a, **k):
        assert os.path.exists(lock)
        raise RuntimeError("boom")
    monkeypatch.setattr(runner, "train_multiseed", boom)
    with pytest.raises(RuntimeError, match="boom"):
        tav.run_cell_vmapped("checkers_qmix", base, EPISODES, 2, 12341,
                             device="cpu")
    assert not os.path.exists(lock)


def test_verify_checkpoints(pipeline):
    """Every row's ``model_final`` restores and evaluates within its
    band; no failure; the report file written by ``main``."""
    wd, rows, _, reports = pipeline
    assert {(r["dir_name"], r["model"]) for r in reports} >= {
        (r["dir_name"], "model_final") for r in rows}
    assert all(r["restored"] and r["finite"] for r in reports)
    assert tvc.check(reports) == []
    out = json.load(open(wd / trp.WORKDIR / "checkpoint_verify.json"))
    assert out["n_eval"] == 10 and len(out["reports"]) == len(reports)


def _reports():
    base = dict(restored=True, finite=True, seed=1, dir_name="d",
                eval_local=[4.0, 4.0], min_eval_local=4.0, eval_global=8.0)
    return [
        dict(base, cell="checkers_s2", model="model_final",
             recorded_final=1.0),
        dict(base, cell="checkers_s2", model="model_final",
             recorded_final=-1.0),
        dict(base, cell="roadway_s1", model="model_final",
             recorded_final=-4.5),
        dict(base, cell="particle_s1", model="model_final",
             recorded_final=None),
        dict(base, cell="checkers_s1", model="model_good_77"),
        dict(base, cell="checkers_s1", model="model_good_78",
             eval_local=[6.9]),
        dict(base, cell="roadway_s1", model="model_good_9",
             min_eval_local=7.4),
        dict(base, cell="checkers_s1", model="model_final", finite=False),
        dict(base, cell="checkers_s1", model="model_final", restored=False,
             error="ValueError: x"),
    ]


def test_check_equals_jax():
    """``check``'s failures on reports that cross each band equal JAX's
    ``verify_checkpoints.check``'s."""
    got = tvc.check(_reports())
    assert got == jvc.check(_reports())
    assert len(got) == 6


def test_render_index(pipeline, tmp_path):
    """Two greedy episodes of a ``model_final`` rendered through the
    runner, then ``build_index``: one page that embeds both SVGs."""
    wd, rows, *_ = pipeline
    m = tcfg.load_json("master.json")
    m.update(trp.cells(EPISODES)["checkers_s1"], seed=12341,
             dir_name="ck_s1_12341")
    paths = runner.render_episodes(m, None, str(wd / trp.WORKDIR),
                                   n_episodes=2, restore=True, device="cpu")
    root = os.path.join(wd, trp.WORKDIR, "render")
    out = tri.build_index(root)
    assert out == os.path.join(root, "index.html")
    page = open(out).read()
    for p in paths:
        assert f"data='{os.path.relpath(p, root)}'" in page
    assert tri.build_index(str(tmp_path)) is None


def _jax_probe(name, **swap):
    """The JAX package's probe ``scripts/<name>.py`` read in place: its
    definitions alone (``upto`` cuts the source before that line), or
    all of it with ``swap`` replacing constants."""
    src = open(os.path.join(ROOT, "scripts", name + ".py")).read()
    upto = swap.pop("upto", None)
    if upto is not None:
        src = src[:src.index(upto)]
    for old, new in swap.items():
        assert old in src
        src = src.replace(old, new)
    ns = {"__file__": os.path.join(ROOT, "scripts", name + ".py")}
    exec(compile(src, name, "exec"), ns)
    return ns


def test_checkers_probe_equals_jax(capsys):
    """At a beam of 16 the port's beam search ends on JAX's probe's
    returns; the full-board sweep scores exactly +6.0 on both engines."""
    ns = _jax_probe("_probe_checkers_optimal",
                    **{"BEAM = 4096": "BEAM = 16"})
    rets = tpc.beam_search(16, device="cpu")
    np.testing.assert_array_equal(rets, ns["rets"])
    assert capsys.readouterr().out.splitlines()[0].endswith(
        str(float(rets.max())))
    state, step = ns["state"], jax.jit(ns["env"].step)
    ret = 0.0
    for a in tpc.SWEEP:
        state, ts = step(state, jnp.asarray([a], jnp.int32))
        ret += float(ts.reward)
        if bool(ts.done):
            break
    assert tpc.sweep_return(device="cpu") == ret == 6.0


def test_particle_probe_equals_jax_op_by_op():
    """The scripted greedy on 16 of JAX's probe's episodes, its reset
    draws fed: returns, reach and steps equal JAX's probe's rollout run
    op by op (``jax.disable_jit``), episode for episode.  (JAX's
    compiled rollout, which the probe runs, rounds otherwise and
    reaches the goal in more of them.)"""
    ns = _jax_probe("_probe_particle", upto="keys = jax.random.split")
    keys = jax.random.split(jax.random.PRNGKey(0), 512)[:16]
    with jax.disable_jit():
        want = [np.asarray(x) for x in jax.vmap(ns["rollout"])(keys)]
    draw = lambda kb, ka, kl, kn: (
        jax.random.uniform(kb),
        jax.random.uniform(ka, (1, 2), minval=-1.0, maxval=1.0),
        jax.random.uniform(kl, (1, 2), minval=-1.0, maxval=1.0),
        jax.random.normal(kn, (1, 2)))
    b, a, l, z = (torch.tensor(np.asarray(x)) for x in jax.vmap(
        lambda k: draw(*jax.random.split(k, 4)))(keys))
    env = tpp.make_env("cpu")
    got = tpp.rollout(env, dict(branch=b, agents=a, landmarks=l, noise=z),
                      tpp.greedy_policy)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
    assert 0 < want[1].sum() < 16
