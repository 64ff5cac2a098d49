"""The port's ``parallel/`` package: the helpers on one process (as
``tests/test_parallel.py:83-104`` holds JAX's on a mesh), and seeds in
lockstep over a seed mesh of two gloo ranks on the CPU
(``multiseed.train_vmapped_seeds(mesh=)``): stage-1 Checkers off-policy
and particle CM3 on-policy with 4 seeds, 2 a rank, give every seed's
state and every period row of the single-process 4-seed run, with no
gradient collective."""

import numpy as np
import pytest
import torch

from cm3_tpu_torch.core import prng
from cm3_tpu_torch.parallel import dist
from cm3_tpu_torch.parallel import mesh as meshlib
from cm3_tpu_torch.train import multiseed
from cm3_tpu_torch.train.offpolicy import init_rollout
from tests import torch_dist_cases as dc

torch.set_num_threads(1)

S = 4


# ------------------------------------------------------------------ #
# one process
# ------------------------------------------------------------------ #


def test_initialize_is_a_no_op_for_one_process(monkeypatch):
    for k in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    dist.initialize(device="cpu")
    dist.initialize(num_processes=1, device="cpu")
    assert not torch.distributed.is_initialized()
    assert dist.device() == torch.device("cpu")
    assert dist.is_primary() and dist.process_index() == 0
    assert dist.global_device_count() == dist.local_device_count() == 1


def test_host_key_folds_the_process_index():
    root = prng.root_key(3)
    assert dist.host_key(3) == prng.for_host(root, 0) == prng.fold_in(root,
                                                                       0)
    assert len({prng.for_host(root, i) for i in range(4)} | {root}) == 5


def test_make_mesh():
    m = meshlib.make_mesh()
    assert m.shape == {"data": 1} and (m.size, m.rank) == (1, 0)
    assert meshlib.make_mesh(1, axis="seed").shape == {"seed": 1}
    with pytest.raises(RuntimeError, match="need 2 devices, have 1"):
        meshlib.make_mesh(2)


def test_shard_leading_axis():
    """Rank 1 of 2 keeps rows 4-7 of a leaf that leads with 8, and the
    other leaves whole."""
    m = meshlib.Mesh("data", 2, 1)
    x = torch.arange(24.0).reshape(8, 3)
    t = meshlib.shard_leading_axis({"a": x, "b": torch.zeros(5)}, m, 8)
    assert torch.equal(t["a"], x[4:]) and t["b"].shape == (5,)
    with pytest.raises(ValueError, match="does not split"):
        meshlib.shard_leading_axis({"a": torch.zeros(3, 2)}, m, 3)


def test_placements_name_the_mesh_axis():
    """A leaf splits over the mesh's own axis; another axis name raises,
    as JAX's ``PartitionSpec`` of an axis the mesh lacks does."""
    from torch.distributed.tensor import Shard
    seed = meshlib.Mesh("seed", 2, 1)
    assert isinstance(meshlib.data_sharding(seed, "seed"), Shard)
    t = multiseed.shard_seed_axis({"a": torch.arange(4.0)}, seed, 4)
    assert torch.equal(t["a"], torch.tensor([2.0, 3.0]))
    for fn in (lambda: meshlib.data_sharding(seed),
               lambda: meshlib.shard_leading_axis({"a": torch.zeros(4)},
                                                  seed, 4),
               lambda: multiseed.shard_seed_axis(
                   {"a": torch.zeros(4)}, meshlib.Mesh("data", 2, 0), 4)):
        with pytest.raises(ValueError, match="has no axis"):
            fn()


@pytest.mark.parametrize("shards", [2, 1])
def test_driver_state_shardings(shards):
    """The learner replicated; the instances split and the run's running
    values replicated (whatever their leading dim: an episode log of 16
    rows at 16 envs); the replay split in shards, else replicated."""
    from torch.distributed.tensor import Replicate, Shard
    hooks, alg, driver = dc.program("checkers", train_kw=dict(
        replay_shards=shards, episode_log=16))
    rs = init_rollout(hooks, 16, None, 16)
    buf, rs = driver.init_replay(rs)
    ts = alg.init_state(prng.root_key(0))
    m = meshlib.Mesh("data", 2, 0)
    ts_p, buf_p, rs_p = meshlib.driver_state_shardings(m, (ts, buf, rs), 16,
                                                       shards)
    assert set(ts_p) >= {"actor", "opt_actor", "step"}
    assert all(isinstance(p, Replicate) for p in ts_p.values())
    assert isinstance(rs_p.a_prev, Shard) and isinstance(rs_p.goals, Shard)
    assert all(isinstance(p, Shard) for p in rs_p.obs.values())
    for name in ("episodes", "acc_ret_global", "eplog", "eplog_ep"):
        assert isinstance(getattr(rs_p, name), Replicate), name
    kind = Shard if shards > 1 else Replicate
    assert isinstance(buf_p.data["a"], kind)
    assert isinstance(buf_p.size, kind)
    ts1, buf1, rs1 = meshlib.shard_driver_state(m, ts, buf, rs, 16, shards)
    assert rs1.mesh is m and rs1.a_prev.shape[0] == 8
    assert rs1.eplog.shape == rs.eplog.shape
    assert np.shape(buf1.size) == ((1,) if shards > 1 else ())


def test_block_draws_split_the_global_draw():
    """Rank r of W gets block r of every draw the single-process source
    would make, along dim 0; ``randint_below`` reduces the
    global 62-bit draw by the rank's own bounds."""
    def src():
        return prng.GeneratorDraws(prng.generator(prng.root_key(5), "cpu"))

    g = src()
    full = [g.randint((6, 4), 5), g.gumbel((6, 2, 3)),
            g.uniform((6, 3), -1.0, 1.0), g.normal((6,)),
            g.randint((6, 4), 1 << 62)]
    for r in range(3):
        b = prng.BlockDraws(src(), r, 3)
        got = [b.randint((2, 4), 5), b.gumbel((2, 2, 3)),
               b.uniform((2, 3), -1.0, 1.0), b.normal((2,))]
        for x, y in zip(got, full):
            assert torch.equal(x, y[2 * r:2 * r + 2])
        high = torch.tensor([3, 7])
        assert torch.equal(b.randint_below((2, 4), high),
                           full[4][2 * r:2 * r + 2] % high[:, None])


@pytest.mark.parametrize("shards", [2, 1])
def test_a_mesh_of_one_process_trains_as_one_device(shards):
    """``shard_driver_state`` on a mesh of this process alone: a fill
    and a training chunk give the bytes of the run without a mesh."""
    out = []
    for mesh in (None, meshlib.make_mesh(1)):
        hooks, alg, driver = dc.program("checkers", train_kw=dict(
            replay_shards=shards))
        ts = alg.init_state(prng.root_key(2))
        draws = prng.GeneratorDraws(prng.generator(prng.root_key(4), "cpu"))
        rs = init_rollout(hooks, 16, draws, 16)
        buf, rs = driver.init_replay(rs)
        if mesh is not None:
            ts, buf, rs = meshlib.shard_driver_state(mesh, ts, buf, rs, 16,
                                                     shards)
        for train in (False, True):
            ts, buf, rs, m = driver._chunk(ts, buf, rs, 0.3, draws, train,
                                           not train)
        out.append((dc.state_arrays(alg, ts), dc.host(rs), dc.host(m)))
    dc.equal_on_ranks(out)


@pytest.mark.parametrize("ends", ["returns", "raises"])
def test_run_unbinds_its_mesh(ends):
    """``run(..., mesh=)`` trains on the mesh and leaves the algorithm on
    none when it returns or raises: a later update of the algorithm
    alone issues no collective."""
    hooks, alg, driver = dc.program("checkers", train_kw=dict(
        pretrain_episodes=16, period=16))
    seen = []

    def log_fn(row):
        seen.append(driver.mesh)
        if ends == "raises":
            raise KeyboardInterrupt

    mesh = meshlib.make_mesh(1)
    try:
        driver.run(alg.init_state(prng.root_key(2)), key=1, n_episodes=16,
                   log_fn=log_fn, mesh=mesh)
    except KeyboardInterrupt:
        assert ends == "raises"
    assert seen == [mesh]
    assert driver.mesh is None and alg.data_mesh is None


def test_seeds_resume_on_a_one_seed_algorithm():
    """``train_vmapped_seeds`` given a one-seed algorithm and a state
    made by another instance (the stack's module templates built outside
    the seed map) trains as the seed-stacked algorithm that made it."""
    out = []
    for one_seed in (False, True):
        hooks, alg, driver = dc.program("checkers", alg_kw=dict(
            n_agents=1), train_kw=SEED_CASES["stage1"][1]["train"])
        stack = alg.for_seeds(2)
        ts = stack.init_state([prng.root_key(7 + i) for i in range(2)])
        ts, rows = multiseed.train_vmapped_seeds(
            hooks, alg if one_seed else stack, driver.cfg, 2, 7,
            n_episodes=16, resume=(ts, np.zeros(2, np.int64)))
        assert len(rows) == 2
        out.append(dc.state_arrays(stack, ts))
    dc.equal_on_ranks(out)


# ------------------------------------------------------------------ #
# seeds over two ranks
# ------------------------------------------------------------------ #

SEED_CASES = {
    "stage1": ("seeds", dict(kind="checkers", n_seeds=S, alg=dict(
        n_agents=1), train=dict(n_envs=4, buffer_size=64, batch_size=8,
                                steps_per_train=5, updates_per_chunk=2,
                                pretrain_episodes=4, period=8, N_train=24,
                                N_eval=3, max_steps=5, episode_log=8)),
        "seed"),
    "particle": ("seeds", dict(kind="particle", n_seeds=S, train=dict(
        n_envs=4, buffer_size=64, batch_size=16, steps_per_train=5,
        epochs=2, episodes_per_train=4, pretrain_episodes=4, period=8,
        N_train=16, N_eval=2, episode_log=8)), "seed"),
}


@pytest.fixture(scope="module")
def seed_runs(tmp_path_factory):
    launched = dc.launch(SEED_CASES, str(tmp_path_factory.mktemp("seeds")))
    single = {name: dc.CASES[case](args, None)
              for name, (case, args, _) in SEED_CASES.items()}
    return dc.collect(launched), single


@pytest.mark.parametrize("name", sorted(SEED_CASES))
def test_seed_mesh_rows_equal_the_single_process_run(seed_runs, name):
    """Every period row (all 4 seeds, gathered to both ranks) is the
    same on both ranks and equals the single-process 4-seed run's:
    episode counts, epsilons and episode logs exactly, returns and
    metrics at rtol 1e-5 / atol 1e-6 (seed stacks of 2 sum a grouped
    convolution in another order than stacks of 4)."""
    ranks, single = seed_runs[0][name], seed_runs[1][name]
    dc.equal_on_ranks([r["rows"] for r in ranks], "rows")
    assert len(single["rows"]) >= 2
    dc.close(ranks[0]["rows"], single["rows"], f"{name} rows ")
    assert ranks[0]["rows"][-1]["episode"].shape == (S,)


@pytest.mark.parametrize("name", sorted(SEED_CASES))
def test_seed_mesh_states_equal_the_single_process_run(seed_runs, name):
    """Rank r's two seeds equal seeds 2r and 2r + 1 of the single-process
    run: every network, target and Adam moment; no gradient all-reduce,
    only the gathers of the schedule and the rows."""
    ranks, single = seed_runs[0][name], seed_runs[1][name]
    for r, res in enumerate(ranks):
        want = {k: (v[2 * r:2 * r + 2] if np.ndim(v) else v)
                for k, v in single["ts"].items()}
        dc.close(res["ts"], want, f"{name} rank {r} ")
        assert "grad" not in res["counts"] and "all_reduce" not in \
            res["counts"]
        assert res["counts"]["all_gather"] > 0
    assert single["counts"] == {}


def test_torchrun_trains_two_cpu_ranks():
    """``scripts/torch_data_parallel.py`` under ``torchrun`` with two
    processes on the CPU: ``dist.initialize`` reads torchrun's
    environment (gloo), the run trains data-parallel, and only the
    primary prints its period rows and its evaluation."""
    import json
    import os
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node",
         "2", "--master-port", str(dc._free_port()),
         os.path.join(root, "scripts", "torch_data_parallel.py"),
         "--device", "cpu", "--episodes", "48", "--period", "24"],
        cwd=root, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = [json.loads(ln) for ln in proc.stdout.splitlines()
             if ln.startswith("{")]
    rows, last = lines[:-1], lines[-1]
    assert [r["episode"] >= 24 * (i + 1) for i, r in enumerate(rows)] == \
        [True, True]
    assert last["ranks"] == 2 and last["episodes"] >= 48
    assert last["updates"] > 0 and np.isfinite(last["r_eval_global"])


def test_seed_mesh_resume_cuts_the_stacked_state():
    """``resume`` on a seed mesh takes the whole run's seed-stacked state
    and counts and trains this rank's seeds (here all of them, on one
    process): the rows and the state of the resume without a mesh."""
    hooks, alg, _ = dc.program("checkers", dict(n_agents=1))
    cfg = dc.tcfg.TrainConfig(n_envs=4, buffer_size=64, batch_size=8,
                              steps_per_train=5, updates_per_chunk=2,
                              pretrain_episodes=4, period=8, N_train=24,
                              N_eval=3, max_steps=5, episode_log=8)
    ts, _ = multiseed.train_vmapped_seeds(hooks, alg, cfg, 2, 3,
                                          n_episodes=8)
    stacked, one = alg.for_seeds(2), alg.for_seeds(None)
    out = []
    for mesh in (None, meshlib.make_mesh(1, axis="seed")):
        start = dc.checkpoint.stack_states(stacked, [
            dc.checkpoint.seed_state(one, ts, i) for i in range(2)])
        got, rows = multiseed.train_vmapped_seeds(
            hooks, stacked, cfg, 2, 3, resume=(start, np.array([8, 9])),
            mesh=mesh)
        out.append((dc.state_arrays(stacked, got),
                    [{k: v for k, v in r.items() if k != "duration_s"}
                     for r in rows]))
    assert out[0][1][0]["episode"].min() >= 16
    dc.equal_on_ranks([dc.host(o) for o in out], "resume")
