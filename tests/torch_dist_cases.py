"""The port's programs that the multi-process tests run, on one process
(``mesh`` None) or as a rank of a gloo group (``torch_dist_worker.py``),
and the helpers that spawn the ranks and put their blocks together.

Imports ``torch`` and the port only, so that a rank starts in a few
seconds; the tests compute JAX's side in their own process and hand the
ranks its draws and start states through files.  Every case returns a
dict of host arrays (numpy) that the test compares."""

import dataclasses
import os
import pickle
import socket
import subprocess
import sys

import numpy as np
import torch

from cm3_tpu_torch.algs.cm3 import CM3
from cm3_tpu_torch.core import config as tcfg
from cm3_tpu_torch.core import prng
from cm3_tpu_torch.core.tree import tree_map
from cm3_tpu_torch.parallel import mesh as meshlib
from cm3_tpu_torch.train import checkpoint, multiseed
from cm3_tpu_torch.train.experiments import make_hooks
from cm3_tpu_torch.train.offpolicy import (OffPolicyDriver, RolloutState,
                                           init_rollout)
from cm3_tpu_torch.train.onpolicy import OnPolicyDriver

HERE = os.path.dirname(os.path.abspath(__file__))
WORKER = os.path.join(HERE, "torch_dist_worker.py")

# tests/multihost_worker.py's program: Checkers stage 2 on 4 columns,
# 16 envs, episodes of 20 steps, CM3 with nets 32/16, B 32, buffer 256
WORKER_NN = dict(Q_n_h1_1=32, Q_n_h1_2=16, Q_n_h2=32, A_n_h1=32, A_n_h2=32)
WORKER_TRAIN = dict(n_envs=16, batch_size=32, buffer_size=256,
                    steps_per_train=5, updates_per_chunk=2, max_steps=20,
                    pretrain_episodes=16, epsilon_div=100.0)
# torch_parity's narrow particle and roadway nets, and its short road
SMALL_PARTICLE_NN = dict(Q_units=16, V_n_others=8, V_n_h2=12,
                         Actor_n_others=8, Actor_n_h2=12)
SMALL_ROADWAY_NN = dict(Q_units=16, V_n_others=8, V_n_h2=12)
SHORT_ROAD = dict(init_position=(150.0, 150.0), speed=(50.0, 50.0))


def checkers_env_config(n_agents=2, max_steps=20):
    """The worker's Checkers (4 columns); for stage 1, one agent on the
    default board (torch_parity's)."""
    if n_agents == 1:
        return tcfg.CheckersEnvConfig(agents_r=(0,), agents_c=(8,),
                                      n_agents=1, max_steps=max_steps)
    return tcfg.CheckersEnvConfig(n_columns=4, agents_r=(0, 2),
                                  agents_c=(4, 4), n_agents=2,
                                  max_steps=max_steps)


def program(kind, alg_kw=(), train_kw=(), n_seeds=None, device="cpu"):
    """(hooks, algorithm, driver) of ``kind``: "checkers" (the worker's
    stage 2, or stage 1 with ``n_agents`` 1 in ``alg_kw``), "roadway"
    (CM3 on the short road's two cars, off-policy) or "particle" (CM3 on
    ``stage2_antipodal``, on-policy)."""
    alg_kw, train_kw = dict(alg_kw), dict(train_kw)
    if kind == "checkers":
        from cm3_tpu_torch.envs.checkers import Checkers
        n = alg_kw.pop("n_agents", 2)
        env = Checkers(checkers_env_config(n, train_kw.get(
            "max_steps", WORKER_TRAIN["max_steps"])), device=device)
        hooks, nn, driver_cls = (make_hooks("checkers", env), WORKER_NN,
                                 OffPolicyDriver)
        train = dict(WORKER_TRAIN, **train_kw)
    elif kind == "roadway":
        from cm3_tpu_torch.envs.roadway import Roadway
        env = Roadway(dataclasses.replace(tcfg.roadway_env_config(2, 0.5),
                                          **SHORT_ROAD), device=device)
        n = 2
        hooks = make_hooks("roadway", env,
                           threshold=train_kw.get("threshold", 16.0))
        nn, driver_cls, train = SMALL_ROADWAY_NN, OffPolicyDriver, train_kw
    else:
        from cm3_tpu_torch.envs.particle import Particle
        env = Particle(tcfg.particle_env_config(
            "stage2_antipodal", prob_random=0.5, max_steps=7), device=device)
        n = 4
        hooks, nn, driver_cls, train = (make_hooks("particle", env),
                                        SMALL_PARTICLE_NN, OnPolicyDriver,
                                        train_kw)
    alg = CM3(kind, env.spec(), tcfg.AlgConfig(
        n_agents=n, stage=2 if n > 1 else 1, **alg_kw),
        tcfg.NNConfig(**nn), device=device, n_seeds=n_seeds)
    return hooks, alg, driver_cls(hooks, alg, tcfg.TrainConfig(**train))


def host(tree):
    """Tensors -> numpy, recursively (a rollout state without its mesh)."""
    if isinstance(tree, RolloutState):
        tree = {f.name: getattr(tree, f.name)
                for f in dataclasses.fields(tree) if f.name != "mesh"}
    elif dataclasses.is_dataclass(tree):
        tree = {f.name: getattr(tree, f.name)
                for f in dataclasses.fields(tree)}
    if isinstance(tree, dict):
        return {k: host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(host(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy().copy()
    return tree


def state_arrays(alg, ts):
    """Every network, target and Adam moment of ``ts`` as host arrays."""
    out = {"step": int(ts.step)}
    for name in alg.net_names():
        out[name] = getattr(ts, name).flat.detach().cpu().numpy()
        out[name + "_tgt"] = getattr(ts, name + "_tgt").flat.cpu().numpy()
        opt = getattr(ts, "opt_" + name)
        out[name + ".mu"] = opt.mu.cpu().numpy()
        out[name + ".nu"] = opt.nu.cpu().numpy()
        out[name + ".count"] = int(opt.count)
    return out


def _fed(lists, device):
    randints, gumbels, uniforms, normals = lists
    return prng.FedDraws(randints, gumbels, device=device,
                         uniforms=uniforms or None, normals=normals or None)


def chunks(args, mesh):
    """A program's chunks from a saved start state with fed draws (the
    whole run's), or from seeded parameters with the port's own draw
    stream: ``args["steps"]`` lists ("chunk", train, random) or
    ("rollout", random) and ("burst",); after each step this rank's
    rollout state and replay, after training ones its state and metrics,
    and the collectives issued."""
    dev = args.get("device", "cpu")
    hooks, alg, driver = program(args["kind"], args.get("alg", ()),
                                 args.get("train", ()), device=dev)
    cfg = driver.cfg
    if "draws" in args:
        draws = _fed(args["draws"], dev)
        ts = checkpoint.restore(args["start"], alg.empty_state())
    else:   # the port's own streams
        draws = prng.GeneratorDraws(prng.generator(prng.root_key(5), dev))
        ts = alg.init_state(prng.root_key(1))
    rs = init_rollout(hooks, cfg.n_envs, draws, cfg.episode_log)
    buf, rs = driver.init_replay(rs)
    if mesh is not None:
        ts, buf, rs = meshlib.shard_driver_state(mesh, ts, buf, rs,
                                                 cfg.n_envs,
                                                 cfg.replay_shards)
    eps = args.get("eps", 0.2)
    meshlib.COUNTS.clear()
    out = []
    for step in args["steps"]:
        m = None
        if step[0] == "chunk":
            ts, buf, rs, m = driver._chunk(ts, buf, rs, eps, draws, *step[1:])
        elif step[0] == "rollout":
            buf, rs = driver._rollout_chunk(ts, buf, rs, eps, draws, step[1])
        else:
            ts, m = driver._train_burst(ts, buf, eps, draws)
        rec = {"rs": host(rs), "buf": host(buf)}
        if m:
            rec.update(ts=state_arrays(alg, ts), metrics=host(m))
        out.append(rec)
    res = {"steps": out, "counts": dict(meshlib.COUNTS),
           "remaining": getattr(draws, "remaining", dict)()}
    if args.get("routed"):
        res["routed"] = driver._routed(buf)
    if isinstance(driver, OnPolicyDriver):
        res["filled"] = driver.filled(buf)
    return res


def run_eval(args, mesh):
    """``OffPolicyDriver.run`` of ``args["episodes"]`` episodes from the
    port's own draw streams, then a greedy evaluation of 16 episodes:
    the rows, the evaluation, the state and the collectives."""
    dev = args.get("device", "cpu")
    hooks, alg, driver = program("checkers", args.get("alg", ()),
                                 args.get("train", ()), device=dev)
    ts = alg.init_state(prng.root_key(1))
    meshlib.COUNTS.clear()
    logged = []
    ts, stats = driver.run(ts, key=42, n_episodes=args["episodes"],
                           mesh=mesh, log_fn=logged.append)
    r_l, r_g, _ = driver.evaluate(ts, prng.GeneratorDraws(prng.generator(
        prng.root_key(123), dev)), 16)
    rows = [{k: v for k, v in r.items() if k != "duration_s"}
            for r in stats["history"]]
    return {"rows": rows, "logged": len(logged), "r_local": host(r_l),
            "r_global": float(r_g), "episodes": stats["episodes"],
            "ts": state_arrays(alg, ts), "counts": dict(meshlib.COUNTS)}


def seeds(args, mesh):
    """``train_vmapped_seeds`` of ``args["n_seeds"]`` seeds (over the seed
    mesh ``mesh``): its rows, this rank's seeds' state and the
    collectives."""
    hooks, alg, _ = program(args["kind"], args.get("alg", ()),
                            args.get("train", ()),
                            device=args.get("device", "cpu"))
    cfg = tcfg.TrainConfig(**dict(WORKER_TRAIN if args["kind"] == "checkers"
                                  else {}, **dict(args.get("train", ()))))
    meshlib.COUNTS.clear()
    ts, rows = multiseed.train_vmapped_seeds(
        hooks, alg, cfg, args["n_seeds"], 7,
        onpolicy=args["kind"] == "particle", mesh=mesh)
    s = args["n_seeds"] // (1 if mesh is None else mesh.size)
    rows = [{k: v for k, v in r.items() if k != "duration_s"} for r in rows]
    return {"rows": host(rows), "ts": state_arrays(alg.for_seeds(s), ts),
            "counts": dict(meshlib.COUNTS)}


CASES = {"chunks": chunks, "run_eval": run_eval, "seeds": seeds}


# --------------------------------------------------------------------- #
# spawning the ranks and putting their blocks together
# --------------------------------------------------------------------- #


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def launch(cases, tmp_dir, world=2, device="cpu"):
    """Start ``world`` gloo ranks running ``cases`` ({name: (case, args,
    mesh axis)}) in one spawn, each on ``device`` (the CPU, or one card
    they share); ``collect`` waits for them."""
    spec = os.path.join(tmp_dir, "spec.pkl")
    with open(spec, "wb") as f:
        pickle.dump(cases, f)
    port = str(_free_port())
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-u", WORKER, spec, port, str(r), str(world),
         device],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
        for r in range(world)]
    return procs, cases, tmp_dir


def collect(launched, timeout=300):
    """-> {name: [each rank's result]} of a ``launch``."""
    procs, cases, tmp_dir = launched
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=timeout)[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out[-6000:]}"
    res = {}
    for name in cases:
        res[name] = []
        for r in range(len(procs)):
            with open(os.path.join(tmp_dir, f"{name}.{r}.pkl"), "rb") as f:
                res[name].append(pickle.load(f))
    return res


def run_cases(cases, tmp_dir, rank, world):
    """A rank's side of ``spawn``: each case on its mesh, its result
    written beside the spec."""
    meshes = {}
    for case_name, (case, args, axis) in cases.items():
        if axis not in meshes:
            meshes[axis] = meshlib.make_mesh(world, axis=axis)
        out = CASES[case](args, meshes[axis])
        with open(os.path.join(tmp_dir, f"{case_name}.{rank}.pkl"),
                  "wb") as f:
            pickle.dump(out, f)


def equal_on_ranks(trees, what=""):
    """Every rank's tree equal to rank 0's, bit for bit."""
    for r, t in enumerate(trees[1:], 1):
        _walk(lambda a, b, p: np.testing.assert_array_equal(
            a, b, err_msg=f"{what}{p}: rank {r} against rank 0"),
            t, trees[0])


def _walk(fn, a, b, path=""):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), (path, sorted(a), sorted(b))
        for k in a:
            _walk(fn, a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _walk(fn, x, y, f"{path}[{i}]")
    elif a is None or isinstance(a, (str, bool)):
        assert a == b, path
    else:
        fn(np.asarray(a), np.asarray(b), path)


def close(got, want, what="", rtol=1e-5, atol=1e-6):
    """Two trees equal: integers and booleans exactly, floats within
    rtol / atol."""
    def one(a, b, p):
        if np.issubdtype(b.dtype, np.floating):
            np.testing.assert_allclose(a, b, rtol=rtol, atol=atol,
                                       err_msg=what + p)
        else:
            np.testing.assert_array_equal(a, b, err_msg=what + p)
    _walk(one, got, want)


def joined(per_rank, shard_keys):
    """The run's tree from every rank's block: the leaves under a key
    of ``shard_keys`` (top-level) joined rank-major along dim 0, the
    others equal on every rank and taken once."""
    out = {}
    for k, v in per_rank[0].items():
        if k in shard_keys:
            out[k] = _join([t[k] for t in per_rank])
        else:
            equal_on_ranks([t[k] for t in per_rank], k)
            out[k] = v
    return out


def _join(trees):
    t0 = trees[0]
    if isinstance(t0, dict):
        return {k: _join([t[k] for t in trees]) for k in t0}
    if isinstance(t0, (list, tuple)):
        return type(t0)(_join([t[i] for t in trees]) for i in range(len(t0)))
    if t0 is None:
        return None
    return np.concatenate([np.asarray(t) for t in trees])


# RolloutState's running values: the same on every rank
RUNNING = meshlib._RUNNING


def joined_rollout(per_rank):
    return joined(per_rank, [k for k in per_rank[0] if k not in RUNNING])


def joined_replay(per_rank, sharded):
    """The replay of the run: shard-local rings joined, one ring equal
    on every rank."""
    if sharded:
        return _join(per_rank)
    equal_on_ranks(per_rank, "replay")
    return per_rank[0]


def ring_rows(buf):
    """A replay's rows below each ring's fill (host arrays): a host-cursor
    ring's first ``size`` rows, a device ring's per index of its leading
    shape, with the cursors."""
    if "bad" in buf:
        return {"bad": ring_rows(buf["bad"]), "good": ring_rows(buf["good"])}
    size = np.asarray(buf["size"])
    if size.ndim == 0 and "n_seeds" in buf:
        return {"size": size, "insert": np.asarray(buf["insert"]),
                "data": tree_map(lambda x: x[:int(size)], buf["data"])}
    flat = size.reshape(-1)
    k = size.ndim

    def rows(x):
        x = x.reshape((-1,) + x.shape[k:])
        return [x[i, :n] for i, n in enumerate(flat)]
    return {"size": size, "insert": np.asarray(buf["insert"]),
            "data": tree_map(rows, buf["data"])}



def joined_steps(cases, ranks, name):
    """Each recorded step of case ``name``: the run from the ranks'
    blocks (rollout, replay rows), and its learner and metrics, which
    must be the same bytes on every rank."""
    sharded = dict(cases[name][1]["train"]).get("replay_shards", 1) > 1
    out = []
    for i in range(len(ranks[name][0]["steps"])):
        per = [r["steps"][i] for r in ranks[name]]
        step = {"rs": joined_rollout([p["rs"] for p in per]),
                "buf": ring_rows(joined_replay([p["buf"] for p in per],
                                               sharded))}
        if "ts" in per[0]:
            equal_on_ranks([p["ts"] for p in per], "ts")
            equal_on_ranks([p["metrics"] for p in per], "metrics")
            step.update(ts=per[0]["ts"], metrics=per[0]["metrics"])
        out.append(step)
    return out
