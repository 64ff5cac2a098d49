"""Config-driven training entry point (``cm3_tpu.train.runner``).

Reads the master JSON config (the keys of the reference's
``alg/config.json``), builds env, algorithm and driver, applies the
curriculum restore (``train_from_nothing``, ``restore_same_stage``, the
stage-2 graft from ``dir_restore/model_name``), trains with periodic
evaluation, the CSV and JSONL logs and the threshold-gated snapshots,
keeps a rolling autosave to resume from (``auto_resume``,
``require_resume``), and saves ``model_final``; ``train_multiseed``
runs ``n_seeds`` seeds one after another, or in lockstep with
``vmapped_seeds`` (per-seed ``log/<dir>_<i>`` and ``saved/<dir>_<i>``,
the stage-2 graft into every seed, one autosave of the stack).  The
files and their formats are the JAX runner's; the checkpoints are the
port's own (``train/checkpoint.py``).

The port runs Checkers, particle and roadway with each ``alg_name`` of
the JAX runner: ``cm3``, the baselines ``coma`` and ``iac`` (central-V
and the alpha-blend through ``use_V``/``use_Q``), and ``qmix``;
``build`` maps the name to the algorithm and its flags as JAX's
``build`` does, and picks the driver as JAX's does
(``runner.py:143-146``): on-policy (``train/onpolicy.py``) for particle
CM3, COMA and IAC, off-policy for Checkers, roadway and for QMIX
everywhere.  The particle scenario is the master's ``particle_config``
(``stage2_antipodal``, ``config_particle_stage2_merge.json``, ...; the
default ``stage<N>``), with its ``prob_random`` and ``max_steps``;
roadway's is ``roadway_stage<N>.json`` with the master's
``prob_random``, and its snapshots default to that file's
``save_threshold`` (``runner.py:245-248``).  The master's
``dual_buffer`` and ``threshold`` reach the driver and the hooks as in
JAX (``runner.py:137-142``); the master's ``max_steps`` (33) sizes the
dual buffer's slab and the evaluation on roadway too, whose cars stop
at 40 steps.  At stage 2 from a stage-1
checkpoint CM3 and the baselines graft it
(``checkpoint.stage2_init_cm3``, ``stage2_init_baseline``); QMIX
restores it and grafts nothing, as the JAX runner does
(``runner.py:208-214, 398-404``).  As in the JAX runner, an on-policy
run resumed from its autosave restores the state but restarts its
episode count and epsilon: only the off-policy driver takes
``initial_episodes`` (``runner.py:293-295``).  With ``summarize`` the
runner writes TensorBoard event files (``train/tboard.py``) as JAX's
does (``runner.py:221-223, 256-270, 367-370, 430-457``): one writer in
``log/<dir_name>`` (with seeds in lockstep one per seed directory),
and per period row every numeric scalar but ``episode``,
``r_eval_local/agent_<i>``, the state's ``vars/...`` and the gradient
snapshot's ``grads/...`` histograms, then a flush.  ``render_episodes``
(and the CLI's ``--render-episodes K`` / ``--render-only``) writes
greedy episodes as animated SVGs (``envs/render.py``) under
``render/<dir_name>``.  The master's ``replay_shards`` reaches the
drivers as in JAX (shard-local replay on the one device,
``train/offpolicy.py``), and a ``mesh`` key is ignored, as JAX's
``build`` keeps only ``TrainConfig``'s fields
(``runner.py:137-140``).  The master's ``chunks_per_sync`` reaches
the off-policy driver as in JAX: the paper's single-env cells
(``checkers_s2_e1``, ``checkers_qmix_e1``: ``n_envs`` 1, K = 32) run K
chunks per host sync (``train/offpolicy.py``); seeds in lockstep and
the on-policy driver ignore it, as JAX's do.
Learning runs in full float32: the nets pin it themselves
(``models/nets.py:full_float32``), where the JAX runner enters
``jax.default_matmul_precision("float32")``.

Every function runs on ``device`` (``cuda`` unless told).

Usage:
    python -m cm3_tpu_torch.train.runner \\
        --config cm3_tpu/configs/master.json [--experiment roadway \\
        --stage 2 --alg coma --episodes 5000 --n-envs 16 --workdir DIR \\
        --multiseed --device cpu] [--render-episodes K] [--render-only]
"""

from __future__ import annotations

import argparse
import dataclasses
import os
from typing import Any, Dict, Optional, Tuple

import numpy as np

from cm3_tpu_torch.algs.baseline import Baseline
from cm3_tpu_torch.algs.cm3 import CM3
from cm3_tpu_torch.algs.qmix import QMIX
from cm3_tpu_torch.core import config as cfgmod
from cm3_tpu_torch.core import prng
from cm3_tpu_torch.envs.checkers import Checkers
from cm3_tpu_torch.envs.particle import Particle
from cm3_tpu_torch.envs.roadway import Roadway
from cm3_tpu_torch.envs import render as rndr
from cm3_tpu_torch.train import checkpoint, tboard
from cm3_tpu_torch.train.experiments import make_hooks
from cm3_tpu_torch.train.logging import CSVLogger, stdout_log
from cm3_tpu_torch.train.multiseed import train_vmapped_seeds
from cm3_tpu_torch.train.offpolicy import OffPolicyDriver
from cm3_tpu_torch.train.onpolicy import OnPolicyDriver


def _nn_config(master: Dict, experiment: str, stage: int) -> cfgmod.NNConfig:
    nn = dict(master.get("nn", {}))
    if experiment == "checkers":
        nn.update(cfgmod.load_json(f"checkers_stage{stage}.json")["nn"])
    known = {f.name for f in dataclasses.fields(cfgmod.NNConfig)}
    return cfgmod.NNConfig(**{k: (tuple(v) if isinstance(v, list) else v)
                              for k, v in nn.items() if k in known})


def build_env(master: Dict, experiment: str, stage: int, device="cuda"):
    max_steps = master.get("max_steps", 33)
    prob_random = master.get("prob_random", 0.2)
    if experiment == "particle":
        name = master.get("particle_config", f"stage{stage}")
        name = name.replace("config_particle_", "").replace(".json", "")
        return Particle(cfgmod.particle_env_config(
            name, prob_random=prob_random, max_steps=max_steps),
            device=device)
    if experiment == "roadway":
        return Roadway(cfgmod.roadway_env_config(stage,
                                                 prob_random=prob_random),
                       device=device)
    if experiment != "checkers":
        raise ValueError(experiment)
    # the reference passes the master max_steps into Checkers
    # (train_offpolicy.py:127)
    return Checkers(cfgmod.checkers_env_config(stage, max_steps=max_steps),
                    device=device)


def select_alg_name(master: Dict) -> str:
    if master.get("alg_name"):
        return master["alg_name"]
    if master.get("use_alg_credit", 1):
        return "cm3"
    if master.get("use_qmix", 0):
        return "qmix"
    if master.get("IAC", 0):
        return "iac"
    return "coma"


def build(master: Dict, experiment: Optional[str] = None,
          stage: Optional[int] = None, device="cuda"):
    """-> (driver, alg, hooks, train_cfg) for one seed."""
    experiment = experiment or master.get("experiment", "checkers")
    stage = stage or master.get("stage", 1)
    alg_name = select_alg_name(master)
    env = build_env(master, experiment, stage, device)
    alg_cfg = cfgmod.AlgConfig(
        alg_name=alg_name, stage=stage, n_agents=env.spec()["n_agents"],
        use_Q_credit=bool(master.get("use_Q_credit", 1)),
        use_V=bool(master.get("use_V", 0)),
        use_Q=bool(master.get("use_Q", alg_name == "coma")),
        IAC=alg_name == "iac" or bool(master.get("IAC", 0)),
        alpha=master.get("alpha", 0.7),
        lr_Q=master.get("lr_Q", 1e-3), lr_V=master.get("lr_V", 1e-3),
        lr_actor=master.get("lr_actor", 1e-4),
        grad_clip=master.get("grad_clip", 0.0),
        qmix_ref_bug=bool(master.get("qmix_ref_bug", 0)),
        init_scheme=master.get("init_scheme", "ref"),
        actor_freeze_updates=int(master.get("actor_freeze_updates", 0)),
        actor_lr_anneal_updates=int(master.get("actor_lr_anneal_updates",
                                               0)),
        target_clip=master.get("target_clip", 0.0),
        pg_is_clip=master.get("pg_is_clip", 0.0),
        pg_ent_coef=master.get("pg_ent_coef", 0.0),
        adv_norm=bool(master.get("adv_norm", 0)),
        fused_opt=bool(master.get("fused_opt", 0)))
    if alg_name == "cm3":
        cls = CM3
    elif alg_name == "qmix":
        cls = QMIX
    else:  # coma / iac / central-V baselines
        cls = Baseline
        if alg_name == "iac":
            alg_cfg = dataclasses.replace(alg_cfg, use_V=True, IAC=True,
                                          use_Q=False)
        elif alg_name == "coma" and not alg_cfg.use_V:
            alg_cfg = dataclasses.replace(alg_cfg, use_Q=True)
    alg = cls(experiment, env.spec(), alg_cfg,
              _nn_config(master, experiment, stage), device=device)

    known = {f.name for f in dataclasses.fields(cfgmod.TrainConfig)}
    tc_kwargs = {k: v for k, v in master.items() if k in known}
    tc_kwargs["buffer_size"] = int(master.get("buffer_size", 2e4))
    train_cfg = cfgmod.TrainConfig(**tc_kwargs)

    hooks = make_hooks(experiment, env, threshold=train_cfg.threshold)
    onpolicy = experiment == "particle" and alg_name in ("cm3", "coma",
                                                         "iac")
    driver = (OnPolicyDriver if onpolicy else OffPolicyDriver)(
        hooks, alg, train_cfg)
    return driver, alg, hooks, train_cfg


def _restore_dir(master: Dict, workdir: str) -> str:
    return os.path.join(workdir, "saved",
                        master.get("dir_restore",
                                   master.get("dir_name", "try")),
                        master.get("model_name", "model_final"))


def _restore_flexible(restore_dir: str, master: Dict, key, device):
    """Restore into a fresh state of ``master``'s configuration; if the
    checkpoint's optimizer differs (``grad_clip`` on where it was off,
    or off where it was on), restore with the clip toggled and keep
    the parameters and targets with a fresh optimizer (restores at the
    start of a run only consume those)."""
    def mk(m):
        return build(m, device=device)[1].init_state(key)

    template = mk(master)
    try:
        return checkpoint.restore(restore_dir, template)
    except ValueError:
        alt = dict(master)
        alt["grad_clip"] = 0.0 if master.get("grad_clip") else 10.0
        restored = checkpoint.restore(restore_dir, mk(alt))
        return checkpoint.merge_non_opt(template, restored)


def _restore_stage1_state(master: Dict, workdir: str, key, device="cuda"):
    """The stage-1 winner's checkpoint for a stage-2 graft
    (train_offpolicy.py:154-198), restored into a stage-1 state built
    from the same master with ``stage`` 1."""
    m1 = dict(master)
    m1["stage"] = 1
    m1.pop("particle_config", None)
    return _restore_flexible(_restore_dir(master, workdir), m1, key, device)


def _save_threshold(master: Dict, experiment: str, stage: int):
    """The snapshots' eval threshold: the master's ``save_threshold``,
    else roadway's from ``roadway_stage<N>.json`` (``runner.py:245-248,
    356-359``), else None (the experiment's rule)."""
    if master.get("save_threshold") is None and experiment == "roadway":
        return cfgmod.load_json(
            f"roadway_stage{stage}.json")["save_threshold"]
    return master.get("save_threshold")


def _snapshot_stat(r_eval, save_threshold, experiment: str, stage: int):
    """(good, statistic) of a threshold-gated snapshot
    (train_offpolicy.py:391-398)."""
    if save_threshold is not None:
        return (bool((r_eval > save_threshold).all()),
                float(np.min(r_eval)))
    if experiment == "checkers" and stage == 1:
        stat = float(r_eval.sum())
        return stat > 9.0, stat
    return False, -np.inf


def _graft(alg, ts, ts1):
    """The stage-1 state ``ts1`` grafted into the fresh stage-2 state
    ``ts`` as the JAX runner does for ``alg``'s kind: CM3's graft, the
    baselines' (the actor, and V where stage 1 has one), and for QMIX
    nothing: the JAX runner restores QMIX's stage-1 checkpoint and keeps
    the fresh state (``runner.py:208-214, 398-404``)."""
    if isinstance(alg, CM3):
        return checkpoint.stage2_init_cm3(ts, ts1.actor, ts1.qg)
    if isinstance(alg, Baseline):
        return checkpoint.stage2_init_baseline(ts, ts1.actor, ts1.v)
    return ts


def initial_state(master: Dict, workdir: str = ".", device="cuda"):
    """(driver, alg, hooks, train_cfg, state) of one seed's run before
    it trains: fresh parameters from the seed, then the curriculum
    restore (train_offpolicy.py:154-198): with ``train_from_nothing`` 0,
    the same stage's checkpoint (``restore_same_stage``) or, at stage 2,
    the stage-1 checkpoint restored and grafted into the fresh state
    (``_graft``)."""
    driver, alg, hooks, train_cfg = build(master, device=device)
    key = prng.root_key(master.get("seed", 12341))
    ts = alg.init_state(key)
    if not master.get("train_from_nothing", 1):
        if master.get("restore_same_stage", 0):
            ts = _restore_flexible(_restore_dir(master, workdir),
                                   dict(master), key, device)
        elif master.get("stage", 1) == 2:
            ts1 = _restore_stage1_state(master, workdir, key, device)
            ts = _graft(alg, ts, ts1)
    return driver, alg, hooks, train_cfg, ts


def train_function(master: Dict, workdir: str = ".",
                   n_episodes: Optional[int] = None,
                   verbose: bool = True, device="cuda") -> Tuple[Any, Dict]:
    """The reference's train_function(config) for one seed: returns the
    trained state and the driver's final stats."""
    experiment = master.get("experiment", "checkers")
    stage = master.get("stage", 1)
    dir_name = master.get("dir_name", "try")
    driver, alg, hooks, train_cfg, ts = initial_state(master, workdir,
                                                      device)
    key = prng.root_key(master.get("seed", 12341))

    log_dir = os.path.join(workdir, "log", dir_name)
    save_dir = os.path.join(workdir, "saved", dir_name)
    os.makedirs(save_dir, exist_ok=True)
    logger = CSVLogger(log_dir, hooks.n_agents,
                       resume=bool(master.get("auto_resume", 0)))
    # the TensorBoard stream when summarize (config.json:64; the
    # FileWriter at train_offpolicy.py:176, emission at :350-356)
    tb = tboard.SummaryWriter(log_dir) if master.get("summarize") else None

    # ---- elastic resume from the rolling autosave ----
    initial_episodes = 0
    autosave_path = os.path.join(save_dir, "model_autosave")
    if master.get("auto_resume", 0) and checkpoint.exists(autosave_path):
        restored = checkpoint.restore(autosave_path,
                                      {"ts": ts, "episodes": 0})
        ts = restored["ts"]
        initial_episodes = int(restored["episodes"])
        if verbose:
            print(f"auto-resume from episode {initial_episodes}")
    elif master.get("require_resume", 0):
        # a run that is a resume must not silently start from scratch
        # and overwrite the earlier run's files
        raise FileNotFoundError(
            f"require_resume=1 but no autosave at {autosave_path}")

    save_threshold = _save_threshold(master, experiment, stage)
    best_good = [-np.inf]

    def log_fn(row):
        if "_episodes" in row:
            logger.log_episodes(*row.pop("_episodes"))
        logger.log_period(row)
        if verbose:
            stdout_log(row)
        if tb is not None:
            write_summaries(tb, row, row["_ts"], row.get("_grads"))
        # snapshots on a threshold crossing that is also a new best (a
        # vectorized run crosses hundreds of times once converged)
        good, stat = _snapshot_stat(row["r_eval_local"], save_threshold,
                                    experiment, stage)
        if good and stat > best_good[0]:
            best_good[0] = stat
            checkpoint.save(
                os.path.join(save_dir, f"model_good_{row['episode']}"),
                row["_ts"])
        checkpoint.save(autosave_path,
                        {"ts": row["_ts"], "episodes": row["episode"]})

    run_kwargs = {}
    if not isinstance(driver, OnPolicyDriver):
        run_kwargs["initial_episodes"] = initial_episodes
    ts, stats = driver.run(ts, key, n_episodes=n_episodes, log_fn=log_fn,
                           **run_kwargs)
    if tb is not None:
        tb.close()
    checkpoint.save(os.path.join(save_dir, "model_final"), ts)
    return ts, stats


def write_summaries(tb, row, ts, grads=None, seed=None):
    """One period's events (``runner.py:256-270``): every int or float
    of ``row`` but ``episode`` as a scalar, ``r_eval_local/agent_<i>``,
    the state's histograms under ``vars/``, the gradient snapshot's
    under ``grads/``, then a flush; ``seed`` picks one seed of a
    seed-stacked state and gradients."""
    step = int(row["episode"])
    for k, v in row.items():
        if isinstance(v, (int, float)) and k != "episode":
            tb.scalar(k, float(v), step)
    for i, r in enumerate(np.asarray(row["r_eval_local"]).ravel()):
        tb.scalar(f"r_eval_local/agent_{i}", float(r), step)
    tboard.log_train_state(tb, ts, step, seed=seed)
    if grads is not None:
        tboard.log_grads(tb, ts, grads, step, seed=seed)
    tb.flush()


def _vmapped_autosave(master: Dict, workdir: str) -> str:
    return os.path.join(workdir, "saved",
                        f"{master.get('dir_name', 'try')}_vmapped",
                        "model_autosave")


def vmapped_resume(master: Dict, workdir: str, alg, alg_s, device="cuda"):
    """What seeds in lockstep start from: None (fresh per-seed
    parameters), the curriculum graft into every seed at stage 2 (each
    seed's fresh state with the stage-1 checkpoint grafted in as
    ``_graft`` does, stacked; episode counts 0), or with ``auto_resume``
    the stack's autosave (state and per-seed episode counts);
    ``require_resume`` without an autosave raises.  ``alg`` is the one-seed algorithm, ``alg_s`` the
    same for the seeds."""
    n_seeds, base_seed = alg_s.n_seeds, master.get("seed", 12341)
    autosave = _vmapped_autosave(master, workdir)
    have_autosave = checkpoint.exists(autosave)
    if master.get("require_resume", 0) and not (
            master.get("auto_resume", 0) and have_autosave):
        raise FileNotFoundError(
            f"require_resume=1 but no vmapped autosave at {autosave}")
    if master.get("auto_resume", 0) and have_autosave:
        restored = checkpoint.restore(
            autosave, {"ts": alg_s.empty_state(),
                       "episodes": np.zeros(n_seeds, np.int64)})
        return restored["ts"], np.asarray(restored["episodes"])
    if (not master.get("train_from_nothing", 1)
            and master.get("stage", 1) == 2
            and not master.get("restore_same_stage", 0)):
        ts1 = _restore_stage1_state(master, workdir,
                                    prng.root_key(base_seed), device)
        singles = [_graft(alg, alg.init_state(prng.root_key(base_seed + i)),
                          ts1) for i in range(n_seeds)]
        return (checkpoint.stack_states(alg_s, singles),
                np.zeros(n_seeds, np.int64))
    return None


def train_multiseed(master: Dict, workdir: str = ".",
                    n_episodes: Optional[int] = None, device="cuda"):
    """``n_seeds`` seeds, ``seed + i``, ``dir_name_<dir_idx_start + i>``
    (train_multiprocess.py:31-43): one after another, or with
    ``vmapped_seeds`` all in lockstep (``train/multiseed.py``), with
    per-seed logs, snapshots and ``model_final`` and one autosave of
    the stack in ``saved/<dir_name>_vmapped``.  Returns the list of
    (state, stats) of the sequential runs, or (stacked state, history)."""
    base_seed = master.get("seed", 12341)
    base_dir = master.get("dir_name", "try")
    start = master.get("dir_idx_start", 1)
    n_seeds = master.get("n_seeds", 1)
    if not master.get("vmapped_seeds"):
        return [train_function(dict(master, seed=base_seed + i,
                                    dir_name=f"{base_dir}_{start + i}"),
                               workdir, n_episodes, device=device)
                for i in range(n_seeds)]

    driver, alg, hooks, train_cfg = build(master, device=device)
    alg_s = alg.for_seeds(n_seeds)
    resume = vmapped_resume(master, workdir, alg, alg_s, device)
    experiment = master.get("experiment", "checkers")
    stage = master.get("stage", 1)
    save_threshold = _save_threshold(master, experiment, stage)
    resume_logs = bool(master.get("auto_resume", 0))
    log_dirs = [os.path.join(workdir, "log", f"{base_dir}_{start + i}")
                for i in range(n_seeds)]
    loggers = [CSVLogger(d, hooks.n_agents, resume=resume_logs)
               for d in log_dirs]
    # per-seed TensorBoard streams when summarize, with the state's and
    # the gradients' histograms as for one seed
    tbs = [tboard.SummaryWriter(d) if master.get("summarize") else None
           for d in log_dirs]
    save_dirs = [os.path.join(workdir, "saved", f"{base_dir}_{start + i}")
                 for i in range(n_seeds)]
    for d in save_dirs:
        os.makedirs(d, exist_ok=True)
    autosave = _vmapped_autosave(master, workdir)
    best_good = [-np.inf] * n_seeds

    def log_fn(row):
        _ts = row.pop("_ts")
        _grads = row.pop("_grads", None)
        _eps = row.pop("_episodes", None)
        for i in range(n_seeds):
            r_i = {k: (np.asarray(v)[i] if np.ndim(v) >= 1
                       and np.shape(v)[0] == n_seeds else v)
                   for k, v in row.items()}
            r_i["episode"] = int(row["episode"][i])
            if _eps is not None:
                loggers[i].log_episodes(*_eps[i])
            loggers[i].log_period(r_i)
            if tbs[i] is not None:
                write_summaries(tbs[i], r_i, _ts, _grads, seed=i)
            good, stat = _snapshot_stat(np.asarray(row["r_eval_local"][i]),
                                        save_threshold, experiment, stage)
            if good and stat > best_good[i]:
                best_good[i] = stat
                checkpoint.save(
                    os.path.join(save_dirs[i],
                                 f"model_good_{r_i['episode']}"),
                    checkpoint.seed_state(alg, _ts, i))
        checkpoint.save(autosave, {"ts": _ts, "episodes": row["episode"]})

    ts, history = train_vmapped_seeds(
        hooks, alg_s, train_cfg, n_seeds=n_seeds, base_seed=base_seed,
        n_episodes=n_episodes, log_fn=log_fn,
        onpolicy=isinstance(driver, OnPolicyDriver), resume=resume)
    for tb in tbs:
        if tb is not None:
            tb.close()
    for i in range(n_seeds):
        checkpoint.save(os.path.join(save_dirs[i], "model_final"),
                        checkpoint.seed_state(alg, ts, i))
    return ts, history


def render_episodes(master: Dict, ts, workdir: str = ".",
                    n_episodes: int = 3, restore: bool = False,
                    device="cuda"):
    """Write ``n_episodes`` greedy-policy episodes as animated SVG files
    ``workdir/render/<dir_name>/episode_<i>.svg`` (``runner.py:502-541``),
    the headless counterpart of the reference's pyglet episode viewer;
    returns their paths.  Pass ``ts=None`` with ``restore=True`` to
    render the checkpoint ``saved/<dir_name>/<model_name>``
    (``model_final`` by default) in the port's format.  Episode ``i``
    draws from the rollout purpose of the seed's key folded with
    777,000 + i."""
    experiment = master.get("experiment", "checkers")
    _, alg, hooks, _ = build(master, device=device)
    key = prng.root_key(master.get("seed", 12341))
    dir_name = master.get("dir_name", "try")
    if ts is None and restore:
        ts = checkpoint.restore(
            os.path.join(workdir, "saved", dir_name,
                         master.get("model_name", "model_final")),
            alg.empty_state())
    env_cfg = hooks.env.cfg
    max_steps = getattr(env_cfg, "max_steps", None) or env_cfg.max_step
    out_dir = os.path.join(workdir, "render", dir_name)
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for i in range(n_episodes):
        draws = prng.GeneratorDraws(prng.generator(prng.fold_in(
            prng.for_purpose(key, prng.ROLLOUT), 777_000 + i),
            hooks.env.device))
        states = rndr.collect_episode(hooks, alg, ts, draws, max_steps)
        path = os.path.join(out_dir, f"episode_{i}.svg")
        with open(path, "w") as f:
            f.write(rndr.render_episode_svg(experiment, states, env_cfg))
        paths.append(path)
    return paths


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--config", default="cm3_tpu/configs/master.json")
    p.add_argument("--experiment", default=None)
    p.add_argument("--stage", type=int, default=None)
    p.add_argument("--episodes", type=int, default=None)
    p.add_argument("--n-envs", type=int, default=None)
    p.add_argument("--alg", default=None)
    p.add_argument("--workdir", default=".")
    p.add_argument("--multiseed", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="torch device of the run (default cuda)")
    p.add_argument("--render-episodes", type=int, default=0, metavar="K",
                   help="after training (or, with --render-only, from the "
                   "saved model_final) write K greedy episodes as animated "
                   "SVGs under workdir/render/<dir_name>/")
    p.add_argument("--render-only", action="store_true",
                   help="skip training; restore model_final and render")
    args = p.parse_args(argv)

    master = cfgmod.load_json(args.config)
    if args.experiment:
        master["experiment"] = args.experiment
    if args.stage:
        master["stage"] = args.stage
    if args.n_envs:
        master["n_envs"] = args.n_envs
    if args.alg:
        master["alg_name"] = args.alg

    if args.render_only:
        print("\n".join(render_episodes(master, None, args.workdir,
                                        args.render_episodes or 3,
                                        restore=True, device=args.device)))
        return

    if args.multiseed:
        train_multiseed(master, args.workdir, args.episodes, args.device)
    else:
        ts, _ = train_function(master, args.workdir, args.episodes,
                               device=args.device)
        if args.render_episodes:
            print("\n".join(render_episodes(master, ts, args.workdir,
                                            args.render_episodes,
                                            device=args.device)))


if __name__ == "__main__":
    main()
