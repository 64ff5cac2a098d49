"""The paper's experiment matrix on the PyTorch port
(``scripts/reproduce_paper.py`` of the JAX package, ported).

Runs the paper's cells with its training budgets and schedule (50,000
episodes, epsilon 0.5 -> 0.05, a greedy evaluation of N_eval episodes
every period): the two-stage CM3 curriculum on Checkers, particle and
roadway, the QMIX / COMA / IAC baselines and the ablations, each cell
through ``cm3_tpu_torch.train.runner.train_function``.  The cells, the
gates, the scores, the ordering rows and the seed protocol are JAX's:
each cell tries up to ``--seeds`` seeds ``base_seed + i`` and stops at
the first that passes its gate, unless the cell is in ``ALL_SEEDS``; a
stage-2 cell restores the stage-1 cell's winner (the gate-passing seed,
else the best-scoring one).  One row per run is appended to
``WORKDIR/results.jsonl`` and ``WORKDIR/RESULTS.md`` is written anew
from all rows (``torch_summarize_reproduce.py``).  The comments of
``scripts/reproduce_paper.py`` give each cell's and gate's rationale.

``WORKDIR`` is ``runs/reproduce_torch``, relative to the working
directory: the port's checkpoints are its own format, so it never reads
or writes the JAX package's ``runs/reproduce``.

    python3 scripts/torch_reproduce_paper.py [--episodes N]
        [--cells a,b,...] [--seeds K] [--base-seed S] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

_HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(_HERE))
# sibling scripts by their own module names (another package named
# ``scripts`` may come first on the path)
sys.path.insert(0, _HERE)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from cm3_tpu_torch.train import runner  # noqa: E402

cfgmod = runner.cfgmod

WORKDIR = "runs/reproduce_torch"


def host(x):
    """A row's leaf as a host numpy array (a device tensor is copied)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def run_cell(name: str, overrides: dict, n_episodes=None, device="cuda"):
    """One seed of cell ``name``: master.json with ``overrides`` through
    ``train_function``; -> its results row (JAX's statistics: final and
    best evaluation, the best per-period minimum over agents, the reach
    rates, and the last 10 periods' means of the retention gates)."""
    m = cfgmod.load_json("master.json")
    m.update(overrides)
    t0 = time.time()
    ts, stats = runner.train_function(m, workdir=WORKDIR,
                                      n_episodes=n_episodes, verbose=False,
                                      device=device)
    minutes = (time.time() - t0) / 60
    hist = stats["history"]
    glob = [float(host(r["r_eval_global"])) for r in hist]
    last_loc = host(hist[-1]["r_eval_local"]) if hist else None
    min_loc = [float(host(r["r_eval_local"]).min()) for r in hist]
    reach = [float(host(r["eval_reach_rate"])) for r in hist
             if "eval_reach_rate" in r]
    t10 = lambda xs: (round(sum(xs[-10:]) / len(xs[-10:]), 3)
                      if xs else None)
    return dict(cell=name, minutes=round(minutes, 2),
                episodes=int(stats["episodes"]),
                final_eval_global=round(glob[-1], 3) if glob else None,
                best_eval_global=round(max(glob), 3) if glob else None,
                final_eval_local=[round(float(v), 3) for v in last_loc]
                if last_loc is not None else None,
                best_min_eval_local=round(max(min_loc), 3) if min_loc
                else None,
                final10_min_eval_local=t10(min_loc),
                best_reach_rate=round(max(reach), 3) if reach else None,
                final_reach_rate=round(reach[-1], 3) if reach else None,
                final10_reach_rate=t10(reach))


# the run order (a stage-2 cell restores its stage-1 cell's winner)
ORDER = ["checkers_s1", "checkers_s2", "particle_s1", "particle_s2",
         "particle_s2_cross", "particle_s2_merge", "particle_s2_dual",
         "roadway_s1", "roadway_s2", "roadway_s2_stable",
         "roadway_s2_retain", "roadway_s2_retain2", "roadway_s2_retain3",
         "roadway_s2_retain4", "roadway_s2_retain5", "roadway_s2_retain6",
         "roadway_s2_retain7", "roadway_s2_retain8",
         "particle_s2_retain", "particle_s2_retain2",
         "particle_s2_cross_retain", "particle_s2_cross_retain2",
         "particle_s2_merge_retain",
         "checkers_s2_V", "particle_s2_V",
         "checkers_qmix", "checkers_qmix_ref", "checkers_coma",
         "checkers_iac", "particle_coma", "particle_qmix", "roadway_qmix",
         "checkers_blend",
         "checkers_s2_lrA", "checkers_s2_lrB", "checkers_s2_tn",
         "checkers_s2_e1", "checkers_s2_lrA_ext",
         "checkers_qmix_tn", "checkers_qmix_tf1", "checkers_qmix_e1"]
# stage-2 cell -> the stage-1 cell it restores
DEPS = {"checkers_s2": "checkers_s1", "particle_s2": "particle_s1",
        "particle_s2_cross": "particle_s1", "particle_s2_merge":
        "particle_s1", "particle_s2_dual": "particle_s1",
        "roadway_s2": "roadway_s1", "roadway_s2_stable": "roadway_s1",
        "roadway_s2_retain": "roadway_s1",
        "roadway_s2_retain2": "roadway_s1",
        "roadway_s2_retain3": "roadway_s1",
        "roadway_s2_retain4": "roadway_s1",
        "roadway_s2_retain5": "roadway_s1",
        "roadway_s2_retain6": "roadway_s1",
        "roadway_s2_retain7": "roadway_s1",
        "roadway_s2_retain8": "roadway_s1",
        "particle_s2_retain": "particle_s1",
        "particle_s2_retain2": "particle_s1",
        "particle_s2_cross_retain": "particle_s1",
        "particle_s2_cross_retain2": "particle_s1",
        "particle_s2_merge_retain": "particle_s1",
        "checkers_s2_V": "checkers_s1",
        "particle_s2_V": "particle_s1",
        "checkers_s2_lrA": "checkers_s1", "checkers_s2_lrB": "checkers_s1",
        "checkers_s2_lrA_ext": "checkers_s1",
        "checkers_s2_tn": "checkers_s1",
        "checkers_s2_e1": "checkers_s1"}

# cells that run every requested seed (no stop at the first gate pass):
# the ordering rows compare statistics over seeds
ALL_SEEDS = {"roadway_s2_stable", "checkers_qmix", "checkers_qmix_ref",
             "checkers_coma", "checkers_iac",
             "particle_coma", "particle_qmix", "roadway_qmix",
             "checkers_blend",
             "roadway_s2_retain", "roadway_s2_retain2", "roadway_s2_retain3",
             "roadway_s2_retain4", "roadway_s2_retain5",
             "roadway_s2_retain6", "roadway_s2_retain7",
             "roadway_s2_retain8",
             "checkers_s2_lrA_ext",
             "particle_s2_retain", "particle_s2_retain2",
             "particle_s2_cross_retain", "particle_s2_cross_retain2",
             "particle_s2_merge_retain",
             "checkers_s2_V", "particle_s2_V",
             "checkers_s2_lrA", "checkers_s2_lrB", "checkers_s2_tn",
             "checkers_s2_e1",
             "checkers_qmix_tn", "checkers_qmix_tf1", "checkers_qmix_e1"}


def cells(episodes):
    """-> {cell: master overrides} at ``episodes`` per run, evaluated
    every ``max(episodes // 500, 1)`` episodes with N_eval 10."""
    e = episodes
    p = max(e // 500, 1)
    return {
        "checkers_s1": dict(experiment="checkers", stage=1, n_envs=16,
                            dir_name="ck_s1", N_train=e, period=p,
                            N_eval=10),
        "checkers_s2": dict(experiment="checkers", stage=2, n_envs=16,
                            dir_name="ck_s2", dir_restore="ck_s1",
                            train_from_nothing=0, N_train=e,
                            period=p, N_eval=10),
        "particle_s1": dict(experiment="particle", particle_config="stage1",
                            stage=1, n_envs=16, dir_name="pt_s1", N_train=e,
                            period=p, N_eval=10),
        "particle_s2": dict(experiment="particle",
                            particle_config="stage2_antipodal", stage=2,
                            n_envs=16, dir_name="pt_s2", dir_restore="pt_s1",
                            train_from_nothing=0, N_train=e,
                            period=p, N_eval=10),
        "particle_s2_cross": dict(experiment="particle",
                                  particle_config="stage2_cross", stage=2,
                                  n_envs=16, dir_name="pt_s2x",
                                  dir_restore="pt_s1", train_from_nothing=0,
                                  N_train=e, dual_buffer=1,
                                  period=p, N_eval=10),
        "particle_s2_merge": dict(experiment="particle",
                                  particle_config="stage2_merge", stage=2,
                                  n_envs=16, dir_name="pt_s2m",
                                  dir_restore="pt_s1", train_from_nothing=0,
                                  N_train=e, dual_buffer=1,
                                  period=p, N_eval=10),
        "particle_s2_dual": dict(experiment="particle",
                                 particle_config="stage2_antipodal", stage=2,
                                 n_envs=16, dir_name="pt_s2d",
                                 dir_restore="pt_s1", train_from_nothing=0,
                                 N_train=e, dual_buffer=1,
                                 period=p, N_eval=10),
        "roadway_s1": dict(experiment="roadway", stage=1, n_envs=16,
                           dir_name="rd_s1", N_train=e,
                           period=p, N_eval=10),
        "roadway_s2": dict(experiment="roadway", stage=2, n_envs=16,
                           dir_name="rd_s2", dir_restore="rd_s1",
                           train_from_nothing=0, N_train=e, dual_buffer=1,
                           period=p, N_eval=10),
        "roadway_s2_stable": dict(experiment="roadway", stage=2, n_envs=16,
                                  dir_name="rd_s2c", dir_restore="rd_s1",
                                  train_from_nothing=0, N_train=e,
                                  dual_buffer=1, grad_clip=10.0,
                                  period=p, N_eval=10),
        "checkers_qmix": dict(experiment="checkers", stage=2, n_envs=16,
                              alg_name="qmix", dir_name="ck_qmix",
                              train_from_nothing=1, N_train=e,
                              period=p, N_eval=10),
        "checkers_coma": dict(experiment="checkers", stage=2, n_envs=16,
                              alg_name="coma", dir_name="ck_coma",
                              train_from_nothing=1, N_train=e,
                              period=p, N_eval=10),
        "checkers_iac": dict(experiment="checkers", stage=2, n_envs=16,
                             alg_name="iac", dir_name="ck_iac",
                             train_from_nothing=1, N_train=e,
                             period=p, N_eval=10),
        "checkers_qmix_ref": dict(experiment="checkers", stage=2,
                                  n_envs=16, alg_name="qmix",
                                  qmix_ref_bug=1, dir_name="ck_qmixb",
                                  train_from_nothing=1, N_train=e,
                                  period=p, N_eval=10),
        "roadway_s2_retain": dict(experiment="roadway", stage=2, n_envs=16,
                                  dir_name="rd_s2r", dir_restore="rd_s1",
                                  train_from_nothing=0, N_train=e,
                                  dual_buffer=1, grad_clip=10.0,
                                  actor_freeze_updates=8000,
                                  epsilon_start=0.2,
                                  period=p, N_eval=10),
        "roadway_s2_retain2": dict(experiment="roadway", stage=2,
                                   n_envs=16, dir_name="rd_s2r2",
                                   dir_restore="rd_s1",
                                   train_from_nothing=0, N_train=e,
                                   dual_buffer=1, grad_clip=10.0,
                                   actor_freeze_updates=8000,
                                   epsilon_start=0.2, target_clip=25.0,
                                   period=p, N_eval=10),
        "particle_s2_retain": dict(experiment="particle",
                                   particle_config="stage2_antipodal",
                                   stage=2, n_envs=16, dir_name="pt_s2r",
                                   dir_restore="pt_s1",
                                   train_from_nothing=0, N_train=e,
                                   actor_freeze_updates=5000,
                                   epsilon_start=0.2,
                                   period=p, N_eval=10),
        "roadway_s2_retain3": dict(experiment="roadway", stage=2,
                                   n_envs=16, dir_name="rd_s2r3",
                                   dir_restore="rd_s1",
                                   train_from_nothing=0, N_train=e,
                                   dual_buffer=1, grad_clip=10.0,
                                   actor_freeze_updates=8000,
                                   epsilon_start=0.2, target_clip=25.0,
                                   lr_actor=3e-5,
                                   period=p, N_eval=10),
        "roadway_s2_retain4": dict(experiment="roadway", stage=2,
                                   n_envs=16, dir_name="rd_s2r4",
                                   dir_restore="rd_s1",
                                   train_from_nothing=0, N_train=e,
                                   dual_buffer=1, grad_clip=10.0,
                                   actor_freeze_updates=8000,
                                   epsilon_start=0.2, target_clip=25.0,
                                   adv_norm=1,
                                   period=p, N_eval=10),
        "roadway_s2_retain5": dict(experiment="roadway", stage=2,
                                   n_envs=16, dir_name="rd_s2r5",
                                   dir_restore="rd_s1",
                                   train_from_nothing=0, N_train=e,
                                   dual_buffer=1, grad_clip=10.0,
                                   actor_freeze_updates=8000,
                                   epsilon_start=0.2, target_clip=25.0,
                                   actor_lr_anneal_updates=40000,
                                   period=p, N_eval=10),
        "roadway_s2_retain6": dict(experiment="roadway", stage=2,
                                   n_envs=16, dir_name="rd_s2r6",
                                   dir_restore="rd_s1",
                                   train_from_nothing=0, N_train=e,
                                   dual_buffer=1, grad_clip=10.0,
                                   actor_freeze_updates=8000,
                                   epsilon_start=0.2, target_clip=25.0,
                                   pg_is_clip=1.0,
                                   period=p, N_eval=10),
        "roadway_s2_retain7": dict(experiment="roadway", stage=2,
                                   n_envs=16, dir_name="rd_s2r7",
                                   dir_restore="rd_s1",
                                   train_from_nothing=0, N_train=e,
                                   dual_buffer=1, grad_clip=10.0,
                                   actor_freeze_updates=8000,
                                   epsilon_start=0.2, target_clip=25.0,
                                   pg_is_clip=1.0, pg_ent_coef=0.01,
                                   period=p, N_eval=10),
        "roadway_s2_retain8": dict(experiment="roadway", stage=2,
                                   n_envs=16, dir_name="rd_s2r8",
                                   dir_restore="rd_s1",
                                   train_from_nothing=0, N_train=e,
                                   dual_buffer=1, grad_clip=10.0,
                                   actor_freeze_updates=8000,
                                   epsilon_start=0.2, target_clip=25.0,
                                   pg_is_clip=1.0, pg_ent_coef=0.1,
                                   period=p, N_eval=10),
        "particle_s2_retain2": dict(experiment="particle",
                                    particle_config="stage2_antipodal",
                                    stage=2, n_envs=16,
                                    dir_name="pt_s2r2",
                                    dir_restore="pt_s1",
                                    train_from_nothing=0, N_train=e,
                                    actor_freeze_updates=5000,
                                    target_clip=150.0,
                                    period=p, N_eval=10),
        "particle_s2_cross_retain": dict(
            experiment="particle", particle_config="stage2_cross",
            stage=2, n_envs=16, dir_name="pt_s2xr", dir_restore="pt_s1",
            train_from_nothing=0, N_train=e, actor_freeze_updates=5000,
            target_clip=150.0, period=p, N_eval=10),
        "particle_s2_cross_retain2": dict(
            experiment="particle", particle_config="stage2_cross",
            stage=2, n_envs=16, dir_name="pt_s2xr2", dir_restore="pt_s1",
            train_from_nothing=0, N_train=e, actor_freeze_updates=5000,
            target_clip=150.0, pg_ent_coef=0.01, period=p, N_eval=10),
        "particle_s2_merge_retain": dict(
            experiment="particle", particle_config="stage2_merge",
            stage=2, n_envs=16, dir_name="pt_s2mr", dir_restore="pt_s1",
            train_from_nothing=0, N_train=e, actor_freeze_updates=5000,
            target_clip=150.0, period=p, N_eval=10),
        "checkers_s2_V": dict(experiment="checkers", stage=2, n_envs=16,
                              dir_name="ck_s2V", dir_restore="ck_s1",
                              train_from_nothing=0, N_train=e,
                              use_Q_credit=0, use_V=1,
                              period=p, N_eval=10),
        "particle_s2_V": dict(experiment="particle",
                              particle_config="stage2_antipodal", stage=2,
                              n_envs=16, dir_name="pt_s2V",
                              dir_restore="pt_s1", train_from_nothing=0,
                              N_train=e, use_Q_credit=0, use_V=1,
                              period=p, N_eval=10),
        "particle_qmix": dict(experiment="particle",
                              particle_config="stage2_antipodal", stage=2,
                              n_envs=16, alg_name="qmix",
                              dir_name="pt_qmix", train_from_nothing=1,
                              N_train=e, period=p, N_eval=10),
        "checkers_blend": dict(experiment="checkers", stage=2, n_envs=16,
                               alg_name="coma", use_V=1, use_Q=1,
                               alpha=0.7, dir_name="ck_blend",
                               train_from_nothing=1, N_train=e,
                               period=p, N_eval=10),
        "checkers_s2_lrA": dict(experiment="checkers", stage=2, n_envs=16,
                                dir_name="ck_s2lr", dir_restore="ck_s1",
                                train_from_nothing=0, N_train=e,
                                lr_actor=3e-4,
                                period=p, N_eval=10),
        "checkers_s2_lrA_ext": dict(experiment="checkers", stage=2,
                                    n_envs=16, dir_name="ck_s2lr",
                                    dir_restore="ck_s1",
                                    train_from_nothing=0, N_train=e,
                                    lr_actor=3e-4, auto_resume=1,
                                    require_resume=1,
                                    period=100, N_eval=10),
        "checkers_s2_lrB": dict(experiment="checkers", stage=2, n_envs=16,
                                dir_name="ck_s2lr5", dir_restore="ck_s1",
                                train_from_nothing=0, N_train=e,
                                lr_actor=5e-4,
                                period=p, N_eval=10),
        "checkers_s2_tn": dict(experiment="checkers", stage=2, n_envs=16,
                               dir_name="ck_s2tn", dir_restore="ck_s1",
                               train_from_nothing=0, N_train=e,
                               init_scheme="trunc001",
                               period=p, N_eval=10),
        "checkers_qmix_tn": dict(experiment="checkers", stage=2, n_envs=16,
                                 alg_name="qmix", dir_name="ck_qmtn",
                                 train_from_nothing=1, N_train=e,
                                 init_scheme="trunc001",
                                 period=p, N_eval=10),
        "checkers_qmix_tf1": dict(experiment="checkers", stage=2,
                                  n_envs=16, alg_name="qmix",
                                  dir_name="ck_qmtf",
                                  train_from_nothing=1, N_train=e,
                                  init_scheme="tf1",
                                  period=p, N_eval=10),
        "checkers_qmix_e1": dict(experiment="checkers", stage=2, n_envs=1,
                                 alg_name="qmix", dir_name="ck_qme1",
                                 train_from_nothing=1, N_train=e,
                                 chunks_per_sync=32,
                                 period=p, N_eval=10),
        "checkers_s2_e1": dict(experiment="checkers", stage=2, n_envs=1,
                               dir_name="ck_s2e1", dir_restore="ck_s1",
                               train_from_nothing=0, N_train=e,
                               chunks_per_sync=32,
                               period=p, N_eval=10),
        "particle_coma": dict(experiment="particle",
                              particle_config="stage2_antipodal", stage=2,
                              n_envs=16, alg_name="coma",
                              dir_name="pt_coma", train_from_nothing=1,
                              N_train=e, period=p, N_eval=10),
        "roadway_qmix": dict(experiment="roadway", stage=2, n_envs=16,
                             alg_name="qmix", dir_name="rd_qmix",
                             train_from_nothing=1, N_train=e,
                             period=p, N_eval=10),
    }


# cell -> (description, test of a results row): best-over-training
# statistics (a "good model" is saved at the first crossing,
# train_offpolicy.py:385-398), the retention cells' final plateaus
GATES = {
    "checkers_s1": ("best sum eval > 9.0 (train_offpolicy.py:397)",
                    lambda r: (r["best_eval_global"] or -99) > 9.0),
    "checkers_s2": ("best sum eval > 9.0 two-agent (same gate)",
                    lambda r: (r["best_eval_global"] or -99) > 9.0),
    "particle_s1": ("best goal-reach rate >= 0.9 (dist<=0.05, "
                    "multi-goal_spread.py:126; scripted-greedy probe "
                    "achieves 0.955 at return -29.4)",
                    lambda r: (r["best_reach_rate"] or 0) >= 0.9),
    "particle_s2": ("best goal-reach rate >= 0.75 (antipodal swap)",
                    lambda r: (r["best_reach_rate"] or 0) >= 0.75),
    "particle_s2_cross": ("best goal-reach rate >= 0.75 (4-agent cross)",
                          lambda r: (r["best_reach_rate"] or 0) >= 0.75),
    "particle_s2_merge": ("best goal-reach rate >= 0.75 (2-agent merge)",
                          lambda r: (r["best_reach_rate"] or 0) >= 0.75),
    "particle_s2_dual": ("best goal-reach rate >= 0.75 (antipodal, "
                         "dual buffer)",
                         lambda r: (r["best_reach_rate"] or 0) >= 0.75),
    "roadway_s1": ("best eval > 9.5 (save_threshold, "
                   "config_sumo_stage1.json:14)",
                   lambda r: (r["best_eval_global"] or -99) > 9.5),
    "roadway_s2": ("best min-over-agents eval > 9.5 (np.all threshold "
                   "form, train_offpolicy.py:391; scripted 2-car "
                   "baseline peaks at 9.25, _probe_roadway2_optimal.py)",
                   lambda r: (r["best_min_eval_local"] or -99) > 9.5),
    "roadway_s2_stable": ("best min-over-agents eval > 9.5 (same gate, "
                          "grad_clip=10 stabilized regime)",
                          lambda r: (r["best_min_eval_local"] or -99) > 9.5),
    "roadway_s2_retain": ("final-plateau min-over-agents eval > 8.1 "
                          "(last-10-period mean; scripted 2-car "
                          "baseline's mean of the same statistic, "
                          "_probe_roadway2_optimal; 9.5 is unreachable "
                          "as a mean — see PERF.md round-4 calibration)",
                          lambda r: (r.get("final10_min_eval_local")
                                     or -99) > 8.1),
    "roadway_s2_retain2": ("final-plateau min-over-agents eval > 8.1 "
                           "(same gate as retain; v2 recipe adds "
                           "bounded TD targets against the diagnosed "
                           "Q_credit divergence)",
                           lambda r: (r.get("final10_min_eval_local")
                                      or -99) > 8.1),
    "particle_s2_retain": ("final-plateau goal-reach rate >= 0.75 "
                           "(last-10-period mean)",
                           lambda r: (r.get("final10_reach_rate") or 0)
                           >= 0.75),
    "roadway_s2_retain3": ("final-plateau min-over-agents eval > 8.1 "
                           "(v3: + slow actor lr_actor=3e-5 against "
                           "the off-policy PG erosion)",
                           lambda r: (r.get("final10_min_eval_local")
                                      or -99) > 8.1),
    "roadway_s2_retain4": ("final-plateau min-over-agents eval > 8.1 "
                           "(v4: + batch advantage standardization "
                           "against the degraded-signal erosion)",
                           lambda r: (r.get("final10_min_eval_local")
                                      or -99) > 8.1),
    "roadway_s2_retain5": ("final-plateau min-over-agents eval > 8.1 "
                           "(v5: + actor lr anneal 1->0 over 40k "
                           "updates post-freeze — the finite-budget "
                           "endgame for the PG-direction erosion)",
                           lambda r: (r.get("final10_min_eval_local")
                                      or -99) > 8.1),
    "particle_s2_retain2": ("final-plateau goal-reach rate >= 0.75 "
                            "(last-10-period mean; v2: freeze + "
                            "reference epsilon + bounded targets)",
                            lambda r: (r.get("final10_reach_rate") or 0)
                            >= 0.75),
    "roadway_s2_retain6": ("final-plateau min-over-agents eval > 8.1 "
                           "(v6: + clipped importance-weighted PG "
                           "(pg_is_clip=1) — the actual off-policy "
                           "correction for the diagnosed PG-direction "
                           "erosion)",
                           lambda r: (r.get("final10_min_eval_local")
                                      or -99) > 8.1),
    "roadway_s2_retain7": ("final-plateau min-over-agents eval > 8.1 "
                           "(v7: v6 + entropy floor pg_ent_coef=0.01 "
                           "on the pure softmax — counters the "
                           "on-policy simplex-corner collapse that "
                           "remains once the IS weights return to ~1)",
                           lambda r: (r.get("final10_min_eval_local")
                                      or -99) > 8.1),
    "roadway_s2_retain8": ("final-plateau min-over-agents eval > 8.1 "
                           "(v8: v7 at pg_ent_coef=0.1 — the "
                           "raw-advantage-scale coefficient control)",
                           lambda r: (r.get("final10_min_eval_local")
                                      or -99) > 8.1),
    "particle_s2_cross_retain": ("final-plateau goal-reach rate >= 0.75 "
                                 "(last-10-period mean; v2 recipe on "
                                 "the 4-agent cross scenario)",
                                 lambda r: (r.get("final10_reach_rate")
                                            or 0) >= 0.75),
    "particle_s2_cross_retain2": ("final-plateau goal-reach rate >= 0.75 "
                                  "(last-10-period mean; cross v2: the "
                                  "retention recipe + entropy floor "
                                  "pg_ent_coef=0.01 against the "
                                  "post-mastery on-policy PG decay)",
                                  lambda r: (r.get("final10_reach_rate")
                                             or 0) >= 0.75),
    "particle_s2_merge_retain": ("final-plateau goal-reach rate >= 0.75 "
                                 "(last-10-period mean; v2 recipe on "
                                 "the 2-agent merge scenario)",
                                 lambda r: (r.get("final10_reach_rate")
                                            or 0) >= 0.75),
    "checkers_s2_V": ("best sum eval > 9.0 (CM3 with V(s,g) baseline "
                      "replacing Q_credit, use_V=1)",
                      lambda r: (r["best_eval_global"] or -99) > 9.0),
    "particle_s2_V": ("best goal-reach rate >= 0.5 (directional; CM3-V "
                      "ablation — the credit-vs-V ordering row carries "
                      "the claim)",
                      lambda r: (r["best_reach_rate"] or 0) >= 0.5),
    "particle_qmix": ("best_eval_global > -200 (sanity: learns toward "
                      "landmarks; reach ordering vs CM3 is the claim)",
                      lambda r: (r["best_eval_global"] or -999) > -200),
    "checkers_blend": ("best_eval_global > 2.0 (directional; blended "
                       "alpha-weighted local+global baseline, "
                       "alg_baseline.py:307-312)",
                       lambda r: (r["best_eval_global"] or -99) > 2.0),
    "checkers_s2_lrA": ("best sum eval > 9.0 (CM3, lr_actor=3e-4)",
                        lambda r: (r["best_eval_global"] or -99) > 9.0),
    "checkers_s2_lrA_ext": ("best sum eval > 9.0 (CM3, lr_actor=3e-4, "
                            "resumed to 100k total — informational 2x "
                            "budget; best is over the 50k-100k window)",
                            lambda r: (r["best_eval_global"] or -99)
                            > 9.0),
    "checkers_s2_lrB": ("best sum eval > 9.0 (CM3, lr_actor=5e-4)",
                        lambda r: (r["best_eval_global"] or -99) > 9.0),
    "checkers_s2_tn": ("best sum eval > 9.0 (CM3, trunc001 init)",
                       lambda r: (r["best_eval_global"] or -99) > 9.0),
    "checkers_s2_e1": ("best sum eval > 9.0 (CM3, n_envs=1 literal "
                       "pacing)",
                       lambda r: (r["best_eval_global"] or -99) > 9.0),
    "checkers_qmix_tn": ("best_eval_global > 2.0 (QMIX, trunc001 init)",
                         lambda r: (r["best_eval_global"] or -99) > 2.0),
    "checkers_qmix_tf1": ("best_eval_global > 2.0 (QMIX, exact-TF1 "
                          "b-bias init)",
                          lambda r: (r["best_eval_global"] or -99) > 2.0),
    "checkers_qmix_e1": ("best_eval_global > 2.0 (QMIX, n_envs=1 "
                         "literal pacing)",
                         lambda r: (r["best_eval_global"] or -99) > 2.0),
    "checkers_qmix": ("best_eval_global > 2.0 (directional, paper Fig. 3)",
                      lambda r: (r["best_eval_global"] or -99) > 2.0),
    "checkers_qmix_ref": ("best_eval_global > 2.0 (directional; the "
                          "reference's exact buggy target-mixer QMIX)",
                          lambda r: (r["best_eval_global"] or -99) > 2.0),
    "checkers_coma": ("best_eval_global > 2.0 (directional, paper Fig. 3)",
                      lambda r: (r["best_eval_global"] or -99) > 2.0),
    "checkers_iac": ("best_eval_global > 2.0 (directional, paper Fig. 3)",
                     lambda r: (r["best_eval_global"] or -99) > 2.0),
    "particle_coma": ("best_eval_global > -200 (sanity: learns toward "
                      "landmarks; reach ordering vs CM3 is the claim)",
                      lambda r: (r["best_eval_global"] or -999) > -200),
    "roadway_qmix": ("best_eval_global > 5.0 (directional; timeout-only "
                     "policies score <= -20)",
                     lambda r: (r["best_eval_global"] or -99) > 5.0),
}

# ranking statistic where no seed passes the gate (default:
# best_eval_global)
SCORE = {
    "particle_s1": lambda r: r["best_reach_rate"] or 0,
    "particle_s2": lambda r: r["best_reach_rate"] or 0,
    "particle_s2_cross": lambda r: r["best_reach_rate"] or 0,
    "particle_s2_merge": lambda r: r["best_reach_rate"] or 0,
    "particle_s2_dual": lambda r: r["best_reach_rate"] or 0,
    "particle_coma": lambda r: r["best_reach_rate"] or 0,
    "roadway_s2": lambda r: r["best_min_eval_local"] or -99,
    "roadway_s2_stable": lambda r: r["best_min_eval_local"] or -99,
    "roadway_s2_retain": lambda r: r.get("final10_min_eval_local") or -99,
    "roadway_s2_retain2": lambda r: r.get("final10_min_eval_local") or -99,
    "roadway_s2_retain3": lambda r: r.get("final10_min_eval_local") or -99,
    "roadway_s2_retain4": lambda r: r.get("final10_min_eval_local") or -99,
    "roadway_s2_retain5": lambda r: r.get("final10_min_eval_local") or -99,
    "particle_s2_retain": lambda r: r.get("final10_reach_rate") or 0,
    "particle_s2_retain2": lambda r: r.get("final10_reach_rate") or 0,
    "roadway_s2_retain6": lambda r: r.get("final10_min_eval_local") or -99,
    "roadway_s2_retain7": lambda r: r.get("final10_min_eval_local") or -99,
    "roadway_s2_retain8": lambda r: r.get("final10_min_eval_local") or -99,
    "particle_s2_cross_retain": lambda r: r.get("final10_reach_rate") or 0,
    "particle_s2_cross_retain2": lambda r: r.get("final10_reach_rate") or 0,
    "particle_s2_merge_retain": lambda r: r.get("final10_reach_rate") or 0,
    "particle_s2_V": lambda r: r["best_reach_rate"] or 0,
    "particle_qmix": lambda r: r["best_reach_rate"] or 0,
}

# (task, metric, [cells best-first]): passes iff each cell's best over
# seeds is >= the next one's; a tuple of cells is scored as one curve
ORDERING = [
    ("checkers (reference-parity QMIX)", "best_eval_global",
     ["checkers_s2", "checkers_qmix_ref", "checkers_coma",
      "checkers_iac"]),
    ("checkers (bug-FIXED QMIX, informational)", "best_eval_global",
     ["checkers_s2", "checkers_qmix", "checkers_coma", "checkers_iac"]),
    ("checkers (lr-tuned CM3, informational)", "best_eval_global",
     ["checkers_s2_lrA", "checkers_qmix", "checkers_coma",
      "checkers_iac"]),
    ("checkers (lr-tuned CM3 @ 2x budget, informational)",
     "best_eval_global",
     [("checkers_s2_lrA", "checkers_s2_lrA_ext"), "checkers_qmix",
      "checkers_coma", "checkers_iac"]),
    ("particle", "best_reach_rate", ["particle_s2", "particle_coma"]),
    ("roadway", "best_eval_global", ["roadway_s2", "roadway_qmix"]),
    ("checkers credit-vs-V (paper's core ablation)", "best_eval_global",
     ["checkers_s2", "checkers_s2_V"]),
    ("particle credit-vs-V (paper's core ablation)", "best_reach_rate",
     ["particle_s2", "particle_s2_V"]),
    ("particle CM3-vs-QMIX (informational)", "best_reach_rate",
     ["particle_s2", "particle_qmix"]),
    ("checkers CM3-vs-blended (informational)", "best_eval_global",
     ["checkers_s2", "checkers_blend"]),
]


def ordering_rows(by_cell):
    """-> list of (task, metric, [(cell, best, mean, n_seeds)], passed)
    over best-over-seeds per cell; cells with no runs are skipped (the
    gate needs every cell present to pass)."""
    out = []
    for task, metric, cells_ in ORDERING:
        vals = []
        for c in cells_:
            names = c if isinstance(c, tuple) else (c,)
            rows = [r for n in names for r in by_cell.get(n, [])]
            xs = [r.get(metric) for r in rows if r.get(metric) is not None]
            if xs:
                vals.append(("+".join(names), max(xs), sum(xs) / len(xs),
                             len(xs)))
        complete = len(vals) == len(cells_)
        passed = complete and all(vals[i][1] >= vals[i + 1][1]
                                  for i in range(len(vals) - 1))
        out.append((task, metric, vals, passed))
    return out



def _find_restore(dep_cell: str, dep_prefix: str):
    """The checkpoint directory a stage-2 cell restores when its
    stage-1 cell did not run in this invocation: the best-scoring
    gate-passing row of ``dep_cell`` in results.jsonl whose directory
    exists (the best-scoring such row otherwise), else the first saved
    directory starting with ``dep_prefix``, else None."""
    path = os.path.join(WORKDIR, "results.jsonl")
    saved = os.path.join(WORKDIR, "saved")
    if os.path.isfile(path):
        rows = [json.loads(l) for l in open(path)]
        cand = [r for r in rows if r.get("cell") == dep_cell
                and os.path.isdir(os.path.join(saved,
                                               r.get("dir_name", "")))]
        if cand:
            passed = [r for r in cand if r.get("passed")]
            score = SCORE.get(dep_cell,
                              lambda r: r.get("best_eval_global") or -99)
            return max(passed or cand, key=score)["dir_name"]
    if os.path.isdir(saved):
        for d in sorted(os.listdir(saved)):
            if d.startswith(dep_prefix):
                return d
    return None


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--episodes", type=int, default=50000)
    ap.add_argument("--seeds", type=int, default=3,
                    help="max seeds per cell (reference n_seeds=3, "
                    "config.json:39); stops at first gate pass")
    ap.add_argument("--base-seed", type=int, default=12341)
    ap.add_argument("--cells", default=None,
                    help="comma-separated subset of cells")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the runs (default cuda)")
    args = ap.parse_args(argv)

    os.makedirs(WORKDIR, exist_ok=True)
    todo = cells(args.episodes)
    names = [n for n in ORDER if n in todo]
    if args.cells:
        want = args.cells.split(",")
        names = [n for n in names if n in want]

    base_seed = args.base_seed
    winners = {}  # cell -> dir_name of its gate-passing (or best) seed
    for name in names:
        base = todo[name]
        dep = DEPS.get(name)
        best = None
        for i in range(max(args.seeds, 1)):
            seed = base_seed + i
            ov = dict(base, seed=seed,
                      dir_name=f"{base['dir_name']}_{seed}")
            if dep is not None:
                restore = winners.get(dep) or _find_restore(
                    dep, todo[dep]["dir_name"])
                if restore is None:
                    print(f"[{name}] SKIP: no {dep} checkpoint found",
                          flush=True)
                    break
                ov["dir_restore"] = restore
            print(f"[{name}] seed {seed} ...", flush=True)
            r = run_cell(name, ov, n_episodes=args.episodes,
                         device=args.device)
            desc, fn = GATES[name]
            r.update(seed=seed, dir_name=ov["dir_name"], gate=desc,
                     passed=bool(fn(r)))
            with open(os.path.join(WORKDIR, "results.jsonl"), "a") as f:
                f.write(json.dumps(r) + "\n")
            print(json.dumps(r), flush=True)
            score = SCORE.get(name,
                              lambda r: r["best_eval_global"] or -99)
            if best is None or score(r) > score(best):
                best = r
            if r["passed"] and name not in ALL_SEEDS:
                break
        if best is None:
            continue
        best["seeds_tried"] = best["seed"] - base_seed + 1
        winners[name] = best["dir_name"]
        _write_results_md()
    print(f"wrote {WORKDIR}/RESULTS.md")


def _write_results_md():
    """RESULTS.md anew from all of results.jsonl (rows of earlier
    invocations too)."""
    from torch_summarize_reproduce import write_results
    write_results(WORKDIR)


if __name__ == "__main__":
    main()
