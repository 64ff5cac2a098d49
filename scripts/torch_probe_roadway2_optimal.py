"""Probe: the per-agent return ceiling of the two-car roadway stage-2
task, on the port's roadway engine (the JAX package's
``scripts/_probe_roadway2_optimal.py``, ported).

Drives both cars with a scripted controller (a sublane step toward the
goal lane's centre when misaligned, else accelerate; every action
through the same ``check_actions`` feasibility filter training uses)
over many episodes and reports the distribution of the
min-over-agents episode returns.  Calibrates the stage-2 gates of
``torch_reproduce_paper.py``: the reference's literal snapshot
condition ``np.all(r_local_eval > 18)`` (config_sumo_stage2.json:14)
cannot be met (a car's maximum is ~10), and the staggered second
departure and the goal-lane draws cost shaping reward, so the
two-car ceiling per agent sits below stage 1's 10.

    python3 scripts/torch_probe_roadway2_optimal.py [--device cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from cm3_tpu_torch.core import config as cfgmod  # noqa: E402
from cm3_tpu_torch.core import prng  # noqa: E402
from cm3_tpu_torch.envs.roadway import ACC, LEFT, RIGHT, Roadway  # noqa: E402
from cm3_tpu_torch.train.experiments import make_hooks  # noqa: E402

N_EPISODES = 512


def scripted(state, c):
    goal_sub = (state.goal_lane * c.sublanes_per_lane
                + c.sublanes_per_lane // 2)
    delta = goal_sub - state.sublane
    return torch.where(delta > 0, LEFT,
                       torch.where(delta < 0, RIGHT, ACC))


def rollout(hooks, draws, n):
    """``n`` episodes of the scripted controller -> per-agent returns
    [n, N], each counted until its episode is done."""
    env = hooks.env
    c = env.cfg
    state, _, _ = hooks.episode_init(n, draws)
    ret = torch.zeros((n, hooks.n_agents), device=env.device)
    done = torch.zeros(n, dtype=torch.bool, device=env.device)
    for _ in range(c.max_step):
        a = env.check_actions(state, scripted(state, c))
        state, ts = env.step(state, a)
        ret = ret + torch.where(done[:, None], 0.0, ts.reward_local)
        done = done | ts.done
    return ret


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device of the engine (default cuda)")
    args = ap.parse_args(argv)
    env = Roadway(cfgmod.roadway_env_config(2), device=args.device)
    hooks = make_hooks("roadway", env)
    n = hooks.n_agents
    draws = prng.GeneratorDraws(prng.generator(prng.root_key(0),
                                               env.device))
    rets = rollout(hooks, draws, N_EPISODES).cpu().numpy()   # [512, N]
    mins = rets.min(axis=1)
    print("scripted 2-car: mean per-agent", rets.mean(0).round(2),
          "mean min", mins.mean().round(3),
          "p90 min", np.percentile(mins, 90).round(3),
          "max min", mins.max().round(3))
    # the gate's statistic: the mean over 10-episode blocks of the
    # per-agent mean, min over agents
    blocks = rets[:510].reshape(51, 10, n).mean(axis=1).min(axis=1)
    print("10-episode-eval min-over-agents: mean", blocks.mean().round(3),
          "best of", len(blocks), "blocks:", blocks.max().round(3))


if __name__ == "__main__":
    main()
