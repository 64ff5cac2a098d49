"""Probe: the return and goal-reach rate of a scripted greedy policy on
particle stage 1, on the port's particle engine (the JAX package's
``scripts/_probe_particle.py``, ported).  Calibrates the learning gate
of ``torch_reproduce_paper.py`` (``particle_s1``: reach rate >= 0.9) and
the no-op baseline of ``particle_coma``'s.

    python3 scripts/torch_probe_particle.py [--device cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from cm3_tpu_torch.core import config as cfgmod  # noqa: E402
from cm3_tpu_torch.core import prng  # noqa: E402
from cm3_tpu_torch.core.tree import tree_map  # noqa: E402
from cm3_tpu_torch.envs.particle import Particle  # noqa: E402

N_EPISODES = 512


def make_env(device="cuda"):
    m = cfgmod.load_json("master.json")
    pc = cfgmod.particle_env_config("stage1",
                                    prob_random=float(m["prob_random"]),
                                    max_steps=int(m["max_steps"]))
    return Particle(pc, device=device)


def greedy_policy(state, brake=True):
    """Move along the axis of the larger |delta| to the landmark; brake
    (reverse) when the speed would overshoot the rest within ~3 steps.
    -> [E, 1] actions (x: +1 -> 2, -1 -> 1; y: +1 -> 4, -1 -> 3)."""
    tgt = (state.landmarks - state.pos)[:, 0]            # [E, 2]
    ax = torch.argmax(torch.abs(tgt), dim=-1)            # [E]
    err = torch.gather(tgt, 1, ax[:, None])[:, 0]
    vel_ax = torch.gather(state.vel[:, 0], 1, ax[:, None])[:, 0]
    want = torch.where(err > 0, 1.0, -1.0)
    if brake:
        overshoot = torch.abs(vel_ax) * 0.3 > torch.abs(err)
        want = torch.where(overshoot, -torch.sign(vel_ax), want)
    act_x = torch.where(want > 0, 2, 1)
    act_y = torch.where(want > 0, 4, 3)
    return torch.where(ax == 0, act_x, act_y)[:, None]


def rollout(env, d, policy=None):
    """Episodes from the reset draws ``d`` under ``policy``, each state
    frozen once its episode is done, or under the no-op policy when
    ``policy`` is None, whose states run on (as JAX's probe runs both);
    the return counts until the episode is done.  -> (return [E], every
    agent reached [E], steps [E])."""
    state, _ = env.reset(d)
    e = state.steps.shape[0]
    ret = torch.zeros(e, device=env.device)
    done = torch.zeros(e, dtype=torch.bool, device=env.device)
    for _ in range(env.cfg.max_steps):
        a = (torch.zeros((e, 1), dtype=torch.int64, device=env.device)
             if policy is None else policy(state))
        ns, ts = env.step(state, a)
        ret = ret + torch.where(done, 0.0, ts.reward)
        if policy is not None:
            state = tree_map(lambda n, o: torch.where(
                done.view((-1,) + (1,) * (n.dim() - 1)), o, n), ns, state)
        else:
            state = ns
        done = done | ts.done
    return ret, state.reached.all(dim=-1), state.steps


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device of the engine (default cuda)")
    args = ap.parse_args(argv)
    env = make_env(args.device)
    draws = prng.GeneratorDraws(prng.generator(prng.root_key(0),
                                               env.device))
    d = env.draw_reset((N_EPISODES,), draws)
    rets, reach, steps = rollout(env, d, greedy_policy)
    print("scripted greedy: mean return", float(rets.mean()),
          "reach rate", float(reach.float().mean()),
          "mean steps", float(steps.float().mean()))
    rets0, _, _ = rollout(env, d)
    print("noop: mean return", float(rets0.mean()))


if __name__ == "__main__":
    main()
