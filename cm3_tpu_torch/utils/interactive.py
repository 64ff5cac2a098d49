"""Interactive manual test harness (``cm3_tpu.utils.interactive``).

The reference ships a keyboard driver for the particle env
(``multiagent-particle-envs/test.py`` + ``bin/interactive.py``): print
state, read comma-separated action indices, step, render.  Same here for
all three envs on the port's engines, one instance, headless (the text
renderers of ``envs/render.py``).

Usage:
    python -m cm3_tpu_torch.utils.interactive --experiment checkers \\
        [--stage 2] [--seed 0] [--device cuda]

Actions: 0=stay/noop 1=up/-x/acc 2=down/+x/dec 3=left/-y 4=right/+y
"""

from __future__ import annotations

import argparse

import torch

from cm3_tpu_torch.core import config as cfgmod
from cm3_tpu_torch.core import prng
from cm3_tpu_torch.envs import render
from cm3_tpu_torch.envs.checkers import Checkers
from cm3_tpu_torch.envs.particle import Particle
from cm3_tpu_torch.envs.roadway import Roadway
from cm3_tpu_torch.train.experiments import make_hooks


def build_env(experiment: str, stage: int, device="cuda"):
    """The engine the harness steps: the stage's Checkers, particle
    ``stage1`` / ``stage2_merge`` or roadway."""
    if experiment == "checkers":
        return Checkers(cfgmod.checkers_env_config(stage), device=device)
    if experiment == "particle":
        name = "stage1" if stage == 1 else "stage2_merge"
        return Particle(cfgmod.particle_env_config(name), device=device)
    return Roadway(cfgmod.roadway_env_config(stage), device=device)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--experiment", default="checkers",
                   choices=["checkers", "particle", "roadway"])
    p.add_argument("--stage", type=int, default=2)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="torch device of the engine (default cuda)")
    args = p.parse_args(argv)

    env = build_env(args.experiment, args.stage, args.device)
    hooks = make_hooks(args.experiment, env)
    n = hooks.n_agents

    def reset(seed):
        draws = prng.GeneratorDraws(prng.generator(prng.root_key(seed),
                                                   env.device))
        return hooks.episode_init((1,), draws)

    state, ts, goals = reset(args.seed)
    print(f"{args.experiment} stage {args.stage}: {n} agents, goals=\n"
          f"{goals[0].cpu().numpy()}")

    def draw(state):
        host = render.host_state(state)
        if args.experiment == "checkers":
            print(render.render_checkers(host))
        elif args.experiment == "particle":
            print(render.render_particle(host))
        else:
            print(render.render_roadway(host, env.cfg))

    draw(state)
    t = 0
    while True:
        try:
            raw = input(f"[t={t}] actions for {n} agents "
                        "(comma-separated, q to quit): ").strip()
        except EOFError:
            break
        if raw.lower() in ("q", "quit", "exit"):
            break
        try:
            acts = [int(v) for v in raw.split(",")] if raw else [0] * n
            assert len(acts) == n
        except (ValueError, AssertionError):
            print(f"need {n} comma-separated ints in [0,4]")
            continue
        state, ts = env.step(state, torch.tensor([acts], device=env.device))
        t += 1
        draw(state)
        print("reward", ts.reward_local[0].cpu().numpy(), "done",
              bool(ts.done[0]))
        if bool(ts.done[0]):
            print("episode done — resetting")
            state, ts, goals = reset(args.seed + t)
            t = 0
            draw(state)


if __name__ == "__main__":
    main()
