"""Probe: the best stage-1 Checkers return under the reference's rules
(3x8 board, 33 steps, +1 own colour / -0.5 other / -0.1 invalid), on
the port's grid engine (the JAX package's
``scripts/_probe_checkers_optimal.py``, ported).

Calibrates the solved gate (sum eval > 9.0): a full-board sweep scores
exactly +6.0 (12 greens - 12 x 0.5 oranges), the local optimum
vectorized training tends to find, while routes that revisit cleared
cells score more.  ``sweep_return`` drives the serpentine sweep through
the engine; ``beam_search`` keeps the ``beam`` best returns of every
expansion by the 5 actions.

    python3 scripts/torch_probe_checkers_optimal.py [--device cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from cm3_tpu_torch.core.config import CheckersEnvConfig  # noqa: E402
from cm3_tpu_torch.core.tree import tree_map  # noqa: E402
from cm3_tpu_torch.envs.checkers import Checkers  # noqa: E402

BEAM = 4096
STEPS = 33
# stay / up / down / left / right; the agent starts right of row 0
LEFT, DOWN, RIGHT = 3, 2, 4
SWEEP = [LEFT] * 8 + [DOWN] + [RIGHT] * 7 + [DOWN] + [LEFT] * 7


def make_env(device="cuda"):
    env = Checkers(CheckersEnvConfig(n_agents=1, agents_r=(0,),
                                     agents_c=(8,), max_steps=STEPS),
                   device=device)
    goals = torch.tensor([[[1.0, 0.0]]], device=env.device)  # green
    return env, goals


def sweep_return(device="cuda"):
    """The return of the serpentine sweep over all 24 cells."""
    env, goals = make_env(device)
    state, _ = env.reset(goals)
    ret = 0.0
    for a in SWEEP:
        state, ts = env.step(state, torch.tensor([[a]], device=env.device))
        ret += float(ts.reward[0])
        if bool(ts.done[0]):
            break
    return ret


def beam_search(beam=BEAM, device="cuda"):
    """-> the returns of the final beam, best first, as float64."""
    env, goals = make_env(device)
    state, _ = env.reset(goals)
    rets = np.zeros(1)
    for _ in range(STEPS):
        b = rets.shape[0]
        rep = tree_map(lambda x: torch.repeat_interleave(x, 5, dim=0), state)
        acts = torch.arange(5, device=env.device).repeat(b)[:, None]
        new_state, ts = env.step(rep, acts)
        new_rets = np.repeat(rets, 5) + ts.reward.cpu().numpy()
        # keep the top `beam` by return (ties broken as argsort breaks them)
        order = np.argsort(-new_rets)[:beam]
        rets = new_rets[order]
        idx = torch.as_tensor(order, device=env.device)
        state = tree_map(lambda x: x[idx], new_state)
    return rets


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device of the engine (default cuda)")
    args = ap.parse_args(argv)
    print("full-board sweep return:", sweep_return(args.device))
    rets = beam_search(BEAM, args.device)
    print(f"beam-search best return over {STEPS} steps:", float(rets.max()))
    print("top-5:", [round(float(v), 2) for v in rets[:5]])


if __name__ == "__main__":
    main()
