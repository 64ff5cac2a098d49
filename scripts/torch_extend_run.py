"""Write a resume ``model_autosave`` from a finished seed's
``model_final``, so that a cell of the port's reproduction can be run
on to a larger budget (the JAX package's ``scripts/extend_run.py``,
ported).

Seeds in lockstep keep one autosave of the stack per cell
(``saved/<dir_name>_vmapped``), so after such a sweep no seed has an
autosave of its own; each has its ``saved/<dir_name>_<seed>/
model_final``.  This writes the one-seed autosave ``train_function``
resumes from, ``{"ts": state, "episodes": n}`` in the port's checkpoint
format, beside it.  ``torch_reproduce_paper.py`` then continues the run
with ``auto_resume`` (``checkers_s2_lrA_ext`` also sets
``require_resume``) to a larger ``--episodes`` total: the driver
resumes the episode count and epsilon, and its replay restarts empty
and is warmed with policy rollouts.

    python3 scripts/torch_extend_run.py --cell checkers_s2_lrA \\
        --seed 12343 --episodes-done 50000 [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import sys

_HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(_HERE))
sys.path.insert(0, _HERE)

from cm3_tpu_torch.train import checkpoint, runner  # noqa: E402
from torch_reproduce_paper import WORKDIR, cells  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--episodes-done", type=int, required=True,
                    help="episode count the final checkpoint represents "
                    "(the finished run's --episodes)")
    ap.add_argument("--device", default="cuda",
                    help="torch device the state is built on (default "
                    "cuda)")
    args = ap.parse_args(argv)

    base = cells(50000)[args.cell]
    m = runner.cfgmod.load_json("master.json")
    m.update(base, seed=args.seed,
             dir_name=f"{base['dir_name']}_{args.seed}")
    save_dir = os.path.join(WORKDIR, "saved", m["dir_name"])
    final = os.path.join(save_dir, "model_final")
    if not checkpoint.exists(final):
        raise SystemExit(f"no final checkpoint at {final}")
    # a state of the cell's own networks and optimizer to restore into
    alg = runner.build(m, device=args.device)[1]
    ts = checkpoint.restore(final, alg.empty_state())
    out = os.path.join(save_dir, "model_autosave")
    checkpoint.save(out, {"ts": ts, "episodes": args.episodes_done})
    print(f"wrote {out} (episodes={args.episodes_done})")


if __name__ == "__main__":
    main()
