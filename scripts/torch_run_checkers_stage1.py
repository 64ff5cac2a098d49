"""Checkers stage-1 CM3 training at full size to the reference's solved
gate (sum eval local reward > 9.0, train_offpolicy.py:397-398), on the
PyTorch port (the JAX package's ``scripts/run_checkers_stage1.py``,
ported).

Run: python3 scripts/torch_run_checkers_stage1.py [--episodes 50000]
         [--device cpu]
Writes the CSV logs and checkpoints under runs/reproduce_torch/ and
resumes from its autosave there.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from cm3_tpu_torch.train import runner  # noqa: E402

WORKDIR = "runs/reproduce_torch"


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--episodes", type=int, default=50000)
    p.add_argument("--device", default="cuda",
                   help="torch device of the run (default cuda)")
    p.add_argument("--n-envs", type=int, default=16)
    p.add_argument("--dir", default="checkers_s1")
    p.add_argument("--seed", type=int, default=12341)
    p.add_argument("--stage", type=int, default=1)
    p.add_argument("--restore", default=None)
    args = p.parse_args(argv)

    m = runner.cfgmod.load_json("master.json")
    m.update(experiment="checkers", stage=args.stage, dir_name=args.dir,
             seed=args.seed, n_envs=args.n_envs, period=200, N_eval=10,
             auto_resume=1, N_train=args.episodes)
    if args.restore:
        m.update(train_from_nothing=0, dir_restore=args.restore,
                 model_name="model_final")
    ts, stats = runner.train_function(m, workdir=WORKDIR,
                                      n_episodes=args.episodes, verbose=True,
                                      device=args.device)
    best = max((float(sum(r["r_eval_local"])) for r in stats["history"]),
               default=float("nan"))
    print(f"DONE episodes={stats['episodes']} best_sum_eval={best:.2f}")


if __name__ == "__main__":
    main()
