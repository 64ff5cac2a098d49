"""The reference's full training budget on the PyTorch port: Checkers
stage 1 -> stage 2, 50,000 episodes each at 256 envs (the JAX
package's ``scripts/_run_full_budget.py``, ported).  Writes under
runs/reproduce_torch/full_budget.

    python3 scripts/torch_run_full_budget.py [--device cpu]
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from cm3_tpu_torch.train import runner  # noqa: E402

cfgmod = runner.cfgmod
WORKDIR = "runs/reproduce_torch/full_budget"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device of the runs (default cuda)")
    args = ap.parse_args(argv)

    os.makedirs(WORKDIR, exist_ok=True)
    m = cfgmod.load_json("master.json")
    m.update(experiment="checkers", stage=1, dir_name="fb_s1", n_envs=256,
             N_train=50000, period=1000, N_eval=32, seed=12341)
    t0 = time.time()
    ts, stats = runner.train_function(m, workdir=WORKDIR, verbose=False,
                                      device=args.device)
    t1 = time.time()
    r1 = [float(row["r_eval_global"]) for row in stats["history"]]
    print(json.dumps({"stage1_minutes": round((t1 - t0) / 60, 2),
                      "stage1_final_eval": r1[-1], "stage1_best": max(r1)}))

    m.update(stage=2, dir_name="fb_s2", dir_restore="fb_s1",
             train_from_nothing=0, N_train=50000)
    t2 = time.time()
    ts, stats = runner.train_function(m, workdir=WORKDIR, verbose=False,
                                      device=args.device)
    t3 = time.time()
    r2 = [float(row["r_eval_global"]) for row in stats["history"]]
    print(json.dumps({"stage2_minutes": round((t3 - t2) / 60, 2),
                      "stage2_final_eval": r2[-1], "stage2_best": max(r2),
                      "stage2_curve": [round(v, 2) for v in r2]}))


if __name__ == "__main__":
    main()
