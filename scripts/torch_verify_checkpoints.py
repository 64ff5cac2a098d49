"""Check that every checkpoint of the port's reproduction restores and
still evaluates at its recorded level (the JAX package's
``scripts/verify_checkpoints.py``, ported; it reads the port's own
checkpoints under ``WORKDIR``, never JAX's).

  * for every (cell, seed) row of ``WORKDIR/results.jsonl`` whose
    ``saved/<dir_name>/model_final`` exists: rebuild the cell's state as
    the runner does, restore the checkpoint, and run a greedy evaluation
    of ``--n-eval`` episodes (default 100, ten times the training
    protocol's N_eval, so the statistic is less noisy);
  * the same for the latest ``model_good_*`` threshold snapshot, where
    there is one (saved on a 10-episode crossing, so its wide mean sits
    at the policy's plateau, below the crossing draw; ``GOOD_MARGIN``
    allows for that);
  * writes ``WORKDIR/checkpoint_verify.json`` with every restored
    evaluation beside the recorded one.

``--check`` then asserts:
  1. every checkpoint restores into the rebuilt state;
  2. every restored evaluation is finite;
  3. each ``model_final`` evaluation is within ``FINAL_TOL`` of the
     recorded final evaluation (one 10-episode draw; a corrupt or
     swapped checkpoint lands at a random policy's level, far outside);
  4. each ``model_good`` snapshot still clears its threshold less
     ``GOOD_MARGIN`` on the wide evaluation.

The evaluation draws come from ``prng.generator(prng.root_key(4242))``
on the run's device.

    python3 scripts/torch_verify_checkpoints.py [--check] [--n-eval 100]
        [--cells a,b] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

_HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(_HERE))
sys.path.insert(0, _HERE)

import numpy as np  # noqa: E402

from cm3_tpu_torch.core import prng  # noqa: E402
from cm3_tpu_torch.train import runner  # noqa: E402
from torch_reproduce_paper import WORKDIR, cells, host  # noqa: E402

# |restored - recorded| allowed for model_final, per experiment's reward
# scale: the recorded value is one 10-episode greedy evaluation, the
# restored one a mean over --n-eval episodes of other draws (JAX's bands)
FINAL_TOL = {"checkers": 8.0, "roadway": 12.0, "particle": 80.0}
# a model_good snapshot was saved on an upper-tail draw of a noisy
# statistic; its wide mean may sit this far below the threshold
GOOD_MARGIN = 2.0
EVAL_SEED = 4242


def _latest_good(save_dir):
    goods = [d for d in os.listdir(save_dir) if d.startswith("model_good_")]
    if not goods:
        return None
    return max(goods, key=lambda d: int(d.rsplit("_", 1)[1]))


def _build_and_restore(master, ckpt_dir, device="cuda"):
    """The cell's driver and its state restored from ``ckpt_dir``, built
    as the runner builds them; a checkpoint whose optimizer differs in
    ``grad_clip`` restores its parameters and targets into a fresh
    optimizer (``runner._restore_flexible``).  -> (driver, ts)."""
    driver = runner.build(master, device=device)[0]
    key = prng.root_key(master.get("seed", 12341))
    return driver, runner._restore_flexible(ckpt_dir, master, key, device)


def verify_rows(rows, n_eval=100, cells_filter=None, verbose=True,
                device="cuda"):
    """-> one report dict per checkpoint."""
    todo = cells(50000)
    saved_root = os.path.join(WORKDIR, "saved")
    # the latest row of each (cell, seed) wins (results.jsonl only grows)
    latest = {}
    for r in rows:
        if r.get("cell") in todo and r.get("dir_name"):
            latest[(r["cell"], r.get("seed"))] = r
    reports = []
    for (cell, seed), r in sorted(latest.items()):
        if cells_filter and cell not in cells_filter:
            continue
        save_dir = os.path.join(saved_root, r["dir_name"])
        if not os.path.isdir(os.path.join(save_dir, "model_final")):
            continue
        master = runner.cfgmod.load_json("master.json")
        master.update(todo[cell])
        master.update(seed=seed, dir_name=r["dir_name"])
        variants = [("model_final", r.get("final_eval_global"))]
        good = _latest_good(save_dir)
        if good:
            variants.append((good, None))
        for model_name, recorded in variants:
            ckpt = os.path.join(save_dir, model_name)
            rep = dict(cell=cell, seed=seed, dir_name=r["dir_name"],
                       model=model_name, recorded_final=recorded)
            try:
                driver, ts = _build_and_restore(master, ckpt, device)
                draws = prng.GeneratorDraws(prng.generator(
                    prng.root_key(EVAL_SEED), driver.hooks.env.device))
                r_loc, r_glob, aux = driver.evaluate(ts, draws, n_eval)
                r_loc, r_glob = host(r_loc), float(host(r_glob))
                rep.update(
                    restored=True,
                    eval_local=[round(float(v), 3) for v in r_loc],
                    eval_global=round(r_glob, 3),
                    min_eval_local=round(float(np.min(r_loc)), 3),
                    reach_rate=(round(float(host(aux["eval_reach_rate"])),
                                      3)
                                if "eval_reach_rate" in aux else None),
                    finite=bool(np.isfinite(r_glob)))
            except Exception as e:  # noqa: BLE001 — report, judge in check
                rep.update(restored=False, error=f"{type(e).__name__}: {e}")
            reports.append(rep)
            if verbose:
                print(json.dumps(rep), flush=True)
    return reports


def check(reports):
    """Assertions 1-4 (docstring).  Returns the list of failures."""
    fails = []
    for rep in reports:
        tag = f"{rep['cell']}/{rep['dir_name']}/{rep['model']}"
        if not rep.get("restored"):
            fails.append(f"{tag}: restore FAILED ({rep.get('error')})")
            continue
        if not rep.get("finite"):
            fails.append(f"{tag}: non-finite eval")
            continue
        exp = ("roadway" if rep["cell"].startswith("roadway") else
               "particle" if rep["cell"].startswith("particle") else
               "checkers")
        if rep["model"] == "model_final" and rep.get("recorded_final") \
                is not None:
            tol = FINAL_TOL[exp]
            diff = abs(rep["eval_global"] - rep["recorded_final"])
            if diff > tol:
                fails.append(f"{tag}: restored final eval "
                             f"{rep['eval_global']} vs recorded "
                             f"{rep['recorded_final']} (|diff| {diff:.1f} "
                             f"> tol {tol})")
        if rep["model"].startswith("model_good_"):
            # the snapshots' thresholds: Checkers stage 1's sum > 9.0;
            # roadway's save_threshold per agent (the minimum; stage 1
            # has one agent)
            if exp == "checkers":
                stat, thr = sum(rep["eval_local"]), 9.0
            else:
                stat, thr = rep["min_eval_local"], 9.5
            if stat < thr - GOOD_MARGIN:
                fails.append(f"{tag}: good-snapshot stat {stat:.2f} < "
                             f"{thr} - {GOOD_MARGIN}")
    return fails


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n-eval", type=int, default=100)
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--cells", default=None)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the evaluations (default cuda)")
    args = ap.parse_args(argv)

    path = os.path.join(WORKDIR, "results.jsonl")
    rows = [json.loads(l) for l in open(path)]
    reports = verify_rows(rows, n_eval=args.n_eval,
                          cells_filter=(set(args.cells.split(","))
                                        if args.cells else None),
                          device=args.device)
    out = os.path.join(WORKDIR, "checkpoint_verify.json")
    with open(out, "w") as f:
        json.dump({"n_eval": args.n_eval, "reports": reports}, f, indent=1)
    print(f"wrote {out} ({len(reports)} checkpoints)")
    if args.check:
        fails = check(reports)
        for fmsg in fails:
            print("FAIL:", fmsg)
        if fails:
            raise SystemExit(1)
        print(f"OK: all {len(reports)} checkpoints restore and evaluate "
              f"at recorded level")


if __name__ == "__main__":
    main()
