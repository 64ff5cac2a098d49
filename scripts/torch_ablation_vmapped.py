"""Run cells of the paper's matrix with their seeds in lockstep (the JAX
package's ``scripts/ablation_vmapped.py``, ported).

The cells, gates and results ledger of ``torch_reproduce_paper.py``, but
all seeds of a cell train together in one program
(``runner.train_multiseed`` with ``vmapped_seeds``: the seed axis of
``train/multiseed.py``) instead of one after another.  Each seed's
statistics are taken from the period rows and appended to
``WORKDIR/results.jsonl`` in the row schema of
``torch_reproduce_paper.run_cell``, with ``vmapped`` true; then
``RESULTS.md`` is written anew.

    python3 scripts/torch_ablation_vmapped.py --cells checkers_s1 \\
        [--episodes N] [--seeds K] [--base-seed S] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

_HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(_HERE))
sys.path.insert(0, _HERE)

import numpy as np  # noqa: E402

from cm3_tpu_torch.train import runner  # noqa: E402
from torch_reproduce_paper import (DEPS, GATES, WORKDIR,  # noqa: E402
                                   _find_restore, cells, host)

cfgmod = runner.cfgmod


def _per_seed_stats(name, history, n_seeds, base_seed, minutes, dir_base):
    """history: period rows with per-seed arrays (``train_multiseed``'s)
    -> one results.jsonl row per seed, with ``run_cell``'s statistics;
    every leaf is read as a host array."""
    rows = []
    for i in range(n_seeds):
        glob = [float(host(r["r_eval_global"])[i]) for r in history]
        loc = [host(r["r_eval_local"])[i] for r in history]
        min_loc = [float(np.min(x)) for x in loc]
        reach = [float(host(r["eval_reach_rate"])[i])
                 for r in history if "eval_reach_rate" in r]
        t10 = lambda xs: (round(float(np.mean(xs[-10:])), 3) if xs
                          else None)
        seed = base_seed + i
        rows.append(dict(
            cell=name, minutes=minutes,
            episodes=int(host(history[-1]["episode"])[i])
            if history else 0,
            final_eval_global=round(glob[-1], 3) if glob else None,
            best_eval_global=round(max(glob), 3) if glob else None,
            final_eval_local=[round(float(v), 3) for v in loc[-1]]
            if loc else None,
            best_min_eval_local=round(max(min_loc), 3) if min_loc
            else None,
            final10_min_eval_local=t10(min_loc),
            best_reach_rate=round(max(reach), 3) if reach else None,
            final_reach_rate=round(reach[-1], 3) if reach else None,
            final10_reach_rate=t10(reach),
            seed=seed, dir_name=f"{dir_base}_{seed}", vmapped=True))
    return rows


def run_cell_vmapped(name, overrides, n_episodes, n_seeds, base_seed,
                     device="cuda"):
    """``n_seeds`` seeds of cell ``name`` in lockstep, saved and logged
    under ``<dir_name>_<seed>``; -> one row per seed.  The cell holds an
    exclusive lock, ``saved/<dir_name>_vmapped/.cell_lock``, while it
    runs: two runs of one cell would interleave the per-seed logs and
    share one autosave of the stack."""
    m = cfgmod.load_json("master.json")
    m.update(overrides)
    m.update(vmapped_seeds=True, n_seeds=n_seeds, seed=base_seed,
             dir_idx_start=base_seed)
    lock_dir = os.path.join(WORKDIR, "saved", f"{overrides['dir_name']}"
                            f"_vmapped")
    os.makedirs(lock_dir, exist_ok=True)
    lock = os.path.join(lock_dir, ".cell_lock")
    try:
        fd = os.open(lock, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
        os.write(fd, str(os.getpid()).encode())
        os.close(fd)
    except FileExistsError:
        raise SystemExit(
            f"[{name}] LOCKED: another run holds {lock} (pid "
            f"{open(lock).read()}); refusing a concurrent duplicate")
    try:
        t0 = time.time()
        ts, history = runner.train_multiseed(m, workdir=WORKDIR,
                                             n_episodes=n_episodes,
                                             device=device)
        minutes = round((time.time() - t0) / 60, 2)
    finally:
        os.unlink(lock)
    return _per_seed_stats(name, history, n_seeds, base_seed, minutes,
                           overrides["dir_name"])


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--episodes", type=int, default=50000)
    ap.add_argument("--seeds", type=int, default=3)
    ap.add_argument("--base-seed", type=int, default=12341)
    ap.add_argument("--cells", required=True)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the runs (default cuda)")
    args = ap.parse_args(argv)

    os.makedirs(WORKDIR, exist_ok=True)
    todo = cells(args.episodes)
    for name in args.cells.split(","):
        base = dict(todo[name])
        dep = DEPS.get(name)
        if dep is not None:
            restore = _find_restore(dep, todo[dep]["dir_name"])
            if restore is None:
                print(f"[{name}] SKIP: no {dep} checkpoint found",
                      flush=True)
                continue
            base["dir_restore"] = restore
        print(f"[{name}] {args.seeds} seeds vmapped ...", flush=True)
        rows = run_cell_vmapped(name, base, args.episodes, args.seeds,
                                args.base_seed, device=args.device)
        desc, fn = GATES[name]
        with open(os.path.join(WORKDIR, "results.jsonl"), "a") as f:
            for r in rows:
                r.update(gate=desc, passed=bool(fn(r)))
                f.write(json.dumps(r) + "\n")
                print(json.dumps(r), flush=True)
        from torch_summarize_reproduce import write_results
        write_results(WORKDIR)


if __name__ == "__main__":
    main()
