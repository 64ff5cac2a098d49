"""CSV + stdout logging (``cm3_tpu.train.logging``, kept as the port's
own copy so that the port imports nothing of the JAX package).

Mirrors the reference's two CSV streams (``train_offpolicy.py:208-229,
385-426``): per-episode ``log.csv`` (episode, global and per-agent
returns) and per-period ``log_century.csv`` (averaged training returns,
greedy eval returns, duration), plus ``metrics.jsonl`` with each whole
period row.  The per-episode stream is SAMPLED under vectorization:
completed-episode returns land in a device-side ring
(``TrainConfig.episode_log`` rows, ``offpolicy.RolloutState.eplog``)
and are flushed into ``log.csv`` once per period via ``log_episodes``.
Given the same rows, the files are byte for byte the JAX package's
(``tests/test_torch_logging.py``).
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np


class CSVLogger:

    def __init__(self, log_dir: str, n_agents: int, extra_cols=(),
                 resume: bool = False):
        """``resume``: append to existing CSV streams instead of
        truncating (elastic auto-resume restarts mid-run; a fresh
        header-only rewrite would silently discard every previously
        logged period while the autosave keeps the episode count)."""
        self.dir = log_dir
        self.n_agents = n_agents
        os.makedirs(log_dir, exist_ok=True)
        self.century_path = os.path.join(log_dir, "log_century.csv")
        header = "Century,r_global_avg"
        for idx in range(n_agents):
            header += f",r_avg_{idx}"
        header += ",r_global_eval"
        for idx in range(n_agents):
            header += f",r_eval_{idx}"
        header += ",r_eval_local,epsilon"
        for c in extra_cols:
            header += f",{c}"
        header += ",duration (s)\n"
        if not (resume and os.path.exists(self.century_path)):
            with open(self.century_path, "w") as f:
                f.write(header)
        self.extra_cols = tuple(extra_cols)

    def log_period(self, row: Dict):
        self._log_jsonl(row)
        s = "%d,%.2f," % (row["episode"], row["r_train_global"])
        s += ",".join("{:.2f}".format(v) for v in row["r_train_local"])
        s += ",%.2f," % row["r_eval_global"]
        s += ",".join("{:.2f}".format(v) for v in row["r_eval_local"])
        s += ",%.2f,%.3f" % (float(np.sum(row["r_eval_local"])),
                             row["epsilon"])
        for c in self.extra_cols:
            s += ",%.5f" % row.get(c, float("nan"))
        s += ",%d\n" % int(row["duration_s"])
        with open(self.century_path, "a") as f:
            f.write(s)

    def log_episodes(self, ids, rets):
        """Sampled per-episode log.csv stream: ``ids`` [M] episode
        numbers, ``rets`` [M, N+1] = (r_local..., r_global).  Columns
        keep the reference's layout — Episode, r_global, then per-agent
        returns (header at train_offpolicy.py:209-212, rows at
        :419-420) — so tooling that parses the reference layout
        positionally reads this stream unchanged."""
        if ids is None or len(ids) == 0:
            return
        path = os.path.join(self.dir, "log.csv")
        if not os.path.exists(path):
            header = "Episode,r_global," + ",".join(
                f"r_{i}" for i in range(self.n_agents)) + "\n"
            with open(path, "w") as f:
                f.write(header)
        with open(path, "a") as f:
            for ep, r in zip(ids, rets):
                f.write("%d,%.3f," % (int(ep), r[-1])
                        + ",".join("%.3f" % v for v in r[:-1]) + "\n")

    def _log_jsonl(self, row: Dict):
        """Full row (losses, timings, ...) as one JSON line per period —
        the machine-readable stream replacing the reference's optional
        TF summaries (summarize=false by default, config.json:64)."""
        import json
        clean = {}
        for k, v in row.items():
            if k.startswith("_"):
                continue
            if isinstance(v, np.ndarray):
                clean[k] = [float(x) for x in v]
            elif isinstance(v, (int, float, str, bool)):
                clean[k] = v
            else:
                try:
                    clean[k] = float(v)
                except (TypeError, ValueError):
                    pass
        with open(os.path.join(self.dir, "metrics.jsonl"), "a") as f:
            f.write(json.dumps(clean) + "\n")


def stdout_log(row: Dict):
    print("ep %6d  eps %.3f  train %7.2f  eval %7.2f  (%ds)" % (
        row["episode"], row["epsilon"], row["r_train_global"],
        row["r_eval_global"], int(row["duration_s"])), flush=True)
