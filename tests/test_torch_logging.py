"""The port's CSV and JSONL logs against the JAX package's: the same
period and episode rows through ``cm3_tpu.train.logging.CSVLogger`` and
``cm3_tpu_torch.train.logging.CSVLogger`` give byte-identical
``log_century.csv``, ``log.csv`` and ``metrics.jsonl``, also when a
second logger appends to them (``resume=True``) and with extra columns;
``stdout_log`` prints the same line."""

import os

import numpy as np
import pytest

from cm3_tpu.train import logging as jlog
from cm3_tpu_torch.train import logging as tlog


def _rows(n_agents, start, count, rng):
    """Period rows as the drivers make them: numpy float32 arrays, host
    floats and ints, numpy scalars (the seed-stacked rows' slices), an
    eval metric, a string and a bool; and each period's episode rows."""
    rows = []
    for i in range(count):
        ep = start + 100 * (i + 1)
        r_eval = rng.normal(size=n_agents).astype(np.float32) * 3
        row = {
            "episode": np.int64(ep) if i % 2 else ep,
            "epsilon": float(np.float32(0.5 - 0.001 * i)),
            "r_eval_local": r_eval,
            "r_eval_global": float(r_eval.sum()),
            "eval_action_dist": rng.random(5 * n_agents).astype(np.float32),
            "r_train_local": rng.normal(size=n_agents).astype(np.float32),
            "r_train_global": np.float32(rng.normal()) if i % 2 else
            float(rng.normal()),
            "duration_s": float(rng.random() * 50),
            "loss_Q_global": np.float32(rng.random()),
            "policy_loss": float(rng.normal()),
            "reach_rate": np.float64(rng.random()),
            "note": "period",
            "flag": bool(i % 2),
            "_ts": object(),
        }
        ids = np.arange(ep - 99, ep + 1, 7, dtype=np.int64)
        rets = rng.normal(size=(len(ids), n_agents + 1)).astype(np.float32)
        rows.append((row, (ids, rets)))
    return rows


def _write(mod, log_dir, rows, n_agents, resume, extra):
    logger = mod.CSVLogger(log_dir, n_agents, extra_cols=extra,
                           resume=resume)
    for row, eps in rows:
        logger.log_episodes(*eps)
        logger.log_period(dict(row))
    logger.log_episodes(None, None)


@pytest.mark.parametrize("n_agents", [1, 2])
@pytest.mark.parametrize("extra", [(), ("loss_Q_global", "missing")])
def test_streams_are_byte_identical(tmp_path, n_agents, extra):
    rng = np.random.default_rng(n_agents)
    first = _rows(n_agents, 0, 3, rng)
    second = _rows(n_agents, 300, 2, rng)
    out = {}
    for name, mod in (("jax", jlog), ("torch", tlog)):
        d = os.path.join(str(tmp_path), name)
        _write(mod, d, first, n_agents, False, extra)
        # an elastic restart appends to the streams
        _write(mod, d, second, n_agents, True, extra)
        out[name] = {f: open(os.path.join(d, f), "rb").read()
                     for f in sorted(os.listdir(d))}
    assert sorted(out["torch"]) == ["log.csv", "log_century.csv",
                                    "metrics.jsonl"]
    assert out["torch"] == out["jax"]
    century = out["torch"]["log_century.csv"].decode().splitlines()
    assert len(century) == 1 + 3 + 2


def test_fresh_logger_truncates_as_jax(tmp_path):
    """Without ``resume`` a new logger starts ``log_century.csv`` over
    (its header only), as the JAX one does."""
    rng = np.random.default_rng(0)
    rows = _rows(2, 0, 2, rng)
    got = {}
    for name, mod in (("jax", jlog), ("torch", tlog)):
        d = os.path.join(str(tmp_path), name)
        _write(mod, d, rows, 2, False, ())
        mod.CSVLogger(d, 2)
        got[name] = open(os.path.join(d, "log_century.csv"), "rb").read()
    assert got["torch"] == got["jax"]
    assert got["torch"].count(b"\n") == 1


def test_stdout_line_is_jax_s(capsys):
    rng = np.random.default_rng(1)
    for row, _ in _rows(2, 0, 2, rng):
        jlog.stdout_log(row)
        want = capsys.readouterr().out
        tlog.stdout_log(row)
        assert capsys.readouterr().out == want
