"""The program's spans (``cm3_tpu_torch.utils.profiling``) on the CPU:
nesting, self time and the record's reset, a span with recording off,
the spans of one Checkers chunk under the profiler, the span names, the
record written beside a trace, and the bounded pool of CUDA events."""

import ast
import json
import os

import pytest
import torch

import cm3_tpu_torch
from cm3_tpu_torch.algs.cm3 import CM3
from cm3_tpu_torch.core import config, prng
from cm3_tpu_torch.envs.checkers import Checkers
from cm3_tpu_torch.train.experiments import make_hooks
from cm3_tpu_torch.train.offpolicy import OffPolicyDriver, init_rollout
from cm3_tpu_torch.utils import profiling

SMALL = config.NNConfig(Q_conv_f=2, Q_n_h1_1=8, Q_n_h1_2=4, Q_n_h2=8,
                        A_conv_f=2, A_n_h1=8, A_n_h2=8)
STEPS, UPDATES = 10, 3


def _nested():
    with profiling.annotate("cm3.outer"):
        with profiling.annotate("cm3.inner"):
            torch.ones(8).sum()
        with profiling.annotate("cm3.inner"):
            pass


def _nesting_self_time_and_reset():
    with profiling.record():
        _nested()
    rec = profiling.summary()
    assert set(rec) == {"cm3.outer", "cm3.outer/cm3.inner"}
    outer, inner = rec["cm3.outer"], rec["cm3.outer/cm3.inner"]
    assert (outer["count"], inner["count"]) == (1, 2)
    assert inner["self_s"] == pytest.approx(inner["host_s"])
    assert outer["self_s"] == pytest.approx(outer["host_s"]
                                            - inner["host_s"])
    assert 0 <= outer["self_s"] <= outer["host_s"]
    assert outer["stream_s"] is None            # no CUDA on the CPU
    # a second block starts afresh
    with profiling.record():
        with profiling.annotate("cm3.other"):
            pass
    assert set(profiling.summary()) == {"cm3.other"}
    # spans run off, then a profiler started by other code: afresh
    _nested()
    with torch.profiler.profile():
        with profiling.annotate("cm3.again"):
            pass
    assert set(profiling.summary()) == {"cm3.again"}


def _off_records_nothing(monkeypatch):
    with profiling.record():
        pass
    entered = []
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: entered.append(name))
    _nested()
    assert entered == [] and profiling.summary() == {}


def _chunk_under_the_profiler():
    env = Checkers(config.checkers_env_config(2, max_steps=6), device="cpu")
    alg = CM3("checkers", env.spec(), config.AlgConfig(n_agents=2, stage=2),
              SMALL, device="cpu", n_seeds=2)
    cfg = config.TrainConfig(n_envs=4, batch_size=8, buffer_size=256,
                             steps_per_train=STEPS,
                             updates_per_chunk=UPDATES)
    driver = OffPolicyDriver(make_hooks("checkers", env), alg, cfg)
    draws = prng.GeneratorDraws(prng.generator(3, "cpu"))
    rs = init_rollout(driver.hooks, cfg.n_envs, draws, n_seeds=2)
    ts = alg.init_state([prng.root_key(1), prng.root_key(2)])
    buf = driver._replay_init(driver.example_transition(rs))
    ts, buf, rs, _ = driver._chunk(ts, buf, rs, 1.0, draws, False, True)
    with torch.profiler.profile():
        driver._chunk(ts, buf, rs, 0.2, draws, True, False)
    rec = profiling.summary()
    count = lambda path: rec[path]["count"]
    step, upd = "cm3.chunk/cm3.env_step", "cm3.chunk/cm3.update"
    assert count("cm3.chunk") == 1
    assert count(step) == STEPS
    assert count(step + "/cm3.replay") == STEPS
    assert count(upd) == UPDATES
    assert count(upd + "/cm3.critics/cm3.backward") == UPDATES
    assert count(upd + "/cm3.actor/cm3.backward") == UPDATES
    assert count("cm3.chunk/cm3.replay_sample") == UPDATES
    backward = sum(v["count"] for p, v in rec.items()
                   if p.startswith(upd) and p.endswith("/cm3.backward"))
    assert backward == 2 * UPDATES
    # children's host time within their parent's
    for path, v in rec.items():
        kids = [c for c in rec if c.rsplit("/", 1)[0] == path and c != path]
        assert sum(rec[c]["host_s"] for c in kids) <= v["host_s"] + 1e-9
        assert v["self_s"] >= -1e-9
    return rec


def _span_names():
    """Every name passed to ``annotate`` or ``spanned`` in the package,
    and every part of a chunk's span paths, starts with ``cm3.``."""
    root = os.path.dirname(cm3_tpu_torch.__file__)
    names = []
    for d, _, files in os.walk(root):
        for f in files:
            if not f.endswith(".py"):
                continue
            tree = ast.parse(open(os.path.join(d, f)).read())
            for node in ast.walk(tree):
                if (isinstance(node, ast.Call)
                        and getattr(node.func, "attr", None)
                        in ("annotate", "spanned")):
                    arg = node.args[0]
                    assert isinstance(arg, ast.Constant), (f, node.lineno)
                    names.append(arg.value)
    assert len(set(names)) >= 16
    parts = {p for path in _chunk_under_the_profiler()
             for p in path.split("/")}
    assert all(n.startswith("cm3.") for n in set(names) | parts)


class _FakeEvent:
    """A CUDA event on the CPU: completes when ``done`` says so and
    times a millisecond."""

    done = True

    def record(self, stream=None):
        pass

    def query(self):
        return _FakeEvent.done

    def elapsed_time(self, end):
        return 1.0


def _event_pool_bounded(monkeypatch):
    """Spans with stream time (inside ``record()``) hold at most twice
    ``_PENDING_MAX`` event pairs, reading the completed ones without a
    wait and all of them after one synchronise once the card is that far
    behind; a profiler started by other code records no events."""
    syncs = []
    monkeypatch.setattr(profiling, "_PENDING_MAX", 8)
    monkeypatch.setattr(torch.cuda, "Event", lambda **kw: _FakeEvent())
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda: None)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: syncs.append(1))
    rec = profiling._RECORD
    for done, n_syncs in ((True, 0), (False, 6)):
        _FakeEvent.done = done
        syncs.clear()
        with profiling.record():
            for _ in range(50):
                with profiling.annotate("cm3.outer"):
                    with profiling.annotate("cm3.inner"):
                        pass
                assert len(rec.pending) < 2 * 8
                assert len(rec.free) + 2 * len(rec.pending) <= 4 * 8 + 4
        assert len(syncs) == n_syncs
        spans = profiling.summary()
        assert spans["cm3.outer/cm3.inner"]["stream_s"] == pytest.approx(
            50 * 1e-3)
        assert rec.pending == []
    with torch.profiler.profile():
        with profiling.annotate("cm3.outer"):
            assert rec.pending == [] and rec.top.start is None
    assert profiling.summary()["cm3.outer"]["stream_s"] is None


def _trace_writes_spans(tmp_path):
    with profiling.trace(str(tmp_path)):
        _nested()
    with open(tmp_path / "spans.json") as f:
        spans = json.load(f)
    assert spans["cm3.outer/cm3.inner"]["count"] == 2
    assert os.path.exists(tmp_path / "trace.json")


@pytest.mark.parametrize("item", ["nesting_self_time_reset", "off",
                                  "chunk", "names", "spans_json",
                                  "event_pool"])
def test_program_spans(item, monkeypatch, tmp_path):
    if item == "nesting_self_time_reset":
        _nesting_self_time_and_reset()
    elif item == "off":
        _off_records_nothing(monkeypatch)
    elif item == "chunk":
        _chunk_under_the_profiler()
    elif item == "names":
        _span_names()
    elif item == "spans_json":
        _trace_writes_spans(tmp_path)
    else:
        _event_pool_bounded(monkeypatch)
