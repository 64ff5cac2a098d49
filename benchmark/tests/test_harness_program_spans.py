"""The program's own ``cm3.*`` spans beside the benchmark's: the trace's
reduction still gives an operation launched inside a nested program
span to the enclosing ``chunk``, ``env_step`` or ``update`` span;
``host_syncs_per_chunk`` reads a hand-made record and gives None on an
empty one and where the program keeps none; a traced sweep at a tiny
size on the CPU counts the benchmark's spans in the program's
record."""

import json
import time
import types

import pytest

from benchmark import harness
from benchmark.run import merged_config

SPAN_NAMES = ("chunk", "env_step", "update")


def _span(name, t0, t1):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": t0,
            "dur": t1 - t0}


def _launched(corr, t_launch, t_run):
    return [{"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
             "ts": t_launch, "dur": 1, "args": {"correlation": corr}},
            {"ph": "X", "cat": "kernel", "name": f"k{corr}", "ts": t_run,
             "dur": 5, "args": {"correlation": corr}}]


@pytest.mark.parametrize("where,expected", [
    ("env_step", "env_step"), ("update", "update"), ("chunk", "chunk")])
def test_nested_program_spans_leave_the_attribution(tmp_path, where,
                                                    expected):
    """A chunk [0, 1000] holding the program's ``cm3.chunk``; an env step
    [100, 300] inside the program's ``cm3.env_step`` with ``cm3.replay``
    [150, 250] in it; the program's ``cm3.replay_sample`` [400, 450]
    (in no benchmark span but the chunk); the program's ``cm3.update``
    [500, 900] around the benchmark's ``update`` [510, 890] around
    ``cm3.critics`` and ``cm3.backward`` [600, 700]."""
    events = [_span("window", 0, 2000), _span("chunk", 0, 1000),
              _span("cm3.chunk", 5, 995),
              _span("cm3.env_step", 95, 305), _span("env_step", 100, 300),
              _span("cm3.replay", 150, 250),
              _span("cm3.replay_sample", 400, 450),
              _span("cm3.update", 500, 900), _span("update", 510, 890),
              _span("cm3.critics", 550, 750),
              _span("cm3.backward", 600, 700)]
    t = {"env_step": 200, "update": 650, "chunk": 420}[where]
    events += _launched(7, t, 1500)
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    ops, spans, window = harness.reduce_trace(str(path), SPAN_NAMES,
                                              "window")
    assert set(spans) == set(SPAN_NAMES)
    assert window == (0.0, 2000.0)
    assert [(name, span) for name, _, _, span in ops] == [("k7", expected)]


def _record():
    return {
        "cm3.chunk": {"count": 7, "host_s": 7.0, "self_s": 0.1,
                      "stream_s": None},
        "cm3.chunk/cm3.env_step": {"count": 70, "host_s": 1.4,
                                   "self_s": 0.2, "stream_s": None},
        "cm3.chunk/cm3.update": {"count": 112, "host_s": 5.6,
                                 "self_s": 0.1, "stream_s": None},
        "cm3.host_sync": {"count": 6, "host_s": 0.21, "self_s": 0.21,
                          "stream_s": None},
        "cm3.period/cm3.host_sync": {"count": 7, "host_s": 0.1,
                                     "self_s": 0.1, "stream_s": None},
    }


@pytest.mark.parametrize("record,expected", [
    ("hand_made", 13 / 7), ("no_sync", 0), ("no_chunk", None),
    ("empty", None), ("no_summary", None)])
def test_host_syncs_reader(record, expected, monkeypatch):
    """``host_syncs_per_chunk`` on a hand-made record (host syncs at two
    paths over 7 chunks), without syncs, without chunks, on an empty
    record and where the program keeps none (the parent of the span
    record)."""
    from cm3_tpu_torch.utils import profiling

    read = harness.load_module("metrics", "host_syncs_per_chunk").read
    rec = _record()
    if record == "no_sync":
        rec = {k: v for k, v in rec.items() if "host_sync" not in k}
    elif record == "no_chunk":
        rec = {k: v for k, v in rec.items() if "chunk" not in k}
    elif record == "empty":
        rec = {}
    if record == "no_summary":
        monkeypatch.delattr(profiling, "summary")
    else:
        monkeypatch.setattr(profiling, "summary", lambda: rec)
    got = read(None)
    assert got == (None if expected is None else pytest.approx(expected))


@pytest.mark.parametrize("cell", ["checkers_cm3_s2.sweep256",
                                  "roadway_cm3_s2.sweep256"])
def test_traced_sweep_records_the_program_spans(cell, tmp_path):
    from cm3_tpu_torch.utils import profiling

    bench, entry, workload, conf = harness.cell(cell)
    workload = dict(workload, seeds=2, master={
        "n_envs": 2, "pretrain_episodes": 4, "period": 4, "batch_size": 16,
        "N_eval": 2})
    ctx = types.SimpleNamespace(
        workload=workload, config=merged_config(conf, workload),
        seed=2 ** 31 + 5, seconds=0.3, trace=True, device="cpu",
        t_process=time.perf_counter(), out_dir=str(tmp_path))
    run = harness.load_module("drivers", "train_sweep").Run(ctx).run()
    rec = profiling.summary()
    count = lambda span: sum(v["count"] for p, v in rec.items()
                             if p.split("/")[-1] == span)
    n_chunks = workload["traced_chunks"]
    assert count("cm3.chunk") == n_chunks == len(run.trace.spans["chunk"])
    assert count("cm3.update") == run.trace.counters["traced_updates"]
    assert count("cm3.env_step") == len(run.trace.spans["env_step"])
    # the last chunk's read falls after the stretch
    assert count("cm3.host_sync") >= n_chunks - 1
    # under the benchmark's profiler the spans keep no stream time
    assert all(v["stream_s"] is None for v in rec.values())
    syncs = harness.load_module("metrics", "host_syncs_per_chunk")
    assert syncs.read(run.trace) == count("cm3.host_sync") / n_chunks
