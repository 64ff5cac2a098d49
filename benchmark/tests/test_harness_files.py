"""BENCHMARK.json against the benchmark's contract, and every file it
names found by name.  The stage-file check also reads the particle
configuration the tests hold (``particle_cm3_s2.json`` beside this
file)."""

import json
import os
import re

import pytest

from benchmark import harness

ROOT = harness.ROOT
BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "benchmark/run.py"]
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_check_fits_with_24_cells():
    runs = 2 + 14 * 24
    total = runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200
    assert total <= 43200


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda c: c["name"])
def test_config_found(entry):
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(entry["name"])
    assert entry["file"].startswith("benchmark/")
    conf = json.load(open(os.path.join(ROOT, entry["file"])))
    assert set(entry["reduced"]) <= set(conf["master"]) | {"n_seeds"}
    assert set(entry["reduced"]) == set(conf["reduced"])
    for key in entry["reduced"]:
        assert not re.search(r"(_dim|_rank|units|_h\d|size)$", key), key


def stage_file_name(master):
    """The file of ``cm3_tpu/configs`` that the port's runner reads for
    ``master`` (``train/runner.py:build_env``): for particle
    ``particle_`` + ``particle_config`` (default ``stage{stage}``) with
    ``config_particle_`` and ``.json`` stripped, else
    ``{experiment}_stage{stage}.json``."""
    exp, stage = master["experiment"], master["stage"]
    if exp == "particle":
        name = master.get("particle_config", f"stage{stage}")
        name = name.replace("config_particle_", "").replace(".json", "")
        return f"particle_{name}.json"
    return f"{exp}_stage{stage}.json"


PARTICLE = os.path.join(harness.HERE, "tests", "particle_cm3_s2.json")


def test_config_stage_files_are_the_programs():
    files = [os.path.join(ROOT, e["file"]) for e in BENCH["configs"]]
    for path in files + [PARTICLE]:
        conf = json.load(open(path))
        name = stage_file_name(conf["master"])
        if path == PARTICLE:
            assert name == "particle_stage2_antipodal.json" == \
                stage_file_name(dict(conf["master"], particle_config=(
                    "config_particle_stage2_antipodal.json")))
        stage_file = os.path.join(ROOT, "cm3_tpu", "configs", name)
        assert conf["stage_file"] == json.load(open(stage_file))


@pytest.mark.parametrize("entry", BENCH["workloads"], ids=lambda w: w["name"])
def test_workload_found(entry):
    assert set(entry) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(entry["name"]) and NAME.match(entry["traffic"])
    assert entry["chips"] == 1
    assert 1 <= len(entry["why"]) <= 200 and "\n" not in entry["why"]
    assert entry["config"] in {c["name"] for c in BENCH["configs"]}
    cell = json.load(open(os.path.join(harness.HERE, "workloads",
                                       entry["name"] + ".json")))
    assert cell["config"] == entry["config"]
    assert os.path.exists(os.path.join(harness.HERE, "drivers",
                                       cell["driver"] + ".py"))
    assert cell["limits"]
    reports = [m for m in BENCH["end_to_end"]
               if entry["name"] in m.get("workloads", [entry["name"]])]
    assert "setup_s" in {m["name"] for m in reports} and len(reports) >= 2
    assert any(entry["name"] in m.get("workloads", [entry["name"]])
               for m in BENCH["per_layer"])


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric(metric):
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    assert metric["source"] in SOURCES
    cells = {w["name"] for w in BENCH["workloads"]}
    assert set(metric.get("workloads", [])) <= cells
    if metric in BENCH["end_to_end"]:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        assert metric["moves"] in {m["name"] for m in BENCH["end_to_end"]}
        assert os.path.exists(os.path.join(harness.HERE, "metrics",
                                           metric["name"] + ".py"))
        mod = harness.load_module("metrics", metric["name"])
        assert callable(mod.read)
        if metric["name"].endswith("_roofline") or "mfu" in metric["name"]:
            assert metric["unit"] == "%"


def test_one_layer_name_per_metric_layer():
    layers = {m["layer"] for m in BENCH["per_layer"]}
    assert all(1 <= len(x) <= 200 and "\n" not in x for x in layers)


def test_setup_bound():
    setup = next(m for m in BENCH["end_to_end"] if m["name"] == "setup_s")
    assert setup["bound"] == 0.25
