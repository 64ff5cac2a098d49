"""The tools: ``render_episodes`` and the CLI's ``--render-episodes`` /
``--render-only`` from the port's checkpoints, the live viewer
(serving, updating, and refusing traversal, non-SVG files and symlinks
out of its root), the interactive harness with its input fed, and
``profiling``'s trace and timers, on the CPU."""

import io
import json
import os
import sys
import urllib.error
import urllib.request
import xml.etree.ElementTree as ET

import pytest
import torch

from cm3_tpu_torch.core import config as tcfg
from cm3_tpu_torch.train import runner
from cm3_tpu_torch.utils import interactive, live_viewer, profiling
from tests import torch_parity as tp

tp.set_torch_cpu()


# --------------------------------------------------------------------- #
# render_episodes and the CLI
# --------------------------------------------------------------------- #

SMALL = dict(n_envs=2, N_train=8, period=4, N_eval=1, pretrain_episodes=4,
             batch_size=8, buffer_size=64, steps_per_train=5, max_steps=5,
             seed=5)


def test_render_episodes_and_cli(tmp_path, monkeypatch, capsys):
    """A tiny stage-1 run through the CLI with ``--render-episodes 2``
    writes two SVGs from the trained state; ``--render-only`` restores
    the port's ``model_final`` and writes them again, the same bytes;
    particle and roadway render from fresh states."""
    monkeypatch.setattr(runner, "_nn_config",
                        lambda m, e, s: tcfg.NNConfig(**tp.SMALL_NN))
    m = tcfg.load_json("master.json")
    m.update(SMALL, dir_name="rnd")
    cfg_path = tmp_path / "m.json"
    cfg_path.write_text(json.dumps(m))
    wd = str(tmp_path / "wd")
    args = ["--config", str(cfg_path), "--workdir", wd, "--device", "cpu"]
    runner.main(args + ["--render-episodes", "2"])
    paths = capsys.readouterr().out.strip().splitlines()[-2:]
    want = [os.path.join(wd, "render", "rnd", f"episode_{i}.svg")
            for i in range(2)]
    assert paths == want
    first = [open(p).read() for p in want]
    for p in want:
        os.remove(p)
    runner.main(args + ["--render-only", "--render-episodes", "2"])
    assert capsys.readouterr().out.strip().splitlines() == want
    assert [open(p).read() for p in want] == first
    for svg in first:
        assert any(e.tag.endswith("animate")
                   for e in ET.fromstring(svg).iter())
    for exp in ("particle", "roadway"):
        mm = dict(m, experiment=exp, stage=2, dir_name=exp,
                  particle_config="stage2_antipodal")
        _, alg, _, _ = runner.build(mm, device="cpu")
        (p,) = runner.render_episodes(mm, alg.init_state(3), wd, 1,
                                      device="cpu")
        assert p.endswith(os.path.join(exp, "episode_0.svg"))
        ET.parse(p)


# --------------------------------------------------------------------- #
# the live viewer
# --------------------------------------------------------------------- #


def _get(port, path):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=10) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def test_live_viewer_serves_and_contains(tmp_path):
    root = tmp_path / "render"
    (root / "run").mkdir(parents=True)
    (root / "run" / "episode_0.svg").write_text("<svg>a</svg>")
    (root / "notes.txt").write_text("secret")
    outside = tmp_path / "outside.svg"
    outside.write_text("<svg>out</svg>")
    os.symlink(outside, root / "run" / "leak.svg")
    (tmp_path / "outdir").mkdir()
    (tmp_path / "outdir" / "x.svg").write_text("<svg>x</svg>")
    os.symlink(tmp_path / "outdir", root / "linkdir")
    srv, port = live_viewer.serve_background(str(root), 0)
    try:
        assert _get(port, "/run/episode_0.svg") == (200, b"<svg>a</svg>")
        listed = [e["path"] for e in json.loads(_get(port, "/list")[1])]
        assert listed == [os.path.join("run", "episode_0.svg")]
        code, page = _get(port, "/")
        assert code == 200 and b"episode_0.svg" in page
        for bad in ("/../outside.svg", "/run/../../outside.svg",
                    "/notes.txt", "/run/leak.svg", "/linkdir/x.svg",
                    "/missing.svg"):
            assert _get(port, bad)[0] == 404, bad
        # a new episode lands: listed and served
        (root / "run" / "episode_1.svg").write_text("<svg>b</svg>")
        listed = [e["path"] for e in json.loads(_get(port, "/list")[1])]
        assert os.path.join("run", "episode_1.svg") in listed
        assert _get(port, "/run/episode_1.svg") == (200, b"<svg>b</svg>")
    finally:
        srv.shutdown()
        srv.server_close()


# --------------------------------------------------------------------- #
# the interactive harness and profiling
# --------------------------------------------------------------------- #


@pytest.mark.parametrize("game", ["checkers", "particle", "roadway"])
def test_interactive_runs_with_fed_input(game, monkeypatch, capsys):
    """Two agents in each game's default: a step of "1,0", a malformed
    line refused, then "q"."""
    monkeypatch.setattr(sys, "stdin", io.StringIO("1,0\nx\nq\n"))
    interactive.main(["--experiment", game, "--device", "cpu"])
    out = capsys.readouterr().out
    assert "[t=1]" in out and "reward" in out and "need" in out


def test_profiling_trace_and_timers(tmp_path):
    x = torch.randn(64, 64)
    with profiling.trace(str(tmp_path)) as prof:
        with profiling.annotate("matmul_span"):
            y = x @ x
    assert float(y.sum()) == float((x @ x).sum())
    with open(tmp_path / "trace.json") as f:
        trace = json.load(f)
    names = {e.get("name") for e in trace["traceEvents"]}
    assert "matmul_span" in names
    assert any("mm" in (k.key or "") for k in prof.key_averages())
    timer = profiling.SplitTimer(device="cpu")
    with timer.section("env"):
        pass
    with timer.section("env"):
        pass
    assert set(timer.summary()) == {"env"} and timer.summary()["env"] >= 0
    tp_ = profiling.Throughput()
    tp_.add(10)
    assert tp_.rate() >= 0
    tp_.reset()
    assert tp_.units == 0
