"""The port's fused Checkers rollout (plain versions on the CPU) against
``cm3_tpu``'s Pallas kernel in interpret mode; Philox4x32-10 against
Random123's known answers; the kernel build's command and hash; and the
port's env benchmarks at small sizes.  The CUDA kernel itself is held
against the plain version on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``)."""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity
from cm3_tpu.core import config as jcfg
from cm3_tpu.envs import checkers_packed as jcp
from cm3_tpu.ops import checkers_rollout as jcr
from cm3_tpu_torch import bench
from cm3_tpu_torch.core import config as tcfg
from cm3_tpu_torch.envs import checkers_packed as tcp
from cm3_tpu_torch.ops import _nvcc, philox
from cm3_tpu_torch.ops import checkers_rollout as tcr

KW = dict(n_agents=2, agents_r=(0, 2), agents_c=(8, 8), max_steps=50)
JSPEC = jcp.make_spec(jcfg.CheckersEnvConfig(**KW), (True, False))
TSPEC = tcp.make_spec(tcfg.CheckersEnvConfig(**KW), (True, False))


@pytest.fixture(autouse=True)
def _cpu():
    torch_parity.set_torch_cpu()


def test_rollout_actions_plain_matches_jax_kernel():
    """B = 1024, T = 120 fed actions through JAX's Pallas kernel
    (interpret mode) and the port's plain version: episodes exactly,
    reward sums to atol 1e-5 (the same float32 adds in the same
    order)."""
    actions = np.random.default_rng(0).integers(0, 5, (120, 2, 1024),
                                                dtype=np.int32)
    j_rew, j_ep = jcr.rollout_actions(JSPEC, jnp.asarray(actions), sub=8,
                                      interpret=True)
    t_rew, t_ep = tcr.rollout_actions(TSPEC, torch.from_numpy(actions))
    assert t_rew.dtype == torch.float32 and t_ep.dtype == torch.int32
    np.testing.assert_array_equal(t_ep.numpy(), np.asarray(j_ep))
    np.testing.assert_allclose(t_rew.numpy(), np.asarray(j_rew), rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("counter,key,want", [
    ((0, 0, 0, 0), (0, 0),
     (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
     (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
], ids=["zeros", "ones", "pi"])
def test_philox_known_answers(counter, key, want):
    got = philox.philox4x32_10(counter, key)
    assert tuple(int(w) for w in got) == want


def test_philox_is_elementwise():
    """A batch of counters gives each element's own answer."""
    c = torch.tensor([0, 0xFFFFFFFF])
    w = philox.philox4x32_10((c, c, c, c), (0, 0))
    assert int(w[0][0]) == 0x6627E8D5
    assert int(w[0][1]) == int(philox.philox4x32_10(
        (0xFFFFFFFF,) * 4, (0, 0))[0])


def test_philox_stays_on_the_counters_device():
    """Integer counter words join the device of the tensor words (the
    rollout passes t as an int and b as a tensor on the card)."""
    b = torch.arange(4, device="meta")
    words = philox.philox4x32_10((3, b, 0, 0), (1, 0))
    assert all(w.device.type == "meta" and w.shape == (4,) for w in words)
    acts = tcr.random_actions(1, 3, 4, 2, "meta")
    assert all(a.device.type == "meta" for a in acts)


def test_prng_actions_are_uniform():
    """About 10^6 draws (B = 4096, T = 128, two agents): each action's
    share lies within 0.005 of 0.2."""
    counts = torch.zeros(5, dtype=torch.int64)
    for t in range(128):
        for a in tcr.random_actions(12345, t, 4096, 2, "cpu"):
            counts += torch.bincount(a, minlength=5)
    share = counts.double() / counts.sum()
    assert counts.sum() == 2 * 4096 * 128
    assert float((share - 0.2).abs().max()) < 0.005, share


def test_prng_rollout_matches_jax_in_distribution():
    """The Philox variant (plain) against JAX's kernel fed numpy-uniform
    actions at the same B = 2048 and T = 128: the means of the reward
    sum and of the episode count per instance lie within 4 standard
    errors of each other (a random policy rarely clears the board, so
    at T = 128 every instance ends 2 episodes at the cap of 50 and the
    episode means must be equal)."""
    b, t = 2048, 128
    t_rew, t_ep = tcr.rollout_prng(TSPEC, b, t, seed=5, device="cpu")
    actions = np.random.default_rng(5).integers(0, 5, (t, 2, b),
                                                dtype=np.int32)
    j_rew, j_ep = jcr.rollout_actions(JSPEC, jnp.asarray(actions), sub=8,
                                      interpret=True)
    for mine, ref in ((t_rew.numpy(), np.asarray(j_rew)),
                      (t_ep.numpy(), np.asarray(j_ep))):
        mine, ref = mine.astype(np.float64), ref.astype(np.float64)
        se = np.sqrt(mine.var() / b + ref.var() / b)
        assert abs(mine.mean() - ref.mean()) <= 4 * se, (mine.mean(),
                                                        ref.mean(), se)


def test_prng_wrapper_on_cpu_is_the_plain_version():
    rew, ep = tcr.rollout_prng(TSPEC, 100, 60, seed=3, device="cpu")
    p_rew, p_ep = tcr.rollout_prng_plain(TSPEC, 100, 60, 3, device="cpu")
    assert torch.equal(rew, p_rew) and torch.equal(ep, p_ep)
    assert bool((ep >= 1).all())               # 60 steps, cap 50


def test_one_agent_rollout_matches_jax_scan():
    """n = 1 (the orange-goal single-agent game): the plain rollout
    equals a scan of JAX's packed step on the same actions."""
    import jax
    kw = dict(n_agents=1, agents_r=(2,), agents_c=(8,), max_steps=50)
    jspec = jcp.make_spec(jcfg.CheckersEnvConfig(**kw), (False,))
    tspec = tcp.make_spec(tcfg.CheckersEnvConfig(**kw), (False,))
    actions = np.random.default_rng(2).integers(0, 5, (90, 1, 256),
                                                dtype=np.int32)

    def body(carry, a):
        s, rew, ep = carry
        s, rs, d = jcp.packed_step(jspec, s, (a[0],))
        return (s, rew + rs[0], ep + d.astype(jnp.int32)), ()

    (_, j_rew, j_ep), _ = jax.lax.scan(
        body, (jcp.packed_init(jspec, (256,)), jnp.zeros(256),
               jnp.zeros(256, jnp.int32)), jnp.asarray(actions))
    t_rew, t_ep = tcr.rollout_actions(tspec, torch.from_numpy(actions))
    np.testing.assert_array_equal(t_ep.numpy(), np.asarray(j_ep))
    np.testing.assert_array_equal(t_rew.numpy(), np.asarray(j_rew))


# ---- no silent fallback ---- #


def test_meta_device_raises():
    before = (tcr.rollout_prng.launches, tcr.rollout_actions.launches)
    with pytest.raises(RuntimeError, match="no kernel"):
        tcr.rollout_prng(TSPEC, 8, 4, seed=0, device="meta")
    acts = torch.zeros((4, 2, 8), dtype=torch.int32, device="meta")
    with pytest.raises(RuntimeError, match="no kernel"):
        tcr.rollout_actions(TSPEC, acts)
    assert (tcr.rollout_prng.launches, tcr.rollout_actions.launches) == before


def test_spec_words_refuse_three_agents():
    spec = TSPEC._replace(init_pos=(1, 2, 4), goal_green=(True,) * 3)
    with pytest.raises(ValueError):
        tcr.spec_words(spec)


# ---- the build ---- #


def test_nvcc_command_names_sm90a_and_every_source():
    """One compile command per source (all started together), then one
    link of their objects into the shared library."""
    srcs = _nvcc.sources()
    assert [os.path.basename(s) for s in srcs] == [
        "checkers_rollout.cu", "flat_update.cu", "particle_rollout.cu",
        "roadway_rollout.cu", "runtime.cu"]
    for src in srcs:
        cmd = _nvcc.compile_command("nvcc", src, "/out/x.o")
        assert "arch=compute_90a,code=sm_90a" in cmd
        assert "-O3" in cmd and "-c" in cmd and cmd[-1] == src
    objs = [f"/out/{i}.o" for i in range(len(srcs))]
    cmd = _nvcc.link_command("nvcc", objs, "/out/lib.so")
    assert "arch=compute_90a,code=sm_90a" in cmd and "-shared" in cmd
    assert cmd[-len(objs):] == objs


def _c_entries():
    """Every ``extern "C"`` entry of the sources: name -> its number of
    parameters."""
    out = {}
    for path in _nvcc.sources():
        for name, params in re.findall(
                r'extern "C" [\w\s*]+?\b(\w+)\(([^)]*)\)', open(path).read()):
            out[name] = params.count(",") + 1 if params.strip() else 0
    return out


@pytest.mark.parametrize("entry", sorted(_nvcc.SIGNATURES))
def test_signatures_match_the_c_entries(entry):
    """Each ctypes signature has as many arguments as its C entry (a
    missing one would be read from garbage), and every entry has a
    signature; the flat updates' entries are among them."""
    entries = _c_entries()
    assert set(entries) == set(_nvcc.SIGNATURES)
    assert {"cm3_adam_polyak", "cm3_polyak", "cm3_adam_polyak_occupancy",
            "cm3_polyak_occupancy"} <= set(entries)
    assert len(_nvcc.SIGNATURES[entry][0]) == entries[entry]


def test_nvcc_hash_follows_sources_flags_and_version(tmp_path):
    for name in ("a.cu", "b.cuh"):
        (tmp_path / name).write_text("int x;\n")
    files = sorted(str(p) for p in tmp_path.iterdir())
    h = _nvcc.digest(files, _nvcc.FLAGS, "V12.4")
    assert h == _nvcc.digest(files, _nvcc.FLAGS, "V12.4")
    (tmp_path / "b.cuh").write_text("int y;\n")
    h2 = _nvcc.digest(files, _nvcc.FLAGS, "V12.4")
    assert h2 != h
    assert _nvcc.digest(files, _nvcc.FLAGS, "V12.6") != h2
    assert _nvcc.digest(files, _nvcc.FLAGS[:-2], "V12.4") != h2


def test_no_source_includes_a_torch_header():
    files = _nvcc.sources() + _nvcc.headers()
    assert files
    for path in files:
        for line in open(path):
            if line.lstrip().startswith("#include"):
                assert "torch/" not in line and "ATen" not in line, line


def test_missing_nvcc_names_the_places_looked(monkeypatch, tmp_path):
    monkeypatch.setattr(_nvcc.shutil, "which", lambda _: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_nvcc.os, "access", lambda *_: False)
    with pytest.raises(RuntimeError, match="PATH.*" + str(tmp_path)):
        _nvcc.find_nvcc()


@pytest.mark.parametrize("goal_green", [(True, False), (False,)])
def test_spec_words_follow_the_source_enum(goal_green):
    """The wrapper packs the spec in the order of ``SpecWord`` in
    ``csrc/checkers_rollout.cu``, which the C entry reads by index: the
    masks, start positions, goal bits and step cap, then the move table
    per action (stay, up, down, left, right): edge masks, left shifts,
    right shifts, ``kActions`` words each."""
    src = open(os.path.join(_nvcc.CSRC, "checkers_rollout.cu")).read()
    enum = re.search(r"enum SpecWord \{([^}]*)\}", src).group(1)
    names = [w.split("=")[0].strip() for w in enum.split(",") if w.strip()]
    actions = int(re.search(r"constexpr int kActions = (\d+);",
                            src).group(1))
    assert actions == 5 and names[-1] == "kNumWords"
    n = len(goal_green)
    kw = dict(KW, n_agents=n, agents_r=KW["agents_r"][:n],
              agents_c=KW["agents_c"][:n])
    spec = tcp.make_spec(tcfg.CheckersEnvConfig(**kw), goal_green)
    init = tuple(spec.init_pos) + (0,) * (2 - n)
    w = spec.width
    want = dict(
        kGreen=(spec.green_mask,), kOrange=(spec.orange_mask,),
        kFull=(spec.full_mask,), kInit0=(init[0],), kInit1=(init[1],),
        kGoalGreen=(int(goal_green[0]),), kMaxSteps=(spec.max_steps,),
        kEdge=(0, spec.up_ok, spec.down_ok, spec.left_ok, spec.right_ok),
        kShl=(0, 0, w, 0, 1), kShr=(0, w, 0, 1, 0))
    assert names[:-1] == list(want)
    assert tcr.spec_words(spec) == sum((want[k] for k in names[:-1]), ())


@pytest.mark.parametrize("n_columns", [8, 4])
def test_move_table_moves_as_the_packed_engine(n_columns):
    """From every cell of the area, each action's table entry moves one
    agent where the packed engine's step does: target
    ``(p << shl) >> shr`` (in 32 bits), taken only where ``p & edge``."""
    cfg = tcfg.CheckersEnvConfig(n_agents=1, n_columns=n_columns,
                                 agents_r=(2,), agents_c=(n_columns,),
                                 max_steps=50)
    spec = tcp.make_spec(cfg, (True,))
    cells = spec.width * spec.height
    p = torch.tensor([1 << k for k in range(cells)]).repeat_interleave(5)
    a = torch.arange(5).repeat(cells)
    s = tcp.PackedState(pos=(p,), collected=torch.zeros_like(p),
                        steps=torch.zeros_like(p))
    s2, _, _ = tcp.packed_step(spec, s, (a,))
    table = torch.tensor(tcr.move_table(spec))[a]
    edge, shl, shr = table.unbind(1)
    tgt = ((p << shl) & 0xFFFFFFFF) >> shr
    assert torch.equal(s2.pos[0], torch.where((p & edge) != 0, tgt, p))
    assert bool((s2.pos[0] != p).any())


# ---- the benchmarks' control flow (figures only on the card) ---- #


def test_bench_functions_run_small_on_cpu():
    fused = bench.bench_checkers_fused(batch=64, steps=16, reps=1,
                                       device="cpu")
    grid = bench.bench_checkers_throughput(batch=16, steps=8, reps=1,
                                           device="cpu")
    assert fused > 0 and grid > 0


def test_bench_cli_refuses_without_cuda(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert bench.main(["--one", "checkers_fused_env_steps_per_s"]) == 1
    assert capsys.readouterr().out == ""
