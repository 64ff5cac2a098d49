"""Tests of the port that need the card (marker ``cuda``): the CUDA C++
kernels (``adam_polyak``, also over seed-stacked [S, n] buffers,
``polyak``, the Checkers, particle and roadway rollouts) against their
plain versions, the
particle kernel's squared-distance thresholds under CUDA's math, the
kernels' builds, a small training chunk on the card against the same
chunk on the CPU, also under PyTorch's default TF32 flags, and the
seed-batched chunk (three seeds, stage 2 and stage 1, optax and fused)
on the card against the CPU, with the fused update's two launches per
update at 16 seeds, and the curriculum: the stage-2 graft and a
checkpoint round trip on the card, the actor freeze on the fused path
(the fused kernel without the actor, the Polyak kernel on its target)
against the CPU, and a tiny run of the runner; the baselines (COMA,
IAC, central-V, the blend) and QMIX (and its reference wiring): a fill
and a training chunk on the card against the CPU, one seed and three,
and the four paper cells through the runner with no fused-kernel
launch; particle on the card against the CPU and through the runner;
roadway and the dual buffer: the engine, a dual chunk (one seed and
three, optax and fused) and a dual burst on the card against the CPU,
the fused update at roadway sizes, a tiny roadway curriculum through
the runner, and the first learning check (roadway stage 1, printed
with ``-s``); the tools: the update's gradients (one seed and three)
against the CPU, the gradient snapshot leaving the state bit for bit
with its launches, and roadway's occluded observation and traffic
surfaces against the CPU; shard-local replay: the Checkers chunk (2 and
4 shards) and the roadway dual chunk (2 shards, one seed and three) on
the card against the CPU; a step of each of the nine MPE scenarios
on both paths against the CPU; and the multi-process layer
(``parallel/``): a data mesh of world size 1 over NCCL against no mesh,
and two gloo ranks sharing the card (the data axis in 2 shards and in
one ring, and seeds over the ranks) against the single-process run.  They import
neither JAX nor ``cm3_tpu``, so they run on a machine without them:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Without a CUDA device they skip."""

import ctypes
import time

import numpy as np
import pytest
import torch

from cm3_tpu_torch.algs import common
from cm3_tpu_torch.core.config import (CheckersEnvConfig, NNConfig,
                                       ParticleEnvConfig,
                                       RoadwayEnvConfig)
from cm3_tpu_torch.envs import checkers_packed as cp
from cm3_tpu_torch.ops import _nvcc
from cm3_tpu_torch.ops import checkers_rollout as cr
from cm3_tpu_torch.ops import fused_opt, polyak
from cm3_tpu_torch.ops import particle_rollout as pr
from cm3_tpu_torch.ops import roadway_rollout as rr

ROLLOUT_CASES = {
    "two_agents": (dict(n_agents=2, agents_r=(0, 2), agents_c=(8, 8)),
                   (True, False)),
    "one_agent": (dict(n_agents=1, agents_r=(2,), agents_c=(8,)), (False,)),
}
# the fused particle and roadway rollouts: (wrapper module, config)
SOA_CASES = {
    "particle_n2": (pr, ParticleEnvConfig(
        n_agents=2, agents_x=(-0.9, 0.9), agents_y=(-0.9, 0.9),
        landmarks_x=(0.9, -0.9), landmarks_y=(0.9, -0.9), prob_random=0.0,
        initial_std=0.0)),
    "particle_n4": (pr, ParticleEnvConfig(prob_random=0.0, initial_std=0.0)),
    "roadway_n1": (rr, RoadwayEnvConfig(
        n_agents=1, goal_lane=(3,), goal_pos=(190.0,), speed=(30.0,),
        lane=(1,), init_position=(0.0,), depart_mean=(0.0,),
        depart_stdev=0.0)),
    "roadway_n2": (rr, RoadwayEnvConfig(depart_stdev=0.0)),
}
# four agents starting within contact range: adjacent ones 0.29 apart
# (inside dmin = 0.3), diagonal ones 0.41 apart (at the kernel's far
# threshold, dmin + 0.11)
PARTICLE_NEAR = ParticleEnvConfig(agents_x=(-0.145, 0.145, -0.145, 0.145),
                                  agents_y=(-0.145, -0.145, 0.145, 0.145),
                                  prob_random=0.0, initial_std=0.0)
THRESHOLD_CFGS = {
    "default": {}, "small_agents": dict(agent_size=0.05),
    "large_agents": dict(agent_size=0.3),
    "sharp_contact": dict(contact_margin=1e-4),
    "soft_contact": dict(contact_margin=1e-2),
}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the CUDA C++ kernels run only on "
                    "the card)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _view(n, off, gen, device):
    """n standard normal floats ``off`` floats into their allocation."""
    x = torch.zeros(n + off, device=device)
    x[off:] = torch.randn(n, device=device, generator=gen)
    return x[off:]


def _hold_adam(cuda_device, spec, seed):
    """The kernel over the networks of ``spec`` ((n, step count, lr,
    offset) each), one launch per step for 5 steps, against the plain
    version per network: equal bit for bit (rtol 0, atol 0: the kernel
    rounds every operation as the plain version does, in its order).
    Returns the launches."""
    gen = torch.Generator(device=cuda_device).manual_seed(seed)
    nets, refs = [], []
    for n, count, lr, off in spec:
        p, t, mu, nu = (_view(n, off, gen, cuda_device) for _ in range(4))
        nu.square_().mul_(1e-3)
        nets.append((common.AdamState(mu, nu, count), p, t, lr))
        refs.append((common.AdamState(mu.clone(), nu.clone(), count),
                     p.clone(), t.clone(), lr))
    before = fused_opt.adam_polyak.launches
    for _ in range(5):
        gs = [_view(n, off, gen, cuda_device) for n, _, _, off in spec]
        fused_opt.adam_polyak_many([(st, p, t, g, lr) for (st, p, t, lr), g
                                    in zip(nets, gs)], 0.01)
        for (st, p, t, lr), g in zip(refs, gs):
            fused_opt.adam_polyak_plain(p, t, st.mu, st.nu, g,
                                        *fused_opt.bias_corrections(st.count),
                                        lr, 0.01)
            st.count += 1
    torch.cuda.synchronize()
    for (st, p, t, _), (rst, rp, rt, _) in zip(nets, refs):
        assert st.count == rst.count
        for got, want in ((p, rp), (t, rt), (st.mu, rst.mu),
                          (st.nu, rst.nu)):
            assert torch.equal(got, want)
    return fused_opt.adam_polyak.launches - before


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 3, 1000, 8193, 149645])
def test_adam_polyak_kernel_matches_plain(cuda_device, n):
    """The CUDA C++ kernel vs the plain version over 5 steps on the
    card, bit for bit (rtol 0, atol 0), one launch a step."""
    assert _hold_adam(cuda_device, [(n, 0, 1e-3, 0)], n) == 5


@pytest.mark.cuda
@pytest.mark.parametrize("off", [1, 2, 3])
@pytest.mark.parametrize("n", [8193, 149645])
def test_adam_polyak_kernel_on_offset_views(cuda_device, n, off):
    """Views ``off`` floats into their allocations (not 16-byte
    aligned: the kernel's one-float-a-thread path), alone and beside an
    aligned network in one launch: bit for bit."""
    assert _hold_adam(cuda_device, [(n, 2, 1e-3, off)], off) == 5
    assert _hold_adam(cuda_device, [(n, 0, 1e-3, 0), (1000, 7, 1e-4, off)],
                      off) == 5


@pytest.mark.cuda
def test_adam_polyak_two_segments_equal_two_launches(cuda_device):
    """Both critics of the main path in one launch, with different step
    counts and lr, equal one launch each and the plain version, bit for
    bit; four ragged segments too, aligned (the float4 kernel) and with
    views at offsets (the one-float-a-thread kernel)."""
    spec = [(144741, 3, 1e-3, 0), (144709, 0, 1e-4, 0)]
    assert _hold_adam(cuda_device, spec, 1) == 5
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    nets = [[_view(n, 0, gen, cuda_device) for _ in range(5)]
            for n, *_ in spec]
    for x in nets:
        x[3].square_().mul_(1e-3)
    twin = [[b.clone() for b in x] for x in nets]
    one = [(common.AdamState(mu, nu, c), p, t, g, lr)
           for (p, t, mu, nu, g), (_, c, lr, _) in zip(nets, spec)]
    two = [(common.AdamState(mu, nu, c), p, t, g, lr)
           for (p, t, mu, nu, g), (_, c, lr, _) in zip(twin, spec)]
    for _ in range(5):
        fused_opt.adam_polyak_many(one, 0.01)
        for item in two:
            fused_opt.adam_polyak(*item, 0.01)
    torch.cuda.synchronize()
    for x, y in zip(nets, twin):
        for a, b in zip(x, y):
            assert torch.equal(a, b)
    assert _hold_adam(cuda_device, [(8193, 0, 1e-3, 0), (1, 5, 1e-4, 1),
                                    (1000, 17, 3e-3, 2), (3, 999, 1e-2, 3)],
                      3) == 5
    assert _hold_adam(cuda_device, [(8193, 0, 1e-3, 0), (1, 5, 1e-4, 0),
                                    (1003, 17, 3e-3, 0), (3, 999, 1e-2, 0)],
                      4) == 5


@pytest.mark.cuda
def test_flat_update_entries_refuse_sizes_past_int32(cuda_device):
    """The kernels index in 32 bits: the C entries refuse a segment of
    2^31 floats or more (cudaErrorInvalidValue) before any launch."""
    lib = _nvcc.library()
    n = ctypes.c_longlong(2 ** 31)
    ptrs = (ctypes.c_void_p * 8)()
    lr = (ctypes.c_float * 1)(1e-3)
    assert lib.cm3_adam_polyak(1, ptrs, ctypes.byref(n), lr, 0.01, 0.99,
                               None) == 1
    assert lib.cm3_polyak(None, None, 2 ** 31, 0.01, 0.99, None,
                          None) == 1


def _small_chunks(cuda_device, shards=1, **alg_kw):
    """A fill and a training chunk at small width on the card and on
    the CPU with the same fed draws (``alg_kw``: more ``AlgConfig``
    options; ``shards``: the replay in that many shards, each update's
    indices drawn per shard): the CM3 states and the fused kernel's
    launches on each (with ``alg_kw`` also the Polyak kernel's), and
    under ``"buf_<device>"`` the replay."""
    from cm3_tpu_torch.algs.cm3 import CM3
    from cm3_tpu_torch.core import config, prng
    from cm3_tpu_torch.core.tree import tree_map
    from cm3_tpu_torch.envs.checkers import Checkers
    from cm3_tpu_torch.train.experiments import make_hooks
    from cm3_tpu_torch.train.offpolicy import OffPolicyDriver, init_rollout

    e, b, u = 16, 32, 4
    rng = np.random.default_rng(0)
    fill = [rng.integers(0, 5, (e, 2)) for _ in range(10)]
    act = [rng.gumbel(size=(e, 2, 5)).astype(np.float32) for _ in range(10)]
    idx = [rng.integers(0, 20 * e // shards,
                        b if shards == 1 else (shards, b // shards))
           for _ in range(u)]
    upd = [rng.gumbel(size=(b, 2, 5)).astype(np.float32) for _ in range(u)]
    nn = config.NNConfig(Q_conv_f=2, Q_n_h1_1=16, Q_n_h1_2=8, Q_n_h2=16,
                         A_conv_f=2, A_n_h1=16, A_n_h2=12)
    out = {}
    for dev in (cuda_device, torch.device("cpu")):
        env = Checkers(config.CheckersEnvConfig(n_agents=2, max_steps=7),
                       device=dev)
        alg = CM3("checkers", env.spec(),
                  config.AlgConfig(n_agents=2, stage=2, fused_opt=True,
                                   **alg_kw), nn, device=dev)
        cfg = config.TrainConfig(n_envs=e, batch_size=b, buffer_size=512,
                                 updates_per_chunk=u, replay_shards=shards)
        drv = OffPolicyDriver(make_hooks("checkers", env), alg, cfg)
        rs = init_rollout(drv.hooks, e)
        ts = alg.init_state(prng.root_key(0))
        z = torch.zeros((e, 2), dtype=torch.int64, device=dev)
        buf = drv._replay_init(tree_map(
            lambda x: x[0], drv._transition(rs, z,
                                            env.step(rs.env_state, z)[1])))
        draws = prng.FedDraws(fill + idx, act + upd, device=dev)
        before = fused_opt.adam_polyak.launches
        soft = polyak.polyak_update.launches
        ts, buf, rs, _ = drv._chunk(ts, buf, rs, 0.2, draws, False, True)
        ts, buf, rs, _ = drv._chunk(ts, buf, rs, 0.2, draws, True, False)
        out[dev.type] = (ts, fused_opt.adam_polyak.launches - before)
        if alg_kw:
            out[dev.type] += (polyak.polyak_update.launches - soft,)
        out["buf_" + dev.type] = buf
    return out, u


def _hold_chunks(out, u):
    (ts_c, n_c), (ts_h, n_h) = out["cuda"], out["cpu"]
    assert (n_c, n_h) == (2 * u, 0)
    for name in ("actor", "actor_tgt", "qg", "qg_tgt", "qc", "qc_tgt"):
        torch.testing.assert_close(getattr(ts_c, name).flat.cpu(),
                                   getattr(ts_h, name).flat, rtol=1e-4,
                                   atol=1e-5)


@pytest.mark.cuda
def test_small_chunk_on_card_matches_cpu(cuda_device):
    """A fill and a training chunk at small width on the card and on
    the CPU with the same fed draws: 2 kernel launches per update (the
    actor; both critics in one), and
    the same state at rtol 1e-4, atol 1e-5 (float32 sums in other
    orders through 4 Adam steps)."""
    _hold_chunks(*_small_chunks(cuda_device))


@pytest.mark.cuda
def test_small_chunk_in_full_float32_under_default_flags(cuda_device):
    """The same chunk with PyTorch's default flags (cuDNN convolutions
    in TF32, matrix products not): the port runs its nets in full
    float32 whatever the caller set, so the card still equals the CPU
    at rtol 1e-4, atol 1e-5; the flags are as the caller left them
    afterwards."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    try:
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = False
        out = _small_chunks(cuda_device)
        assert (torch.backends.cudnn.allow_tf32,
                torch.backends.cuda.matmul.allow_tf32) == (True, False)
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved
    _hold_chunks(*out)


@pytest.mark.cuda
@pytest.mark.parametrize("shards", [2, 4])
def test_sharded_chunk_on_card_matches_cpu(cuda_device, shards):
    """The same chunk with the replay in 2 and 4 shards (each update
    draws b/D rows below each shard's fill, on the device): the state at
    rtol 1e-4, atol 1e-5, 2 launches per update, every shard's cursors
    (20 x 16 / D rows each) exactly and its rows at the same tolerance
    (the policy chunk's observations come from the nets' actions)."""
    from cm3_tpu_torch.core.tree import tree_leaves
    out, u = _small_chunks(cuda_device, shards=shards)
    _hold_chunks(out, u)
    ring_c, ring_h = out["buf_cuda"], out["buf_cpu"]
    assert ring_h.size.tolist() == [20 * 16 // shards] * shards
    assert torch.equal(ring_c.size.cpu(), ring_h.size)
    assert torch.equal(ring_c.insert.cpu(), ring_h.insert)
    for (_, x), (_, y) in zip(tree_leaves(ring_c.data),
                              tree_leaves(ring_h.data)):
        torch.testing.assert_close(x.narrow(1, 0, ring_h.capacity).cpu(),
                                   y.narrow(1, 0, ring_h.capacity),
                                   rtol=1e-4, atol=1e-5)


def _seeded_chunks(cuda_device, n_agents, fused, s=3, e=8, b=16, u=3):
    """A fill and a training chunk of ``s`` seeds in lockstep at small
    width on the card and on the CPU, from the same parameters with the
    same fed draws: each device's CM3 state, replay and rollout, and the
    kernel's launches on each."""
    from cm3_tpu_torch.algs.cm3 import CM3
    from cm3_tpu_torch.core import config, prng
    from cm3_tpu_torch.envs.checkers import Checkers
    from cm3_tpu_torch.train.experiments import make_hooks
    from cm3_tpu_torch.train.offpolicy import OffPolicyDriver, init_rollout

    rng = np.random.default_rng(n_agents)
    goals = lambda: [rng.integers(0, 2, (s, e))] if n_agents == 1 else []
    fill, act = [], []
    start = goals()
    for _ in range(10):
        fill += [rng.integers(0, 5, (s, e, n_agents))] + goals()
        act.append(rng.gumbel(size=(s, e, n_agents, 5)).astype(np.float32))
    train = sum((goals() for _ in range(10)), [])
    idx = [rng.integers(0, 20 * e, (s, b)) for _ in range(u)]
    upd = [rng.gumbel(size=(s, b, n_agents, 5)).astype(np.float32)
           for _ in range(u)]
    nn = config.NNConfig(Q_conv_f=2, Q_n_h1_1=16, Q_n_h1_2=8, Q_n_h2=16,
                         A_conv_f=2, A_n_h1=16, A_n_h2=12)
    eps = torch.tensor([0.1, 0.2, 0.3] * s)[:s]
    kw = dict(n_agents=1, agents_r=(0,), agents_c=(8,)) if n_agents == 1 \
        else dict(n_agents=2)
    out = {}
    for dev in (cuda_device, torch.device("cpu")):
        env = Checkers(config.CheckersEnvConfig(max_steps=7, **kw),
                       device=dev)
        alg = CM3("checkers", env.spec(),
                  config.AlgConfig(n_agents=n_agents, stage=min(n_agents, 2),
                                   fused_opt=fused), nn, device=dev,
                  n_seeds=s)
        cfg = config.TrainConfig(n_envs=e, batch_size=b, buffer_size=512,
                                 updates_per_chunk=u, episode_log=16)
        drv = OffPolicyDriver(make_hooks("checkers", env), alg, cfg)
        rs = init_rollout(drv.hooks, e, prng.FedDraws(start, device=dev), 16,
                          n_seeds=s)
        ts = alg.init_state(list(range(s)))
        buf = drv._replay_init(drv.example_transition(rs))
        draws = prng.FedDraws(fill + train + idx, act + upd, device=dev)
        before = fused_opt.adam_polyak.launches
        ts, buf, rs, _ = drv._chunk(ts, buf, rs, eps, draws, False, True)
        ts, buf, rs, m = drv._chunk(ts, buf, rs, eps, draws, True, False)
        assert draws.remaining() == {"randint": 0, "gumbel": 0}
        out[dev.type] = (ts, buf, rs, m,
                         fused_opt.adam_polyak.launches - before)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("n_agents,fused", [(2, False), (1, False), (2, True),
                                            (1, True)])
def test_seed_batched_chunk_on_card_matches_cpu(cuda_device, n_agents, fused):
    """Three seeds in lockstep, stage 2 and stage 1, optax and fused: the
    card equals the CPU after a fill and a training chunk at rtol 1e-4,
    atol 1e-5 (float32 sums in other orders through 3 Adam steps); the
    fused path launches the kernel twice per update on the card, for
    any number of seeds, and never on the CPU."""
    from cm3_tpu_torch.core.tree import tree_leaves
    out = _seeded_chunks(cuda_device, n_agents, fused)
    (ts_c, buf_c, rs_c, m_c, n_c), (ts_h, buf_h, rs_h, m_h, n_h) = \
        out["cuda"], out["cpu"]
    assert (n_c, n_h) == ((2 * 3, 0) if fused else (0, 0))
    names = ("actor", "actor_tgt", "qg", "qg_tgt") + (
        ("qc", "qc_tgt") if n_agents > 1 else ())
    for name in names:
        torch.testing.assert_close(getattr(ts_c, name).flat.cpu(),
                                   getattr(ts_h, name).flat, rtol=1e-4,
                                   atol=1e-5)
    for (path, x), (_, y) in zip(tree_leaves(buf_c.data),
                                 tree_leaves(buf_h.data)):
        torch.testing.assert_close(x.cpu(), y, rtol=1e-4, atol=1e-5)
    for name in ("episodes", "eplog", "eplog_ep", "acc_ret_local"):
        torch.testing.assert_close(getattr(rs_c, name).cpu(),
                                   getattr(rs_h, name), rtol=1e-4, atol=1e-5)
    for k in m_h:
        torch.testing.assert_close(m_c[k].cpu(), m_h[k], rtol=1e-4,
                                   atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("s,n", [(3, 1000), (16, 149645), (16, 289450)])
def test_adam_polyak_over_seed_segments_matches_plain(cuda_device, s, n):
    """B1 over [S, n] buffers (one segment of S x n floats, as the fused
    seed-batched update hands it each network) against the plain version
    over the same buffers, 5 steps, bit for bit (rtol 0, atol 0)."""
    gen = torch.Generator(device=cuda_device).manual_seed(s)
    mk = lambda: torch.randn((s, n), device=cuda_device, generator=gen)
    p, t, mu, nu = mk(), mk(), mk() * 1e-3, mk().square() * 1e-3
    st = common.AdamState(mu, nu, count=3)
    rp, rt, rst = p.clone(), t.clone(), common.AdamState(mu.clone(),
                                                         nu.clone(), 3)
    before = fused_opt.adam_polyak.launches
    for _ in range(5):
        g = mk() * 1e-3
        fused_opt.adam_polyak_many([(st, p, t, g, 1e-3)], 0.01)
        fused_opt.adam_polyak_plain(rp, rt, rst.mu, rst.nu, g,
                                    *fused_opt.bias_corrections(rst.count),
                                    1e-3, 0.01)
        rst.count += 1
    torch.cuda.synchronize()
    assert fused_opt.adam_polyak.launches - before == 5
    for got, want in ((p, rp), (t, rt), (st.mu, rst.mu), (st.nu, rst.nu)):
        assert torch.equal(got, want)


@pytest.mark.cuda
def test_two_launches_per_update_at_16_seeds(cuda_device):
    """The fused update of 16 seeds in lockstep launches the kernel twice
    (the actor; both critics as one segment each), like one seed's."""
    from cm3_tpu_torch import bench
    nn = NNConfig(Q_conv_f=2, Q_n_h1_1=16, Q_n_h1_2=8, Q_n_h2=16,
                  A_conv_f=2, A_n_h1=16, A_n_h2=12)
    program = list(bench.train_program(16, 8, True, cuda_device, nn))
    bench.train_blocks(program, 0, 0, warmup=1)
    before = fused_opt.adam_polyak.launches
    bench.train_blocks(program, 2, 1, warmup=0)
    assert fused_opt.adam_polyak.launches - before == 2 * 2 * 8
    assert program[1].actor.flat.shape[0] == 16


def _spec(case):
    kw, goal_green = ROLLOUT_CASES[case]
    return cp.make_spec(CheckersEnvConfig(max_steps=50, **kw), goal_green)


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(ROLLOUT_CASES))
@pytest.mark.parametrize("batch", [1, 255, 4096 + 37])
def test_rollout_kernel_fed_matches_plain(cuda_device, case, batch):
    """The CUDA rollout on fed actions (ragged batches) against the
    plain version on the card: episodes exactly, reward sums to atol
    1e-5 (the same float32 adds in the same order)."""
    spec = _spec(case)
    n = len(spec.init_pos)
    gen = torch.Generator(device=cuda_device).manual_seed(batch)
    acts = torch.randint(0, 5, (130, n, batch), device=cuda_device,
                         dtype=torch.int32, generator=gen)
    before = cr.rollout_actions.launches
    rew, ep = cr.rollout_actions(spec, acts)
    p_rew, p_ep = cr.rollout_actions_plain(spec, acts)
    torch.cuda.synchronize()
    assert cr.rollout_actions.launches == before + 1
    assert torch.equal(ep, p_ep)
    torch.testing.assert_close(rew, p_rew, rtol=0, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(ROLLOUT_CASES))
def test_rollout_kernel_prng_matches_plain(cuda_device, case):
    """The Philox variant draws the same bits as the plain version: the
    kernel equals it exactly, on the card and on the CPU."""
    spec = _spec(case)
    before = cr.rollout_prng.launches
    rew, ep = cr.rollout_prng(spec, 3000, 170, seed=11, device=cuda_device)
    p_rew, p_ep = cr.rollout_prng_plain(spec, 3000, 170, 11, cuda_device)
    h_rew, h_ep = cr.rollout_prng(spec, 3000, 170, seed=11, device="cpu")
    torch.cuda.synchronize()
    assert cr.rollout_prng.launches == before + 1
    for r, e in ((p_rew, p_ep), (h_rew, h_ep)):
        assert torch.equal(rew.cpu(), r.cpu())
        assert torch.equal(ep.cpu(), e.cpu())
    assert int(ep.min()) >= 3                 # 170 steps, cap 50


@pytest.mark.cuda
@pytest.mark.parametrize("tau", [0.0, 0.01, 1.0])
@pytest.mark.parametrize("n", [1, 3, 1000, 8193, 39009, 149645])
def test_polyak_kernel_matches_plain(cuda_device, n, tau):
    """The CUDA C++ Polyak kernel against the plain version, bit for bit
    (rtol 0, atol 0: both round the two products and the sum once each
    in float32)."""
    gen = torch.Generator(device=cuda_device).manual_seed(n)
    t = torch.randn(n, device=cuda_device, generator=gen)
    m = torch.randn(n, device=cuda_device, generator=gen)
    want = polyak.polyak_update_plain(t.clone(), m, tau)
    before = polyak.polyak_update.launches
    polyak.polyak_update(t, m, tau)
    torch.cuda.synchronize()
    assert polyak.polyak_update.launches == before + 1
    assert torch.equal(t, want)


@pytest.mark.cuda
@pytest.mark.parametrize("offs", [(1, 0), (0, 3), (2, 2)])
def test_polyak_kernel_on_offset_views(cuda_device, offs):
    """Views 1-3 floats into their allocations: bit for bit."""
    gen = torch.Generator(device=cuda_device).manual_seed(sum(offs))
    t, m = (_view(8193, off, gen, cuda_device) for off in offs)
    want = polyak.polyak_update_plain(t.clone(), m, 0.01)
    polyak.polyak_update(t, m, 0.01)
    torch.cuda.synchronize()
    assert torch.equal(t, want)


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(SOA_CASES))
@pytest.mark.parametrize("batch", [1, 4096 + 37])
def test_soa_rollout_kernel_fed_matches_plain(cuda_device, case, batch):
    """The CUDA particle and roadway rollouts on fed actions (ragged
    batches, T = 130: more than two episodes) against the plain version
    on the card: episodes and reward sums equal exactly (the kernel
    rounds every operation as eager PyTorch does, and takes sqrt, exp
    and log1p from the same CUDA math library)."""
    mod, cfg = SOA_CASES[case]
    gen = torch.Generator(device=cuda_device).manual_seed(batch)
    acts = torch.randint(0, 5, (130, cfg.n_agents, batch),
                         device=cuda_device, dtype=torch.int32, generator=gen)
    before = mod.rollout_actions.launches
    rew, ep = mod.rollout_actions(cfg, acts)
    p_rew, p_ep = mod.rollout_actions_plain(cfg, acts)
    torch.cuda.synchronize()
    assert mod.rollout_actions.launches == before + 1
    assert torch.equal(ep, p_ep)
    assert torch.equal(rew, p_rew)
    assert int(ep.min()) >= 2


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(SOA_CASES))
def test_soa_rollout_kernel_prng_matches_plain(cuda_device, case):
    """The Philox variant draws the same bits as the plain version: the
    kernel equals it exactly on the card; against the plain version on
    the CPU the episodes are equal and the reward sums agree to rtol
    1e-5, atol 1e-3 (PyTorch's CPU exp and log1p are other
    approximations than CUDA's; roadway has none and is equal)."""
    mod, cfg = SOA_CASES[case]
    before = mod.rollout_prng.launches
    rew, ep = mod.rollout_prng(cfg, 3000, 170, seed=11, device=cuda_device)
    p_rew, p_ep = mod.rollout_prng_plain(cfg, 3000, 170, 11, cuda_device)
    h_rew, h_ep = mod.rollout_prng(cfg, 3000, 170, seed=11, device="cpu")
    torch.cuda.synchronize()
    assert mod.rollout_prng.launches == before + 1
    assert torch.equal(rew, p_rew) and torch.equal(ep, p_ep)
    assert torch.equal(ep.cpu(), h_ep)
    torch.testing.assert_close(rew.cpu(), h_rew, rtol=1e-5, atol=1e-3)
    if mod is rr:
        assert torch.equal(rew.cpu(), h_rew)


@pytest.mark.cuda
@pytest.mark.parametrize("fed", [True, False])
def test_particle_kernel_from_contact_range_matches_plain(cuda_device, fed):
    """Four agents starting within contact range, so that contact terms
    and pairs at the far threshold are common: the kernel equals the
    plain version on the card bit for bit (B = 4096 + 37, T = 130), fed
    and with Philox draws."""
    cfg, b, t = PARTICLE_NEAR, 4096 + 37, 130
    if fed:
        gen = torch.Generator(device=cuda_device).manual_seed(7)
        acts = torch.randint(0, 5, (t, 4, b), device=cuda_device,
                             dtype=torch.int32, generator=gen)
        got, want = pr.rollout_actions(cfg, acts), \
            pr.rollout_actions_plain(cfg, acts)
    else:
        got = pr.rollout_prng(cfg, b, t, seed=13, device=cuda_device)
        want = pr.rollout_prng_plain(cfg, b, t, 13, cuda_device)
    torch.cuda.synchronize()
    assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])
    assert int(got[1].min()) >= 3                 # 130 steps, cap 33


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(THRESHOLD_CFGS))
def test_particle_thresholds_hold_under_cuda_math(cuda_device, name):
    """On the 2 x 4096 floats around each threshold, with the card's
    sqrt, exp and log1p: ``d2 < hit_d2`` is the plain collision test,
    and from ``far_d2`` on the plain contact formula gives ``pen == 0``
    and force terms of exactly 0."""
    from cm3_tpu_torch.envs import particle_soa as ps

    cfg = ParticleEnvConfig(**THRESHOLD_CFGS[name])
    dmin = 2 * cfg.agent_size

    def walk(threshold):
        bits = int(np.float32(threshold).view(np.int32))
        return torch.arange(bits - 4096, bits + 4096, dtype=torch.int32,
                            device=cuda_device).view(torch.float32)

    hit = pr.hit_d2(dmin)
    d2 = walk(hit)
    assert torch.equal(d2 < float(hit), ps.sqrt(d2) < dmin)
    far = walk(pr.far_d2(cfg))[4096:]
    k = torch.full((), cfg.contact_margin, dtype=torch.float32,
                   device=cuda_device)
    dist = ps.sqrt(far)
    pen = ps.logaddexp0(-(dist - dmin) / k) * cfg.contact_margin
    scale = cfg.contact_force * pen / dist
    assert bool((pen == 0).all()) and bool((dist * scale == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("mod,n_agents", [(cr, 2), (cr, 1), (pr, 4),
                                          (pr, 2), (pr, 1), (rr, 2),
                                          (rr, 1)])
def test_rollout_kernels_build_without_spills(cuda_device, mod, n_agents):
    """Each rollout kernel as built: registers within the SM's budget,
    at least one resident block per SM, no local memory (spills)."""
    for fed in (False, True):
        o = mod.occupancy(n_agents, fed)
        assert 0 < o["registers"] <= 255 and o["blocks_per_sm"] >= 1
        assert o["local_bytes"] == 0, o


@pytest.mark.cuda
@pytest.mark.parametrize("mod", [fused_opt, polyak])
def test_flat_update_kernels_fill_the_card_without_spills(cuda_device, mod):
    """The flat-update kernels as built: 128 threads a block, at least
    8 warps resident per SM, no local memory (the segment table is read
    at constant indices)."""
    o = mod.occupancy()
    assert o["threads"] == 128 and o["blocks_per_sm"] * 128 // 32 >= 8, o
    assert 0 < o["registers"] <= 255 and o["local_bytes"] == 0, o


# ------------------------------------------------------------------ #
# the curriculum: the graft, checkpoints, the actor freeze, the runner
# ------------------------------------------------------------------ #


def _small_nn():
    from cm3_tpu_torch.core import config
    return config.NNConfig(Q_conv_f=2, Q_n_h1_1=16, Q_n_h1_2=8, Q_n_h2=16,
                           A_conv_f=2, A_n_h1=16, A_n_h2=12)


def _alg(dev, n_agents, n_seeds=None, **kw):
    from cm3_tpu_torch.algs.cm3 import CM3
    from cm3_tpu_torch.core import config
    from cm3_tpu_torch.envs.checkers import Checkers
    env = Checkers(config.checkers_env_config(n_agents), device=dev)
    return CM3("checkers", env.spec(),
               config.AlgConfig(n_agents=n_agents, stage=n_agents, **kw),
               _small_nn(), device=dev, n_seeds=n_seeds)


@pytest.mark.cuda
@pytest.mark.parametrize("n_seeds", [None, 3])
def test_graft_and_checkpoint_round_trip_on_card(cuda_device, tmp_path,
                                                 n_seeds):
    """The stage-2 graft on the card (into one seed, or into each of
    three stacked): the shared leaves equal stage 1's bit for bit,
    Q_credit's equal Q_global's, targets equal mains; the card's graft
    equals the CPU's; a save/restore round trip on the card is bit for
    bit."""
    from cm3_tpu_torch.core import prng
    from cm3_tpu_torch.train import checkpoint
    out = {}
    for dev in (cuda_device, torch.device("cpu")):
        s1 = _alg(dev, 1).init_state(prng.root_key(1))
        a2 = _alg(dev, 2)
        singles = [checkpoint.stage2_init_cm3(
            a2.init_state(prng.root_key(2 + i)), s1.actor, s1.qg)
            for i in range(n_seeds or 1)]
        st = (singles[0] if n_seeds is None else checkpoint.stack_states(
            a2.for_seeds(n_seeds), singles))
        out[dev.type] = st
        for one in singles:
            for net, src in ((one.actor, s1.actor), (one.qg, s1.qg),
                             (one.qc, one.qg)):
                views = checkpoint.named_views(src)
                for name, v in checkpoint.named_views(net).items():
                    if "stage2" not in name.split("."):
                        assert torch.equal(v, views[name]), name
            for name in ("actor", "qg", "qc"):
                assert torch.equal(getattr(one, name).flat,
                                   getattr(one, name + "_tgt").flat)
    for name in ("actor", "actor_tgt", "qg", "qg_tgt", "qc", "qc_tgt"):
        assert torch.equal(getattr(out["cuda"], name).flat.cpu(),
                           getattr(out["cpu"], name).flat), name
    path = str(tmp_path / "ckpt")
    st = out["cuda"]
    st.opt_qg.mu.normal_()
    st.opt_qg.count, st.step = 5, 7
    checkpoint.save(path, st)
    alg = _alg(cuda_device, 2, n_seeds)
    back = checkpoint.restore(path, alg.empty_state())
    for name in ("actor", "actor_tgt", "qg", "qg_tgt", "qc", "qc_tgt"):
        assert getattr(back, name).flat.device.type == "cuda"
        assert torch.equal(getattr(back, name).flat,
                           getattr(st, name).flat), name
    assert torch.equal(back.opt_qg.mu, st.opt_qg.mu)
    assert (back.opt_qg.count, back.step) == (5, 7)


@pytest.mark.cuda
def test_fused_freeze_on_card_matches_cpu(cuda_device):
    """The small chunk with the actor frozen for 2 of its 4 updates on
    the fused path: on the card every update makes two fused launches
    (the critics; the actor's under its device predicate, off while
    frozen) and one Polyak launch (the actor's target, under the frozen
    predicate); the CPU runs the plain versions and launches nothing;
    the states agree at rtol 1e-4, atol 1e-5."""
    out, u = _small_chunks(cuda_device, actor_freeze_updates=2)
    (ts_c, n_c, p_c), (ts_h, n_h, p_h) = out["cuda"], out["cpu"]
    assert (n_c, p_c) == (2 * u, u) and (n_h, p_h) == (0, 0)
    assert ts_c.opt_actor.count == ts_h.opt_actor.count == u - 2
    for name in ("actor", "actor_tgt", "qg", "qg_tgt", "qc", "qc_tgt"):
        torch.testing.assert_close(getattr(ts_c, name).flat.cpu(),
                                   getattr(ts_h, name).flat, rtol=1e-4,
                                   atol=1e-5)


@pytest.mark.cuda
def test_runner_curriculum_on_card(cuda_device, tmp_path, monkeypatch):
    """A tiny curriculum through the runner on the card: stage 1 (optax),
    then stage 2 grafted from it on the fused path with the actor frozen
    for 2 updates (both kernels launched), the V ablation, and a resume
    from the autosave; each writes its logs and ``model_final``."""
    import os
    from cm3_tpu_torch.core import config
    from cm3_tpu_torch.train import checkpoint, runner
    monkeypatch.setattr(runner, "_nn_config", lambda m, e, s: _small_nn())
    m = config.load_json("master.json")
    m.update(n_envs=8, seed=5, N_train=60, period=30, N_eval=2,
             pretrain_episodes=8, batch_size=16, buffer_size=256,
             steps_per_train=4, updates_per_chunk=1, dir_name="s1",
             dir_restore="s1")
    wd = str(tmp_path)
    runner.train_function(dict(m, stage=1), wd, verbose=False)
    b1, b3 = fused_opt.adam_polyak.launches, polyak.polyak_update.launches
    ts, stats = runner.train_function(
        dict(m, stage=2, dir_name="s2", train_from_nothing=0, fused_opt=1,
             actor_freeze_updates=2), wd, verbose=False)
    # the freeze is a device predicate: B1 twice and B3 once per update
    assert polyak.polyak_update.launches - b3 == ts.step
    assert fused_opt.adam_polyak.launches - b1 == 2 * ts.step
    assert ts.actor.flat.device.type == "cuda"
    runner.train_function(dict(m, stage=2, dir_name="v", use_Q_credit=0,
                               use_V=1, train_from_nothing=0), wd,
                          verbose=False)
    _, st2 = runner.train_function(
        dict(m, stage=2, dir_name="s2", train_from_nothing=0, fused_opt=1,
             auto_resume=1, require_resume=1, N_train=120), wd,
        verbose=False)
    assert st2["history"][0]["episode"] > stats["episodes"]
    for d in ("s1", "s2", "v"):
        assert checkpoint.exists(os.path.join(wd, "saved", d, "model_final"))
        assert os.path.isfile(os.path.join(wd, "log", d, "log_century.csv"))


# the baselines and QMIX: (alg_name, AlgConfig options)
OTHER_CONFIGS = {
    "qmix": ("qmix", {}), "qmix_ref": ("qmix", dict(qmix_ref_bug=True)),
    "coma": ("coma", dict(use_Q=True)),
    "iac": ("iac", dict(use_V=True, IAC=True)),
    "central_v": ("coma", dict(use_V=True)),
    "blend": ("coma", dict(use_Q=True, use_V=True)),
}


def _other_chunks(cuda_device, name, s=None, e=8, b=16, u=3):
    """A fill and a training chunk of ``OTHER_CONFIGS[name]`` at small
    width (one seed, or ``s`` in lockstep) on the card and on the CPU,
    from the same parameters with the same fed draws."""
    from cm3_tpu_torch.algs.baseline import Baseline
    from cm3_tpu_torch.algs.qmix import QMIX
    from cm3_tpu_torch.core import config, prng
    from cm3_tpu_torch.envs.checkers import Checkers
    from cm3_tpu_torch.train.experiments import make_hooks
    from cm3_tpu_torch.train.offpolicy import OffPolicyDriver, init_rollout

    alg_name, opts = OTHER_CONFIGS[name]
    qmix = alg_name == "qmix"
    lead = () if s is None else (s,)
    rng = np.random.default_rng(len(name))
    fill = [rng.integers(0, 5, lead + (e, 2)) for _ in range(10)]
    act, unif = [], []
    for _ in range(10):
        if qmix:
            act.append(rng.integers(0, 5, lead + (e, 2)))
            unif.append(rng.random(lead + (e, 2)).astype(np.float32))
        else:
            act.append(rng.gumbel(size=lead + (e, 2, 5)).astype(np.float32))
    idx = [rng.integers(0, 20 * e, lead + (b,)) for _ in range(u)]
    upd = [] if qmix else [rng.gumbel(size=lead + (b, 2, 5)).astype(
        np.float32) for _ in range(u)]
    nn = NNConfig(**dict(vars(_small_nn()), Q_units=16, V_conv_f=2,
                         V_n_h1_1=16, V_n_h1_2=8, V_n_h2=16))
    eps = torch.tensor([0.1, 0.2, 0.3])[:s] if s else 0.3
    out = {}
    for dev in (cuda_device, torch.device("cpu")):
        env = Checkers(CheckersEnvConfig(max_steps=7), device=dev)
        alg = (QMIX if qmix else Baseline)(
            "checkers", env.spec(),
            config.AlgConfig(n_agents=2, stage=2, alg_name=alg_name, **opts),
            nn, device=dev, n_seeds=s)
        cfg = config.TrainConfig(n_envs=e, batch_size=b, buffer_size=512,
                                 updates_per_chunk=u, episode_log=16)
        drv = OffPolicyDriver(make_hooks("checkers", env), alg, cfg)
        rs = init_rollout(drv.hooks, e, None, 16, n_seeds=s)
        ts = alg.init_state(0 if s is None else list(range(s)))
        buf = drv._replay_init(drv.example_transition(rs))
        draws = (prng.FedDraws(fill + act + idx, device=dev, uniforms=unif)
                 if qmix else prng.FedDraws(fill + idx, act + upd,
                                            device=dev))
        before = fused_opt.adam_polyak.launches
        ts, buf, rs, _ = drv._chunk(ts, buf, rs, eps, draws, False, True)
        ts, buf, rs, m = drv._chunk(ts, buf, rs, eps, draws, True, False)
        assert not any(draws.remaining().values())
        out[dev.type] = (alg, ts, buf, rs, m,
                         fused_opt.adam_polyak.launches - before)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("name,s", [(n, None) for n in sorted(OTHER_CONFIGS)]
                         + [("qmix", 3), ("coma", 3)])
def test_baseline_chunk_on_card_matches_cpu(cuda_device, name, s):
    """The six configurations (QMIX and COMA also with three seeds in
    lockstep): the card equals the CPU after a fill and a training
    chunk at rtol 1e-4, atol 1e-5, as CM3's chunk; the fused kernel is
    never launched (these algorithms run the optax path)."""
    from cm3_tpu_torch.core.tree import tree_leaves
    out = _other_chunks(cuda_device, name, s)
    (alg, ts_c, buf_c, rs_c, m_c, n_c), (_, ts_h, buf_h, rs_h, m_h, n_h) = \
        out["cuda"], out["cpu"]
    assert (n_c, n_h) == (0, 0)
    for k in alg.net_names():
        for got, want in ((getattr(ts_c, k).flat, getattr(ts_h, k).flat),
                          (getattr(ts_c, k + "_tgt").flat,
                           getattr(ts_h, k + "_tgt").flat),
                          (getattr(ts_c, "opt_" + k).mu,
                           getattr(ts_h, "opt_" + k).mu)):
            assert got.device.type == "cuda"
            torch.testing.assert_close(got.cpu(), want, rtol=1e-4,
                                       atol=1e-5)
    for (_, x), (_, y) in zip(tree_leaves(buf_c.data),
                              tree_leaves(buf_h.data)):
        torch.testing.assert_close(x.cpu(), y, rtol=1e-4, atol=1e-5)
    assert torch.equal(rs_c.episodes.cpu(), rs_h.episodes)
    assert set(m_c) == set(m_h)
    for k in m_h:
        torch.testing.assert_close(m_c[k].cpu(), m_h[k], rtol=1e-4,
                                   atol=1e-5)


@pytest.mark.cuda
def test_paper_cells_through_the_runner_on_card(cuda_device, tmp_path,
                                                monkeypatch):
    """``checkers_qmix``, ``checkers_qmix_ref``, ``checkers_coma`` and
    ``checkers_iac`` at narrow widths through ``train_function`` on the
    card: each writes its rows and ``model_final`` and launches no
    fused kernel."""
    import os
    from cm3_tpu_torch.core import config
    from cm3_tpu_torch.train import checkpoint, runner
    monkeypatch.setattr(runner, "_nn_config", lambda m, e, s: NNConfig(
        **dict(vars(_small_nn()), Q_units=16, V_n_h1_1=16, V_n_h2=16)))
    m = config.load_json("master.json")
    m.update(stage=2, n_envs=8, seed=5, N_train=60, period=30, N_eval=2,
             pretrain_episodes=8, batch_size=16, buffer_size=256,
             steps_per_train=4, updates_per_chunk=1)
    wd = str(tmp_path)
    before = fused_opt.adam_polyak.launches
    for d, over in (("q", dict(alg_name="qmix")),
                    ("qb", dict(alg_name="qmix", qmix_ref_bug=1)),
                    ("c", dict(alg_name="coma")), ("i", dict(alg_name="iac"))):
        ts, stats = runner.train_function(dict(m, dir_name=d, **over), wd,
                                          verbose=False)
        assert stats["episodes"] >= 60 and ts.step > 0
        assert checkpoint.exists(os.path.join(wd, "saved", d, "model_final"))
    assert fused_opt.adam_polyak.launches == before


# ------------------------------------------------------------------ #
# particle: the engine, the on-policy driver, QMIX, B1 at its sizes
# ------------------------------------------------------------------ #

# the particle nets at narrow widths
PARTICLE_NN = dict(Q_units=16, V_n_others=8, V_n_h2=12, Actor_n_others=8,
                   Actor_n_h2=12)


def _particle_feed(lead, e, n, steps, updates, b, size, qmix, seed):
    """Seeded draws for a particle driver, per kind in the order it asks
    for them: the first reset, then per env step of a random and a
    policy chunk the actions and the reset's four draws, then per update
    the replay indices and (not QMIX) the a' noise."""
    rng = np.random.default_rng(seed)
    lead = tuple(lead)
    q = {"randint": [], "gumbel": [], "uniform": [], "normal": []}
    f32 = lambda x: x.astype(np.float32)

    def reset():
        pts = lead + (e, n, 2)
        q["uniform"].extend([f32(rng.random(lead + (e,))),
                             f32(rng.uniform(-1, 1, pts)),
                             f32(rng.uniform(-1, 1, pts))])
        q["normal"].append(f32(rng.normal(size=pts)))

    reset()
    for rand in (True, False):
        for _ in range(steps):
            if rand or qmix:
                q["randint"].append(rng.integers(0, 5, lead + (e, n)))
            if qmix and not rand:
                q["uniform"].append(f32(rng.random(lead + (e, n))))
            if not (rand or qmix):
                q["gumbel"].append(f32(rng.gumbel(size=lead + (e, n, 5))))
            reset()
    for _ in range(updates):
        q["randint"].append(rng.integers(0, size, lead + (b,)))
        if not qmix:
            q["gumbel"].append(f32(rng.gumbel(size=lead + (b, n, 5))))
    return q


def _particle_runs(cuda_device, alg_name, s=None, e=8, b=16, u=3,
                   **opts):
    """Four-agent particle (antipodal, episodes of 7 steps, half the
    starts uniform-random) at narrow width on the card and on the CPU
    from the same parameters with the same fed draws: CM3, COMA or IAC
    on-policy (a fill chunk, a policy chunk, a burst of ``u``
    updates), QMIX off-policy (a fill and a training chunk of ``u``
    updates).  Per device (alg, state, replay, rollout, metrics, B1
    launches)."""
    from cm3_tpu_torch.core import config, prng
    from cm3_tpu_torch.train import runner
    from cm3_tpu_torch.train.offpolicy import init_rollout

    qmix = alg_name == "qmix"
    lead = () if s is None else (s,)
    q = _particle_feed(lead, e, 4, 10, u, b, 20 * e, qmix, len(alg_name))
    m = config.load_json("master.json")
    m.update(experiment="particle", particle_config="stage2_antipodal",
             stage=2, n_envs=e, batch_size=b, buffer_size=256, max_steps=7,
             prob_random=0.5, episode_log=16, alg_name=alg_name, epochs=u,
             updates_per_chunk=u, **opts)
    eps = torch.tensor([0.1, 0.2, 0.3])[:s] if s else 0.3
    out = {}
    for dev in (cuda_device, torch.device("cpu")):
        driver, alg, hooks, cfg = runner.build(m, device=dev)
        alg = type(alg)("particle", alg.spec, alg.cfg,
                        NNConfig(**PARTICLE_NN), device=dev, n_seeds=s)
        driver = type(driver)(hooks, alg, cfg)
        draws = prng.FedDraws(q["randint"], q["gumbel"], device=dev,
                              uniforms=q["uniform"], normals=q["normal"])
        rs = init_rollout(hooks, e, draws, 16, n_seeds=s)
        ts = alg.init_state(0 if s is None else list(range(s)))
        buf = driver._replay_init(driver.example_transition(rs))
        before = fused_opt.adam_polyak.launches
        if qmix:
            ts, buf, rs, _ = driver._chunk(ts, buf, rs, eps, draws, False,
                                           True)
            ts, buf, rs, met = driver._chunk(ts, buf, rs, eps, draws, True,
                                             False)
        else:
            buf, rs = driver._rollout_chunk(ts, buf, rs, eps, draws, True)
            buf, rs = driver._rollout_chunk(ts, buf, rs, eps, draws, False)
            ts, met = driver._train_burst(ts, buf, eps, draws)
        assert not any(draws.remaining().values()), draws.remaining()
        torch.cuda.synchronize()
        out[dev.type] = (alg, ts, buf, rs, met,
                         fused_opt.adam_polyak.launches - before)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("alg_name,s,opts", [
    ("cm3", None, dict(fused_opt=1)), ("cm3", None, {}), ("cm3", 3, {}),
    ("cm3", 3, dict(fused_opt=1)), ("coma", None, {}), ("iac", None, {}),
    ("qmix", None, {}), ("qmix", 3, {})],
    ids=["cm3_fused", "cm3", "cm3_seeds", "cm3_fused_seeds", "coma", "iac",
         "qmix", "qmix_seeds"])
def test_particle_onpolicy_burst_on_card_matches_cpu(cuda_device, alg_name,
                                                     s, opts):
    """Particle on the card equals the CPU at rtol 1e-4, atol 1e-5, as
    CM3's Checkers chunk: the replay, the rollout and env state, the
    networks, targets and Adam moments, the metrics; B1 runs 2 launches
    per fused update (one seed or three) and none elsewhere."""
    from cm3_tpu_torch.core.tree import tree_leaves
    out = _particle_runs(cuda_device, alg_name, s, **opts)
    (alg, ts_c, buf_c, rs_c, m_c, n_c), (_, ts_h, buf_h, rs_h, m_h, n_h) = \
        out["cuda"], out["cpu"]
    assert (n_c, n_h) == ((2 * 3 if opts.get("fused_opt") else 0), 0)
    for k in alg.net_names():
        for got, want in ((getattr(ts_c, k).flat, getattr(ts_h, k).flat),
                          (getattr(ts_c, k + "_tgt").flat,
                           getattr(ts_h, k + "_tgt").flat),
                          (getattr(ts_c, "opt_" + k).mu,
                           getattr(ts_h, "opt_" + k).mu)):
            assert got.device.type == "cuda"
            torch.testing.assert_close(got.cpu(), want, rtol=1e-4,
                                       atol=1e-5)
    for (_, x), (_, y) in zip(tree_leaves(buf_c.data),
                              tree_leaves(buf_h.data)):
        torch.testing.assert_close(x.cpu(), y, rtol=1e-4, atol=1e-5)
    for k in ("pos", "vel", "landmarks", "collisions", "reached"):
        torch.testing.assert_close(getattr(rs_c.env_state, k).cpu(),
                                   getattr(rs_h.env_state, k), rtol=1e-4,
                                   atol=1e-5)
    assert torch.equal(rs_c.episodes.cpu(), rs_h.episodes)
    assert set(m_c) == set(m_h)
    for k in m_h:
        torch.testing.assert_close(m_c[k].cpu(), m_h[k], rtol=1e-4,
                                   atol=1e-5)


@pytest.mark.cuda
def test_particle_engine_on_card_matches_cpu(cuda_device):
    """The engine on the card from the same reset draws over 40 steps of
    the same actions: floats at atol 1e-5 (CUDA's exp and log1p are
    other approximations than the CPU's), reach flags, step and
    collision counts and done exactly."""
    from cm3_tpu_torch.core import config
    from cm3_tpu_torch.envs.particle import Particle
    rng = np.random.default_rng(0)
    e = 64
    draws = dict(branch=rng.random(e), agents=rng.uniform(-1, 1, (e, 4, 2)),
                 landmarks=rng.uniform(-1, 1, (e, 4, 2)),
                 noise=rng.normal(size=(e, 4, 2)))
    acts = rng.integers(0, 5, (40, e, 4))
    out = {}
    for dev in (cuda_device, torch.device("cpu")):
        env = Particle(config.particle_env_config("stage2_antipodal",
                                                  prob_random=0.5,
                                                  max_steps=100), device=dev)
        d = {k: torch.tensor(v, dtype=torch.float32) for k, v in
             draws.items()}
        st, ts = env.reset(d)
        traj = []
        for a in acts:
            st, ts = env.step(st, torch.from_numpy(a))
            traj.append((st, ts))
        out[dev.type] = traj
    for (sc, tc), (sh, th) in zip(out["cuda"], out["cpu"]):
        for k in ("pos", "vel"):
            torch.testing.assert_close(getattr(sc, k).cpu(), getattr(sh, k),
                                       rtol=0, atol=1e-5)
        for k in ("reached", "steps", "collisions"):
            assert torch.equal(getattr(sc, k).cpu(), getattr(sh, k)), k
        torch.testing.assert_close(tc.reward_local.cpu(), th.reward_local,
                                   rtol=0, atol=1e-5)
        assert torch.equal(tc.done.cpu(), th.done)
    assert int(out["cpu"][-1][0].collisions.sum()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("sizes", [(14789,), (16704, 15296)],
                         ids=["actor", "critics"])
def test_adam_polyak_at_particle_sizes_matches_plain(cuda_device, sizes):
    """B1 at the particle actor's size (master.json's widths, four
    agents) and at both critics' in one launch, bit for bit against the
    plain version over 5 steps, one launch a step."""
    spec = [(n, i, 1e-3, 0) for i, n in enumerate(sizes)]
    assert _hold_adam(cuda_device, spec, sum(sizes)) == 5


@pytest.mark.cuda
def test_particle_runner_on_card(cuda_device, tmp_path, monkeypatch):
    """A tiny particle curriculum through the runner on the card: stage
    1, stage 2 grafted from it on the fused path with the actor frozen
    for 2 updates (B1 2 per live update, B3 per frozen one), COMA and
    QMIX from nothing (no B1), three seeds in lockstep; each writes its
    logs and ``model_final``."""
    import os
    from cm3_tpu_torch.core import config
    from cm3_tpu_torch.train import checkpoint, runner
    monkeypatch.setattr(runner, "_nn_config",
                        lambda m, e, s: NNConfig(**PARTICLE_NN))
    m = config.load_json("master.json")
    m.update(experiment="particle", n_envs=8, seed=5, N_train=40, period=20,
             N_eval=2, pretrain_episodes=8, batch_size=16, buffer_size=512,
             epochs=3, episodes_per_train=4, max_steps=10, dir_name="s1",
             dir_restore="s1")
    wd = str(tmp_path)
    runner.train_function(dict(m, stage=1), wd, verbose=False)
    s2 = dict(m, stage=2, particle_config="stage2_antipodal")
    b1, b3 = fused_opt.adam_polyak.launches, polyak.polyak_update.launches
    ts, _ = runner.train_function(
        dict(s2, dir_name="s2", train_from_nothing=0, fused_opt=1,
             actor_freeze_updates=2), wd, verbose=False)
    # the freeze is a device predicate: B1 twice and B3 once per update
    assert polyak.polyak_update.launches - b3 == ts.step
    assert fused_opt.adam_polyak.launches - b1 == 2 * ts.step
    assert ts.actor.flat.device.type == "cuda"
    b1 = fused_opt.adam_polyak.launches
    for d, over in (("c", dict(alg_name="coma")),
                    ("q", dict(alg_name="qmix"))):
        ts, st = runner.train_function(dict(s2, dir_name=d, **over), wd,
                                       verbose=False)
        assert st["episodes"] >= 40 and ts.step > 0
    assert fused_opt.adam_polyak.launches == b1
    ts, hist = runner.train_multiseed(
        dict(s2, dir_name="v", train_from_nothing=0, vmapped_seeds=1,
             n_seeds=3), wd)
    assert ts.actor.flat.shape[0] == 3 and (hist[-1]["episode"] >= 40).all()
    for d in ("s1", "s2", "c", "q", "v_1"):
        assert checkpoint.exists(os.path.join(wd, "saved", d, "model_final"))
        assert os.path.isfile(os.path.join(wd, "log", d, "log_century.csv"))


# --------------------------------------------------------------------- #
# roadway and the dual buffer
# --------------------------------------------------------------------- #

# a short road at top speed: episodes of 4-6 steps, so that they end
# inside chunks (and with a slab of 3, lose their tails)
SHORT_ROAD = dict(init_position=(150.0, 150.0), speed=(50.0, 50.0))


def _mod_draws(q, dev):
    """``FedDraws`` of the queues ``q`` whose draws below a device bound
    are the fed integers modulo it (the dual buffer's fills, the same on
    the card and on the CPU while the runs agree)."""
    from cm3_tpu_torch.core import prng

    class ModDraws(prng.FedDraws):
        def randint_below(self, shape, high):
            x = self._next("randint", shape, torch.int64).to(self.device)
            return torch.remainder(x, high[..., None])
    return ModDraws(q["randint"], q["gumbel"], device=dev,
                    uniforms=q["uniform"], normals=q["normal"])


def _roadway_feed(lead, e, steps, updates, b, seed, shards=1):
    """Seeded draws for a roadway driver with the dual buffer: the first
    reset (branch, lanes, goal lanes, depart noise), per env step of a
    random and a policy chunk the actions and the reset's draws, per
    update the two memories' indices (large integers; per shard with
    ``shards``) and the a' noise."""
    rng = np.random.default_rng(seed)
    lead = tuple(lead)
    q = {"randint": [], "gumbel": [], "uniform": [], "normal": []}
    cars = lead + (e, 2)

    def reset():
        q["uniform"].append(rng.random(lead + (e,)).astype(np.float32))
        q["randint"] += [rng.integers(0, 4, cars), rng.integers(0, 4, cars)]
        q["normal"].append(rng.normal(size=cars).astype(np.float32))

    reset()
    for rand in (True, False):
        for _ in range(steps):
            if rand:
                q["randint"].append(rng.integers(0, 5, cars))
            else:
                q["gumbel"].append(rng.gumbel(size=cars + (5,)).astype(
                    np.float32))
            reset()
    idx = (b,) if shards == 1 else (shards, b // shards)
    for _ in range(updates):
        q["randint"] += [rng.integers(0, 1 << 40, lead + idx)
                         for _ in range(2)]
        q["gumbel"].append(rng.gumbel(size=lead + (b, 2, 5)).astype(
            np.float32))
    return q


def _roadway_dual_runs(cuda_device, s=None, fused=False, e=8, b=16, u=3,
                       shards=1):
    """CM3 on two cars with the dual buffer (a slab of 3; in ``shards``
    shards) on the card and on the CPU from the same parameters with the
    same fed draws: a fill and a training chunk of ``u`` updates.  Per
    device (alg, state, buffer, rollout, metrics, B1 launches)."""
    import dataclasses
    from cm3_tpu_torch.algs.cm3 import CM3
    from cm3_tpu_torch.core import config
    from cm3_tpu_torch.envs.roadway import Roadway
    from cm3_tpu_torch.train.experiments import make_hooks
    from cm3_tpu_torch.train.offpolicy import OffPolicyDriver, init_rollout

    lead = () if s is None else (s,)
    q = _roadway_feed(lead, e, 10, u, b, 7 + (s or 0), shards)
    eps = torch.tensor([0.1, 0.2, 0.3])[:s] if s else 0.3
    out = {}
    for dev in (cuda_device, torch.device("cpu")):
        env = Roadway(dataclasses.replace(config.roadway_env_config(2, 0.5),
                                          **SHORT_ROAD), device=dev)
        alg = CM3("roadway", env.spec(), config.AlgConfig(
            n_agents=2, stage=2, fused_opt=fused), device=dev, n_seeds=s)
        cfg = config.TrainConfig(n_envs=e, batch_size=b, buffer_size=256,
                                 dual_buffer=True, max_steps=3,
                                 steps_per_train=10, updates_per_chunk=u,
                                 episode_log=16, threshold=12.0,
                                 replay_shards=shards)
        driver = OffPolicyDriver(make_hooks("roadway", env, 12.0), alg, cfg)
        draws = _mod_draws(q, dev)
        rs = init_rollout(driver.hooks, e, draws, 16, n_seeds=s)
        ts = alg.init_state(0 if s is None else list(range(s)))
        buf, rs = driver.init_replay(rs)
        before = fused_opt.adam_polyak.launches
        ts, buf, rs, _ = driver._chunk(ts, buf, rs, eps, draws, False, True)
        ts, buf, rs, met = driver._chunk(ts, buf, rs, eps, draws, True,
                                         False)
        assert not any(draws.remaining().values()), draws.remaining()
        torch.cuda.synchronize()
        out[dev.type] = (alg, ts, buf, rs, met,
                         fused_opt.adam_polyak.launches - before)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("s,fused", [(None, True), (None, False), (3, False),
                                     (3, True)],
                         ids=["fused", "optax", "seeds", "fused_seeds"])
def test_roadway_dual_chunk_on_card_matches_cpu(cuda_device, s, fused):
    """Roadway CM3 with the dual buffer on the card equals the CPU at
    rtol 1e-4, atol 1e-5: both memories below their capacity and their
    per-seed cursors, the slab, the env state (floats, sublanes, flags),
    the networks, targets and Adam moments, the metrics; B1 runs 2
    launches per fused update."""
    _hold_dual_runs(_roadway_dual_runs(cuda_device, s, fused), s, fused)


@pytest.mark.cuda
@pytest.mark.parametrize("s", [None, 3], ids=["one_seed", "seeds"])
def test_sharded_dual_chunk_on_card_matches_cpu(cuda_device, s):
    """The same with both memories in 2 shards (the fused path for one
    seed, optax for three): every shard's cursors and rows, the rest as
    above."""
    out = _roadway_dual_runs(cuda_device, s, s is None, shards=2)
    assert tuple(out["cpu"][2].bad.size.shape) == (() if s is None
                                                   else (s,)) + (2,)
    _hold_dual_runs(out, s, s is None)


def _hold_dual_runs(out, s, fused):
    from cm3_tpu_torch.core.tree import tree_leaves
    (alg, ts_c, buf_c, rs_c, m_c, n_c), (_, ts_h, buf_h, rs_h, m_h, n_h) = \
        out["cuda"], out["cpu"]
    assert (n_c, n_h) == ((2 * 3 if fused else 0), 0)
    close = lambda a, b: torch.testing.assert_close(a.cpu(), b, rtol=1e-4,
                                                    atol=1e-5)
    for k in alg.net_names():
        close(getattr(ts_c, k).flat, getattr(ts_h, k).flat)
        close(getattr(ts_c, k + "_tgt").flat, getattr(ts_h, k + "_tgt").flat)
        close(getattr(ts_c, "opt_" + k).mu, getattr(ts_h, "opt_" + k).mu)
    lead = 0 if s is None else 1
    for rc, rh in ((buf_c.bad, buf_h.bad), (buf_c.good, buf_h.good)):
        assert torch.equal(rc.size.cpu(), rh.size)
        assert torch.equal(rc.insert.cpu(), rh.insert)
        k = rh.insert.dim()
        for (_, x), (_, y) in zip(tree_leaves(rc.data), tree_leaves(rh.data)):
            close(x.narrow(k, 0, rh.capacity), y.narrow(k, 0, rh.capacity))
    assert int(buf_h.bad.size.sum()) > 0 and int(buf_h.good.size.sum()) > 0
    for (_, x), (_, y) in zip(tree_leaves(rs_c.stage),
                              tree_leaves(rs_h.stage)):
        close(x.narrow(lead + 1, 0, 3), y.narrow(lead + 1, 0, 3))
    for k in ("x", "vel", "sublane", "steps", "terminal", "collided",
              "removed"):
        close(getattr(rs_c.env_state, k), getattr(rs_h.env_state, k))
    assert torch.equal(rs_c.episodes.cpu(), rs_h.episodes)
    assert torch.equal(rs_c.stage_t.cpu(), rs_h.stage_t)
    for k in m_h:
        close(m_c[k], m_h[k])


@pytest.mark.cuda
@pytest.mark.parametrize("s", [None, 3], ids=["one_seed", "seeds"])
def test_particle_dual_burst_on_card_matches_cpu(cuda_device, s):
    """Particle CM3 on-policy with the dual buffer (``stage2_cross``
    from uniform starts): a fill chunk, a policy chunk and a burst of 3
    updates on the card equal the CPU at rtol 1e-4, atol 1e-5; the
    discard zeroes every seed's cursors on the card."""
    from cm3_tpu_torch.algs.cm3 import CM3
    from cm3_tpu_torch.core import config
    from cm3_tpu_torch.core.tree import tree_leaves
    from cm3_tpu_torch.envs.particle import Particle
    from cm3_tpu_torch.train.experiments import make_hooks
    from cm3_tpu_torch.train.offpolicy import init_rollout
    from cm3_tpu_torch.train.onpolicy import OnPolicyDriver

    e, b, u = 8, 16, 3
    lead = () if s is None else (s,)
    q = _particle_feed(lead, e, 4, 10, 0, b, 1, False, 11 + (s or 0))
    rng = np.random.default_rng(5)
    for _ in range(u):
        q["randint"] += [rng.integers(0, 1 << 40, lead + (b,))
                         for _ in range(2)]
        q["gumbel"].append(rng.gumbel(size=lead + (b, 4, 5)).astype(
            np.float32))
    eps = torch.tensor([0.1, 0.2, 0.3])[:s] if s else 0.3
    out = {}
    for dev in (cuda_device, torch.device("cpu")):
        env = Particle(config.particle_env_config(
            "stage2_cross", prob_random=1.0, max_steps=7), device=dev)
        alg = CM3("particle", env.spec(), config.AlgConfig(n_agents=4,
                                                          stage=2),
                  NNConfig(**PARTICLE_NN), device=dev, n_seeds=s)
        cfg = config.TrainConfig(n_envs=e, batch_size=b, buffer_size=256,
                                 dual_buffer=True, max_steps=7,
                                 steps_per_train=10, epochs=u,
                                 episode_log=16)
        driver = OnPolicyDriver(make_hooks("particle", env), alg, cfg)
        draws = _mod_draws(q, dev)
        rs = init_rollout(driver.hooks, e, draws, 16, n_seeds=s)
        ts = alg.init_state(0 if s is None else list(range(s)))
        buf, rs = driver.init_replay(rs)
        buf, rs = driver._rollout_chunk(ts, buf, rs, eps, draws, True)
        buf, rs = driver._rollout_chunk(ts, buf, rs, eps, draws, False)
        ts, met = driver._train_burst(ts, buf, eps, draws)
        assert not any(draws.remaining().values()), draws.remaining()
        out[dev.type] = (alg, ts, buf, rs, met, driver)
    (alg, ts_c, buf_c, rs_c, m_c, drv), (_, ts_h, buf_h, rs_h, m_h, _) = \
        out["cuda"], out["cpu"]
    close = lambda a, b: torch.testing.assert_close(a.cpu(), b, rtol=1e-4,
                                                    atol=1e-5)
    for k in alg.net_names():
        close(getattr(ts_c, k).flat, getattr(ts_h, k).flat)
        close(getattr(ts_c, "opt_" + k).mu, getattr(ts_h, "opt_" + k).mu)
    lead_n = 0 if s is None else 1
    for rc, rh in ((buf_c.bad, buf_h.bad), (buf_c.good, buf_h.good)):
        assert torch.equal(rc.size.cpu(), rh.size)
        for (_, x), (_, y) in zip(tree_leaves(rc.data), tree_leaves(rh.data)):
            close(x.narrow(lead_n, 0, 256), y.narrow(lead_n, 0, 256))
    for k in m_h:
        close(m_c[k], m_h[k])
    routed = torch.zeros(2, dtype=torch.int64, device=cuda_device)
    drv.discard(buf_c, routed)
    assert routed.tolist() == [int(buf_h.bad.size.sum()),
                               int(buf_h.good.size.sum())]
    assert not (buf_c.bad.size.any() or buf_c.good.insert.any())


@pytest.mark.cuda
def test_roadway_engine_on_card_matches_cpu(cuda_device):
    """The engine on the card from the same lanes, goal lanes and depart
    noise over 42 filtered steps of the same actions (past the 40-step
    cap): floats at atol 1e-5, filtered actions, sublanes, counts, flags
    and done exactly; the traffic metrics alike."""
    from cm3_tpu_torch.core import config
    from cm3_tpu_torch.envs.roadway import Roadway
    rng = np.random.default_rng(0)
    e = 256
    lanes, goals = rng.integers(0, 4, (e, 2)), rng.integers(0, 4, (e, 2))
    noise = rng.normal(size=(e, 2)).astype(np.float32)
    acts = rng.integers(0, 5, (42, e, 2))
    out = {}
    for dev in (cuda_device, torch.device("cpu")):
        env = Roadway(config.roadway_env_config(2, 0.5), device=dev)
        st, ts = env.reset(dict(lanes=torch.tensor(lanes),
                                goal_lanes=torch.tensor(goals)),
                           torch.tensor(noise))
        traj = []
        for a in acts:
            a = env.check_actions(st, torch.tensor(a))
            st, ts = env.step(st, a)
            traj.append((a, st, ts, env.avg_speed(st), env.count_close(st),
                         env.count_success(st)))
        out[dev.type] = traj
    for (a_c, s_c, t_c, *m_c), (a_h, s_h, t_h, *m_h) in zip(out["cuda"],
                                                            out["cpu"]):
        assert torch.equal(a_c.cpu(), a_h)
        for k in ("sublane", "steps", "terminal", "collided", "removed"):
            assert torch.equal(getattr(s_c, k).cpu(), getattr(s_h, k)), k
        for k in ("x", "vel"):
            torch.testing.assert_close(getattr(s_c, k).cpu(), getattr(s_h, k),
                                       rtol=0, atol=1e-5)
        for k in ("self_t", "self_v"):
            torch.testing.assert_close(t_c.obs[k].cpu(), t_h.obs[k], rtol=0,
                                       atol=1e-5)
        torch.testing.assert_close(t_c.reward_local.cpu(), t_h.reward_local,
                                   rtol=0, atol=1e-5)
        assert torch.equal(t_c.done.cpu(), t_h.done)
        for x, y in zip(m_c, m_h):
            torch.testing.assert_close(x.cpu(), y, rtol=0, atol=1e-6)


@pytest.mark.cuda
def test_adam_polyak_at_roadway_sizes_matches_plain(cuda_device):
    """B1 at roadway CM3's stage-2 sizes (the actor 39,009 floats; both
    critics, 103,041 + 102,785, in one launch) bit for bit."""
    _hold_adam(cuda_device, [(39009, 0, 1e-4, 0)], 31)
    _hold_adam(cuda_device, [(103041, 0, 1e-3, 0), (102785, 0, 1e-3, 0)], 32)


@pytest.mark.cuda
def test_roadway_runner_on_card(cuda_device, tmp_path, monkeypatch):
    """A tiny roadway curriculum through the runner on the card: stage 1,
    stage 2 grafted from it with the dual buffer on the fused path with
    the actor frozen for 2 updates (B1 2 per live update, B3 per frozen
    one), QMIX from nothing (no B1), three seeds in lockstep with the
    dual buffer; each writes its logs and ``model_final``, and the dual
    rows carry ``n_bad``/``n_good``."""
    import os
    from cm3_tpu_torch.core import config
    from cm3_tpu_torch.train import checkpoint, runner
    monkeypatch.setattr(runner, "_nn_config",
                        lambda m, e, s: NNConfig(**PARTICLE_NN))
    m = config.load_json("master.json")
    m.update(experiment="roadway", n_envs=8, seed=5, N_train=40, period=20,
             N_eval=2, pretrain_episodes=8, batch_size=16, buffer_size=512,
             updates_per_chunk=2, dir_name="s1", dir_restore="s1",
             prob_random=1.0)
    wd = str(tmp_path)
    runner.train_function(dict(m, stage=1), wd, verbose=False)
    s2 = dict(m, stage=2, dual_buffer=1)
    b1, b3 = fused_opt.adam_polyak.launches, polyak.polyak_update.launches
    ts, st = runner.train_function(
        dict(s2, dir_name="s2", train_from_nothing=0, fused_opt=1,
             actor_freeze_updates=2), wd, verbose=False)
    # the freeze is a device predicate: B1 twice and B3 once per update
    assert polyak.polyak_update.launches - b3 == ts.step
    assert fused_opt.adam_polyak.launches - b1 == 2 * ts.step
    assert ts.actor.flat.device.type == "cuda"
    row = st["history"][-1]
    assert row["n_bad"] + row["n_good"] > 0
    b1 = fused_opt.adam_polyak.launches
    ts, st = runner.train_function(dict(s2, dir_name="q", alg_name="qmix"),
                                   wd, verbose=False)
    assert st["episodes"] >= 40 and ts.step > 0
    assert fused_opt.adam_polyak.launches == b1
    ts, hist = runner.train_multiseed(
        dict(s2, dir_name="v", train_from_nothing=0, vmapped_seeds=1,
             n_seeds=3), wd)
    assert ts.actor.flat.shape[0] == 3 and (hist[-1]["episode"] >= 40).all()
    for d in ("s1", "s2", "q", "v_1"):
        assert checkpoint.exists(os.path.join(wd, "saved", d, "model_final"))
        assert os.path.isfile(os.path.join(wd, "log", d, "log_century.csv"))


@pytest.mark.cuda
def test_roadway_stage1_learning_check(cuda_device):
    """The first learning check on the port, in the setting of the JAX
    package's ``tests/test_roadway_training.py``: roadway stage 1 (one
    car, ``prob_random`` 1.0), 8 envs, CM3 (optax), 2,000 episodes; the
    greedy evaluation's global return over 16 episodes before and after,
    printed beside that test's bar (> 8.5 and above the start).  It
    reports the numbers; it asserts only that they are finite and that
    the run trained."""
    from cm3_tpu_torch.algs.cm3 import CM3
    from cm3_tpu_torch.core import config, prng
    from cm3_tpu_torch.envs.roadway import Roadway
    from cm3_tpu_torch.train.experiments import make_hooks
    from cm3_tpu_torch.train.offpolicy import OffPolicyDriver
    env_cfg = RoadwayEnvConfig(
        n_agents=1, goal_lane=(0,), goal_pos=(190.0,), speed=(30.0,),
        lane=(0,), init_position=(0.0,), depart_mean=(0.0,),
        depart_stdev=0.4, prob_random=1.0)
    env = Roadway(env_cfg, device=cuda_device)
    alg = CM3("roadway", env.spec(), config.AlgConfig(n_agents=1, stage=1),
              device=cuda_device)
    cfg = config.TrainConfig(n_envs=8, batch_size=64, buffer_size=8192,
                             pretrain_episodes=16, steps_per_train=10,
                             period=400, N_eval=16,
                             max_steps=env_cfg.max_step + 2,
                             epsilon_div=400.0)
    driver = OffPolicyDriver(make_hooks("roadway", env), alg, cfg)
    ts = alg.init_state(prng.root_key(1))
    ev = lambda: prng.GeneratorDraws(prng.generator(7, cuda_device))
    _, g0, _ = driver.evaluate(ts, ev(), 16)
    t0 = time.time()
    ts, stats = driver.run(ts, key=0, n_episodes=2000)
    wall = time.time() - t0
    _, g1, _ = driver.evaluate(ts, ev(), 16)
    g0, g1 = float(g0), float(g1)
    print(f"\nroadway stage-1 learning check on "
          f"{torch.cuda.get_device_name(0)}: eval global return {g0:.3f} "
          f"-> {g1:.3f} after {stats['episodes']} episodes ({ts.step} "
          f"updates, {wall:.1f} s); JAX's bar: > 8.5 and above the start: "
          f"{'met' if g1 > 8.5 and g1 > g0 else 'missed'}")
    assert np.isfinite([g0, g1]).all() and ts.step > 0


# ------------------------------------------------------------------ #
# the K-chunk schedule: device predicates, no host sync, card == CPU
# ------------------------------------------------------------------ #


@pytest.mark.cuda
@pytest.mark.parametrize("apply", [None, 0, 1])
@pytest.mark.parametrize("off", [0, 3])
def test_flat_updates_under_a_device_predicate(cuda_device, apply, off):
    """B1 over two segments in one launch and B3 under the int32 device
    predicate 0, 1 or none against their plain versions on the card,
    bit for bit over 3 steps (predicate 0: every buffer as it was, the
    counts too), on aligned views and views 3 floats in."""
    gen = torch.Generator(device=cuda_device).manual_seed(off)
    pred = (None if apply is None else
            torch.full((), apply, dtype=torch.int32, device=cuda_device))
    spec = [(8193, 3, 1e-3), (1003, 0, 1e-4)]
    nets = []
    for n, count, lr in spec:
        p, t, mu, nu = (_view(n, off, gen, cuda_device) for _ in range(4))
        nu.square_().mul_(1e-3)
        nets.append((common.AdamState(mu, nu, count), p, t, lr))
    refs = [(common.AdamState(st.mu.clone(), st.nu.clone(), st.count),
             p.clone(), t.clone(), lr) for st, p, t, lr in nets]
    for _ in range(3):
        gs = [_view(n, off, gen, cuda_device) for n, _, _ in spec]
        fused_opt.adam_polyak_many([(st, p, t, g, lr) for (st, p, t, lr), g
                                    in zip(nets, gs)], 0.01, apply=pred)
        for (st, p, t, lr), g in zip(refs, gs):
            tile = common.advance(st, pred)
            fused_opt.adam_polyak_plain(p, t, st.mu, st.nu, g, tile[0],
                                        tile[1], lr, 0.01, apply=pred)
    torch.cuda.synchronize()
    for (st, p, t, _), (rst, rp, rt, _), (_, count, _) in zip(nets, refs,
                                                              spec):
        assert st.count == rst.count == count + 3 * (
            1 if apply is None else apply)
        for got, want in ((p, rp), (t, rt), (st.mu, rst.mu),
                          (st.nu, rst.nu)):
            assert torch.equal(got, want)
    t, m = (_view(8193, off, gen, cuda_device) for _ in range(2))
    want = polyak.polyak_update_plain(t.clone(), m, 0.01, pred)
    polyak.polyak_update(t, m, 0.01, pred)
    assert torch.equal(t, want)


def _kchunk_program(dev, kind, pretrain, **alg_kw):
    """A one-env K-chunk program at small width on ``dev``: (driver,
    state, replay, rollout state)."""
    import dataclasses
    from cm3_tpu_torch.core import config, prng
    from cm3_tpu_torch.train import runner
    from cm3_tpu_torch.train.offpolicy import init_rollout
    m = config.load_json("master.json")
    m.update(experiment="checkers", stage=2, n_envs=1, chunks_per_sync=8,
             batch_size=16, buffer_size=256, alg_name=kind, **alg_kw)
    driver, alg, _, cfg = runner.build(m, device=dev)
    driver.cfg = dataclasses.replace(cfg, pretrain_episodes=pretrain)
    draws = prng.GeneratorDraws(prng.generator(prng.root_key(1), dev))
    rs = init_rollout(driver.hooks, 1, draws)
    buf, rs = driver.init_replay(rs)
    return driver, alg.init_state(prng.root_key(2)), buf, rs, draws


@pytest.mark.cuda
@pytest.mark.parametrize("kind,alg_kw", [
    ("cm3", {}), ("cm3", dict(fused_opt=1, actor_freeze_updates=3)),
    ("qmix", {})])
def test_kchunk_dispatch_makes_no_host_sync(cuda_device, monkeypatch, kind,
                                            alg_kw):
    """A K = 8 dispatch across the fill -> train boundary under
    ``set_sync_debug_mode("error")`` after a warm dispatch: no host sync
    (CM3 optax, CM3 fused with the actor frozen, QMIX)."""
    import dataclasses
    from cm3_tpu_torch.core import config
    from cm3_tpu_torch.train import runner
    monkeypatch.setattr(runner, "_nn_config",
                        lambda m, e, s: config.NNConfig(**dict(
                            _small_nn().__dict__, Q_units=16)))
    driver, ts, buf, rs, draws = _kchunk_program(cuda_device, kind, 10 ** 6,
                                                 **alg_kw)
    ts, buf, rs, _ = driver._chunks_scanned(ts, buf, rs, draws, 8)
    driver.cfg = dataclasses.replace(driver.cfg,
                                     pretrain_episodes=int(rs.episodes) + 1)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        ts, buf, rs, m = driver._chunks_scanned(ts, buf, rs, draws, 8)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert 0 < int(m["trained_chunks"]) < 8


def _hold_printed(got, want, atol, what):
    """``got`` against ``want`` at rtol 1e-4 and ``atol``; prints the
    largest difference (the readings behind the tolerance)."""
    torch.testing.assert_close(got, want, rtol=1e-4, atol=atol,
                               msg=lambda m: f"{what}: {m}")
    print(f"{what}: max abs difference "
          f"{float((got - want).abs().max()):.3g} of {want.numel()} floats")


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [3, 4, 5])
@pytest.mark.parametrize("kind,alg_kw", [
    ("cm3", {}), ("cm3", dict(fused_opt=1, actor_freeze_updates=1)),
    ("qmix", {})])
def test_kchunk_dispatch_on_card_matches_cpu(cuda_device, monkeypatch, kind,
                                             alg_kw, seed):
    """One K = 6 dispatch across the fill -> train boundary (the first
    episode, 33 steps at most, ends inside the dispatch) on the card and
    on the CPU from the same state with the same fed draws (three seeds
    of draws): the networks, the moments, the counts and the metrics at
    rtol 1e-4, atol 1e-5, QMIX's state at atol 1e-4.  Measured on an
    NVIDIA H100 after the dispatch's 2 updates: QMIX's parameters
    3.68e-5 apart on 2 of 90,329 floats with the draws of seed 3 (the
    rest within 1e-5), within 3.02e-6 and 3.76e-7 with those of seeds 4
    and 5, its first moments within 5.72e-6; CM3's within 6e-8.  The
    two are agent-net weights whose first gradient is a cancelling sum
    next to Adam's eps (1.81e-8 on the card, 1.60e-8 on the CPU; the
    second ~0.025 on both), so the first step lr * g / (|g| + eps)
    differs by ~3% of lr, as against JAX (``torch_parity.QMIX_TOL``)."""
    from cm3_tpu_torch.core import config, prng
    from cm3_tpu_torch.train import runner
    monkeypatch.setattr(runner, "_nn_config",
                        lambda m, e, s: config.NNConfig(**dict(
                            _small_nn().__dict__, Q_units=16)))
    rng = np.random.default_rng(seed)
    qmix = kind == "qmix"
    randints, gumbels, uniforms = [], [], []
    for c in range(6):
        for _ in range(10):
            if qmix:
                randints.append(rng.integers(0, 5, (1, 2)))
                uniforms.append(rng.random((1, 2)).astype(np.float32))
            else:
                gumbels.append(rng.gumbel(size=(1, 2, 5)).astype(np.float32))
            randints.append(rng.integers(0, 5, (1, 2)))
        randints.append(rng.integers(0, 10 * (c + 1), 16))
        if not qmix:
            gumbels.append(rng.gumbel(size=(16, 2, 5)).astype(np.float32))
    out = []
    for dev in (cuda_device, torch.device("cpu")):
        driver, ts, buf, rs, _ = _kchunk_program(dev, kind, 1, **alg_kw)
        draws = prng.FedDraws(randints, gumbels, device=dev,
                              uniforms=uniforms if qmix else None)
        out.append(driver._chunks_scanned(ts, buf, rs, draws, 6))
        assert not any(draws.remaining().values())
    (ts_c, _, _, m_c), (ts_h, _, _, m_h) = out
    trained = int(m_h["trained_chunks"])
    assert int(m_c["trained_chunks"]) == trained and 0 < trained < 6
    assert int(ts_c.step) == int(ts_h.step) == trained
    atol = 1e-4 if qmix else 1e-5
    for name in driver.alg.net_names():
        o_c, o_h = getattr(ts_c, "opt_" + name), getattr(ts_h, "opt_" + name)
        assert int(o_c.count) == int(o_h.count)
        for suffix in ("", "_tgt"):
            _hold_printed(getattr(ts_c, name + suffix).flat.cpu(),
                          getattr(ts_h, name + suffix).flat, atol,
                          f"{kind} seed {seed} {name}{suffix}")
        _hold_printed(o_c.mu.cpu(), o_h.mu, atol,
                      f"{kind} seed {seed} {name} mu")
    for k in m_h:
        torch.testing.assert_close(m_c[k].cpu(), m_h[k], rtol=1e-4,
                                   atol=1e-5)


# --------------------------------------------------------------------- #
# the tools: the gradient snapshot and roadway's occlusion
# --------------------------------------------------------------------- #


def _grad_program(dev, n_seeds, **alg_kw):
    """CM3 stage 2 at small width on ``dev`` (fused unless ``alg_kw``
    says otherwise), a state trained one update, and a batch of 32 real
    transitions (and its a' noise) from a seeded numpy stream, the same
    on every device."""
    from cm3_tpu_torch.algs.cm3 import CM3
    from cm3_tpu_torch.core import config, prng
    from cm3_tpu_torch.envs.checkers import Checkers
    from cm3_tpu_torch.train.experiments import flat_call, make_hooks
    from cm3_tpu_torch.train.offpolicy import OffPolicyDriver, init_rollout

    b = 32
    lead = (b,) if n_seeds is None else (n_seeds, b)
    rng = np.random.default_rng(1)
    nn = config.NNConfig(Q_conv_f=2, Q_n_h1_1=16, Q_n_h1_2=8, Q_n_h2=16,
                         A_conv_f=2, A_n_h1=16, A_n_h2=12)
    env = Checkers(config.CheckersEnvConfig(n_agents=2, max_steps=7),
                   device=dev)
    alg = CM3("checkers", env.spec(), config.AlgConfig(
        n_agents=2, stage=2, **dict(dict(fused_opt=True), **alg_kw)), nn,
        device=dev, n_seeds=n_seeds)
    drv = OffPolicyDriver(make_hooks("checkers", env), alg,
                          config.TrainConfig(n_envs=b))
    rs = init_rollout(drv.hooks, b, n_seeds=n_seeds)
    a = torch.tensor(rng.integers(0, 5, lead + (2,)), device=dev)
    ts_next = flat_call(env.step, lead, rs.env_state, a)[1]
    batch = drv._transition(rs, a, ts_next)
    noise = lambda: torch.tensor(rng.gumbel(size=lead + (2, 5)).astype(
        np.float32), device=dev)
    eps = 0.2 if n_seeds is None else torch.tensor(
        [0.1, 0.2, 0.3][:n_seeds], device=dev)
    ts = alg.init_state(prng.root_key(0) if n_seeds is None
                        else [prng.root_key(i) for i in range(n_seeds)])
    ts, _ = alg.update(ts, batch, eps, noise())
    return alg, ts, batch, eps, noise()


@pytest.mark.cuda
@pytest.mark.parametrize("n_seeds", [None, 3], ids=["one_seed", "three"])
def test_update_grads_on_card_match_cpu(cuda_device, n_seeds):
    """``update(..., with_grads=True)``'s raw gradients (``Policy``,
    ``Q_global``, ``Q_credit``) on the card equal the CPU's at rtol 1e-4,
    atol 1e-5 (float32 sums in other orders, after one Adam step)."""
    out = {}
    for dev in (cuda_device, torch.device("cpu")):
        alg, ts, batch, eps, z = _grad_program(dev, n_seeds)
        out[dev.type] = alg.update(ts, batch, eps, z, with_grads=True)[1]
    g_c, g_h = out["cuda"]["grads"], out["cpu"]["grads"]
    assert sorted(g_c) == sorted(g_h) == ["Policy", "Q_credit", "Q_global"]
    for k in g_h:
        assert g_c[k].shape == g_h[k].shape
        torch.testing.assert_close(g_c[k].cpu(), g_h[k], rtol=1e-4,
                                   atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("freeze", [0, 5])
def test_snapshot_leaves_state_on_card(cuda_device, freeze, monkeypatch):
    """``grad_snapshot`` on the card: every network, target, Adam moment,
    Adam count and the step bit for bit as before; it launches B1 twice
    (the critics, the actor) and with the actor frozen B3 once, on its
    own copy of the state; its gradients equal the next real update's
    bit for bit under deterministic cuDNN (its default convolution
    backward adds in a varying order)."""
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    monkeypatch.setattr(torch.backends.cudnn, "benchmark", False)
    alg, ts, batch, eps, z = _grad_program(cuda_device, None,
                                           actor_freeze_updates=freeze)
    names = [f for f in ts.__dataclass_fields__ if f != "step"
             and getattr(ts, f) is not None]
    before = {}
    for f in names:
        v = getattr(ts, f)
        before[f] = ((v.mu.clone(), v.nu.clone(), v.count)
                     if f.startswith("opt_") else (v.flat.clone(),))
    step = ts.step
    b1, b3 = fused_opt.adam_polyak.launches, polyak.polyak_update.launches
    grads = alg.grad_snapshot(ts, batch, eps, z)
    torch.cuda.synchronize()
    assert fused_opt.adam_polyak.launches - b1 == 2
    assert polyak.polyak_update.launches - b3 == (1 if freeze else 0)
    assert ts.step is step
    for f in names:
        v = getattr(ts, f)
        now = ((v.mu, v.nu, v.count) if f.startswith("opt_")
               else (v.flat,))
        for x, y in zip(now, before[f]):
            assert torch.equal(x, y), f
        if f.startswith("opt_"):
            assert v.count is before[f][2], f
    _, m = alg.update(ts, batch, eps, z, with_grads=True)
    for k in grads:
        assert torch.equal(grads[k], m["grads"][k]), k


@pytest.mark.cuda
def test_occluded_roadway_observation_on_card_matches_cpu(cuda_device):
    """``occlusion=True`` on the card from the same lanes, goal lanes and
    depart noise over 42 filtered steps: the occluded grids and every
    other output as ``test_roadway_engine_on_card_matches_cpu`` holds
    them (the shadow masks, -1 cells, exactly), with cells shadowed; the
    traffic surfaces ``avg_speeds``, ``count_remaining`` and
    ``global_tensor`` alike."""
    import dataclasses
    from cm3_tpu_torch.core import config
    from cm3_tpu_torch.envs.roadway import Roadway
    rng = np.random.default_rng(0)
    e = 256
    lanes, goals = rng.integers(0, 4, (e, 2)), rng.integers(0, 4, (e, 2))
    noise = rng.normal(size=(e, 2)).astype(np.float32)
    acts = rng.integers(0, 5, (42, e, 2))
    out = {}
    for dev in (cuda_device, torch.device("cpu")):
        env = Roadway(dataclasses.replace(config.roadway_env_config(2, 0.5),
                                          occlusion=True), device=dev)
        st, ts = env.reset(dict(lanes=torch.tensor(lanes),
                                goal_lanes=torch.tensor(goals)),
                           torch.tensor(noise))
        traj = []
        for a in acts:
            a = env.check_actions(st, torch.tensor(a))
            st, ts = env.step(st, a)
            traj.append((a, st, ts, env.avg_speeds(st),
                         env.count_remaining(st), env.global_tensor(st, a)))
        out[dev.type] = traj
    shadowed = 0
    for (a_c, s_c, t_c, *m_c), (a_h, s_h, t_h, *m_h) in zip(out["cuda"],
                                                            out["cpu"]):
        assert torch.equal(a_c.cpu(), a_h)
        for k in ("sublane", "steps", "terminal", "collided", "removed"):
            assert torch.equal(getattr(s_c, k).cpu(), getattr(s_h, k)), k
        assert torch.equal(t_c.obs["self_t"][..., 0].cpu() == -1.0,
                           t_h.obs["self_t"][..., 0] == -1.0)
        shadowed += int((t_h.obs["self_t"][..., 0] == -1.0).sum())
        for k in ("self_t", "self_v"):
            torch.testing.assert_close(t_c.obs[k].cpu(), t_h.obs[k], rtol=0,
                                       atol=1e-5)
        for x, y in zip(m_c, m_h):
            torch.testing.assert_close(x.cpu(), y, rtol=0, atol=1e-6)
    assert shadowed > 0


# --------------------------------------------------------------------- #
# the MPE suite
# --------------------------------------------------------------------- #


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["simple", "simple_adversary",
                                  "simple_crypto", "simple_push",
                                  "simple_reference",
                                  "simple_speaker_listener", "simple_spread",
                                  "simple_tag", "simple_world_comm"])
def test_mpe_step_on_card_matches_cpu(cuda_device, name):
    """512 instances of each MPE scenario, 10 steps a path (index and
    multi-head), every step repeated on the CPU from the card's state
    before it with the same draws: positions, velocities, comm state,
    steps and done at rtol / atol 1e-5 (CUDA's expf and log1pf are an
    ulp from the CPU's in the contact force and the boundary penalty);
    observations and rewards likewise where the collision flags agree,
    and a flag that differs lies within 1e-5 of its threshold."""
    from cm3_tpu_torch.core import prng
    from cm3_tpu_torch.envs import mpe
    b, steps = 512, 10
    env_c = mpe.MPEEnv(name, max_steps=8, device=cuda_device)
    env_h = mpe.MPEEnv(name, max_steps=8, device="cpu")
    sc, w = env_h.scenario, env_h.scenario.world
    draws = prng.GeneratorDraws(prng.generator(5, cuda_device))
    reset = env_c.draw_reset((b,), draws)
    cpu = lambda st: mpe.MPEState(**{f: getattr(st, f).cpu() for f in (
        "pos", "vel", "c", "goal", "steps")})
    dmin = mpe._consts(w, torch.device("cpu"))["dist_min"]
    flips = 0
    for path in ("index", "multihead"):
        s, _ = env_c.reset(reset)
        for _ in range(steps):
            if path == "index":
                a = (draws.randint((b, w.n_agents), 5),
                     draws.randint((b, w.n_agents), max(w.dim_c, 1)))
                step = lambda env, st, x: env.step(st, *x)
            else:
                a = (draws.uniform((b, w.n_agents, 5)),
                     draws.uniform((b, w.n_agents, w.dim_c)) if w.dim_c
                     else None)
                step = lambda env, st, x: env.step_multihead(st, *x)
            prev = cpu(s)
            s, (obs, rew, done) = step(env_c, s, a)
            s_h, (obs_h, rew_h, done_h) = step(
                env_h, prev, tuple(None if x is None else x.cpu()
                                   for x in a))
            got = cpu(s)
            flip = sc._collide_mat(got) != sc._collide_mat(s_h)
            if flip.any():
                _, d = mpe._pair_deltas(s_h.pos)
                assert bool(((d - dmin).abs()[flip] < 1e-5).all())
                flips += int(flip.sum())
            same = ~flip.flatten(-2).any(-1)
            for x, y in ((got.pos, s_h.pos), (got.vel, s_h.vel),
                         (got.c, s_h.c), (obs.cpu()[same], obs_h[same]),
                         (rew.cpu()[same], rew_h[same])):
                torch.testing.assert_close(x, y, rtol=1e-5, atol=1e-5)
            assert torch.equal(got.steps, s_h.steps)
            assert torch.equal(done.cpu(), done_h)
        assert bool(done.all())
    print(f"{name}: {flips} collision flags differ")


# ------------------------------------------------------------------ #
# multi-process runs (parallel/)
# ------------------------------------------------------------------ #


def _dist_cases():
    """``tests/torch_dist_cases.py`` by its own name (another package
    named ``tests`` may be installed where these tests run)."""
    import os
    import sys
    here = os.path.dirname(os.path.abspath(__file__))
    if here not in sys.path:
        sys.path.insert(0, here)
    import torch_dist_cases
    return torch_dist_cases


def _free_port():
    import socket
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.mark.cuda
@pytest.mark.parametrize("shards", [1, 2])
def test_world_one_nccl_mesh_on_card_matches_no_mesh(cuda_device, shards,
                                                     monkeypatch):
    """A data mesh of this process alone over NCCL (a TCP store on a free
    local port): the worker's program (fused) through a fill and a
    training chunk gives the bytes of the run without the mesh under
    deterministic cuDNN, with B1's 2 launches and 2 gradient all-reduces
    an update, one gather an env step and one metric mean."""
    import torch.distributed as tdist
    from cm3_tpu_torch.core import prng
    from cm3_tpu_torch.parallel import mesh as meshlib
    from cm3_tpu_torch.train.offpolicy import init_rollout
    dc = _dist_cases()

    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    tdist.init_process_group("nccl", init_method="tcp://localhost:"
                             f"{_free_port()}", world_size=1, rank=0)
    try:
        out = []
        for mesh in (None, meshlib.make_mesh(1)):
            hooks, alg, driver = dc.program(
                "checkers", dict(fused_opt=True), dict(replay_shards=shards),
                device=cuda_device)
            ts = alg.init_state(prng.root_key(2))
            draws = prng.GeneratorDraws(prng.generator(prng.root_key(4),
                                                       cuda_device))
            rs = init_rollout(hooks, 16, draws, 16)
            buf, rs = driver.init_replay(rs)
            if mesh is not None:
                assert mesh.device_mesh.device_type == "cuda"
                ts, buf, rs = meshlib.shard_driver_state(mesh, ts, buf, rs,
                                                         16, shards)
            ts, buf, rs, _ = driver._chunk(ts, buf, rs, 0.3, draws, False,
                                           True)
            meshlib.COUNTS.clear()
            fused_opt.adam_polyak.launches = 0
            ts, buf, rs, m = driver._chunk(ts, buf, rs, 0.3, draws, True,
                                           False)
            out.append(((dc.state_arrays(alg, ts), dc.host(rs), dc.host(m)),
                        dict(meshlib.COUNTS),
                        fused_opt.adam_polyak.launches))
    finally:
        tdist.destroy_process_group()
    dc.equal_on_ranks([o[0] for o in out], "mesh of one")
    u = dc.WORKER_TRAIN["updates_per_chunk"]
    assert [o[2] for o in out] == [2 * u, 2 * u]
    assert out[0][1] == {}
    assert out[1][1] == {"grad": 2 * u, "all_gather":
                         dc.WORKER_TRAIN["steps_per_train"],
                         "all_reduce": 1}


def _card_cases(tmp):
    """The worker's program in 2 shards (fused) and in one ring (optax),
    from seeded parameters with random fed draws, and stage 1 with 2
    seeds over the ranks, on the card."""
    from cm3_tpu_torch.core import prng
    from cm3_tpu_torch.train import checkpoint
    dc = _dist_cases()

    e, b, spt, u = 16, 32, 5, 2
    cases = {}
    for shards, fused in ((2, True), (1, False)):
        rng = np.random.default_rng(shards)
        randints = [rng.integers(0, 5, (e, 2)) for _ in range(spt)]
        gumbels = [rng.gumbel(size=(e, 2, 5)).astype(np.float32)
                   for _ in range(spt)]
        size = 2 * spt * e
        for _ in range(u):
            randints.append(rng.integers(0, size // shards,
                                         (shards, b // shards))
                            if shards > 1 else rng.integers(0, size, (b,)))
            gumbels.append(rng.gumbel(size=(b, 2, 5)).astype(np.float32))
        _, alg, _ = dc.program("checkers", dict(fused_opt=fused))
        start = f"{tmp}/start-{shards}"
        checkpoint.save(start, alg.init_state(prng.root_key(1)))
        cases[f"D{shards}"] = ("chunks", dict(
            kind="checkers", device="cuda:0", alg=dict(fused_opt=fused),
            train=dict(replay_shards=shards, episode_log=16), start=start,
            draws=[randints, gumbels, [], []],
            steps=[("chunk", False, True), ("chunk", True, False)]), "data")
    cases["seeds"] = ("seeds", dict(
        kind="checkers", n_seeds=2, device="cuda:0", alg=dict(n_agents=1),
        train=dict(n_envs=8, buffer_size=256, batch_size=16,
                   steps_per_train=5, updates_per_chunk=2,
                   pretrain_episodes=8, period=16, N_train=32, N_eval=3,
                   max_steps=5, episode_log=16)), "seed")
    return cases


@pytest.mark.cuda
def test_two_gloo_ranks_on_card_match_single_process(cuda_device, tmp_path):
    """Two ranks sharing the card over gloo with CUDA tensors: the data
    axis in 2 shards (fused, B1 on each rank) and in one ring (optax),
    and stage 1 with 2 seeds over the ranks.  The ranks agree bit for
    bit; the run from their blocks equals the single-process run on the
    card at rtol 1e-4 / atol 1e-5 (cuDNN's weight gradient adds in a
    varying order), its rows too; no gradient collective on the seed
    axis."""
    dc = _dist_cases()

    cases = _card_cases(str(tmp_path))
    launched = dc.launch(cases, str(tmp_path), device="cuda:0")
    ranks = dc.collect(launched, timeout=600)
    single = {name: dc.CASES[case](args, None)
              for name, (case, args, _) in cases.items()}
    for name in ("D2", "D1"):
        steps = dc.joined_steps(cases, ranks, name)
        for i, (got, want) in enumerate(zip(steps, single[name]["steps"])):
            dc.close(got["rs"], want["rs"], f"{name} {i} ", 1e-4, 1e-5)
            dc.close(got["buf"], dc.ring_rows(want["buf"]), f"{name} {i} ",
                     1e-4, 1e-5)
            if "ts" in want:
                dc.close(got["ts"], want["ts"], f"{name} {i} ", 1e-4, 1e-5)
        assert ranks[name][0]["counts"]["grad"] == 4
    dc.equal_on_ranks([r["rows"] for r in ranks["seeds"]], "rows")
    dc.close(ranks["seeds"][0]["rows"], single["seeds"]["rows"], "rows ",
             1e-4, 1e-5)
    for r, res in enumerate(ranks["seeds"]):
        want = {k: (v[r:r + 1] if np.ndim(v) else v)
                for k, v in single["seeds"]["ts"].items()}
        dc.close(res["ts"], want, f"seeds rank {r} ", 1e-4, 1e-5)
        assert "grad" not in res["counts"]
