"""The dual bad/good replay buffer (``replay.buffer.init_dual``,
``flush_episodes``, ``sample_dual``, ``reset_dual``) and the off-policy
driver's staging slab against the JAX package's, for one seed and for
three in lockstep, whose flushes add different numbers of rows per seed
(the port keeps each memory's cursor and fill as device tensors per
seed).

The buffer alone: four flushes of random episodes into memories of 24
rows (so that a ring wraps), with every sampling fallback (the good memory
empty, short of half a batch, both full enough, both empty after a
reset), exactly.  The driver: on roadway's short road (episodes of 4-6
steps, or fewer at a collision), a random-fill and a training chunk of
CM3 with the dual buffer, a slab of ``max_steps`` 3, so that every
episode that runs longer loses its tail, its terminal transition
included (JAX's truncation, kept), and 3 updates that sample both
memories; for one seed against ``_chunk`` and for three against
``jax.vmap(_chunk)``.  Tolerances as ``test_torch_roadway_chunk.py``'s.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cm3_tpu.replay import buffer as jreplay
from cm3_tpu_torch import convert
from cm3_tpu_torch.core.tree import tree_leaves, tree_map
from cm3_tpu_torch.replay import buffer as treplay
from cm3_tpu_torch.train.offpolicy import init_rollout
from tests import torch_parity as tp
from tests.test_torch_roadway_chunk import (ATOL, B, CAP, E, EPS, RTOL, SPT,
                                            U, close, drivers, hold_rollout,
                                            jax_start)

tp.set_torch_cpu()

S, T_SLAB, RING = 3, 3, 24


# --------------------------------------------------------------------- #
# the buffer alone
# --------------------------------------------------------------------- #


def _episodes(rng, lead, e=6, t=5):
    """A random staged slab [*lead, e, t] (a dict of two leaves), the
    valid mask of ended episodes' prefixes and the routing flags."""
    stage = {"x": rng.normal(size=lead + (e, t, 2)).astype(np.float32),
             "a": rng.integers(0, 5, lead + (e, t))}
    ended = rng.random(lead + (e,)) < 0.7
    length = rng.integers(1, t + 1, lead + (e,))
    valid = ended[..., None] & (np.arange(t) < length[..., None])
    return stage, valid, rng.random(lead + (e,)) < 0.5


def _hold_memory(tring, jring, lead):
    np.testing.assert_array_equal(tring.size.numpy(), np.asarray(jring.size))
    np.testing.assert_array_equal(tring.insert.numpy(),
                                  np.asarray(jring.insert))
    for path, leaf in tree_leaves(tring.data):
        np.testing.assert_array_equal(
            leaf.narrow(len(lead), 0, RING).numpy(),
            np.asarray(jring.data[path[0]]), err_msg=str(path))


def _sample_both(jbuf, tbuf, key, lead):
    """JAX's ``sample_dual`` from ``key`` and the port's from the same
    indices (each memory's draw below its fill)."""
    fn = lambda st, k: jreplay.sample_dual(st, k, 10)
    keys = jax.random.split(key, lead[0]) if lead else key[None]
    want = jax.vmap(fn)(jbuf, keys) if lead else fn(jbuf, key)
    per_seed = [jax.random.split(k) for k in keys]
    sizes = lambda ring: np.maximum(np.asarray(ring.size).reshape(-1), 1)
    idx_bad = np.stack([np.asarray(jax.random.randint(ks[0], (10,), 0, s))
                        for ks, s in zip(per_seed, sizes(jbuf.bad))])
    idx_good = np.stack([np.asarray(jax.random.randint(ks[1], (10,), 0, s))
                         for ks, s in zip(per_seed, sizes(jbuf.good))])
    if not lead:
        idx_bad, idx_good = idx_bad[0], idx_good[0]
    got = treplay.sample_dual(tbuf, torch.from_numpy(idx_bad),
                              torch.from_numpy(idx_good))
    for k in ("x", "a"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)


@pytest.mark.parametrize("lead", [(), (S,)], ids=["one_seed", "seeds"])
def test_flush_sample_reset_match_jax(lead):
    rng = np.random.default_rng(len(lead))
    stage0, _, _ = _episodes(rng, ())
    example = {k: np.asarray(v[0, 0]) for k, v in stage0.items()}
    jinit = lambda: jreplay.init_dual(
        jax.tree_util.tree_map(jnp.asarray, example), RING)
    jbuf = jax.vmap(lambda _: jinit())(jnp.arange(S)) if lead else jinit()
    tbuf = treplay.init_dual(tree_map(torch.from_numpy, example), RING,
                             lead[0] if lead else None)
    jflush = jax.jit(jax.vmap(jreplay.flush_episodes) if lead
                     else jreplay.flush_episodes)
    key = jax.random.PRNGKey(0)
    counts = []
    for i in range(4):
        stage, valid, bad = _episodes(rng, lead)
        if i == 0:
            bad[...] = True                    # the good memory stays empty
        jbuf = jflush(jbuf, stage, valid, bad)
        treplay.flush_episodes(tbuf, tree_map(torch.from_numpy, stage),
                               torch.from_numpy(valid),
                               torch.from_numpy(bad))
        counts.append(valid.reshape(lead + (-1,)).sum(-1))
        _hold_memory(tbuf.bad, jbuf.bad, lead)
        _hold_memory(tbuf.good, jbuf.good, lead)
        _sample_both(jbuf, tbuf, jax.random.fold_in(key, i), lead)
    # a memory filled and wrapped
    assert any(bool((r.size == RING).any()) for r in (tbuf.bad, tbuf.good))
    if lead:
        assert len(set(np.asarray(counts[0]).tolist())) > 1
    jbuf = (jax.vmap(jreplay.reset_dual) if lead else jreplay.reset_dual)(
        jbuf)
    treplay.reset_dual(tbuf)
    for ring in (tbuf.bad, tbuf.good):
        assert not ring.size.any() and not ring.insert.any()
    _sample_both(jbuf, tbuf, jax.random.fold_in(key, 9), lead)


# --------------------------------------------------------------------- #
# the driver's slab and the dual chunk
# --------------------------------------------------------------------- #

DUAL = dict(dual_buffer=True, max_steps=T_SLAB, threshold=12.0)


def _hold_dual(jbuf, tbuf, jrs, trs, lead=()):
    """Both memories (rows below each seed's fill, cursors), the slab's
    first ``T_SLAB`` columns and the episode lengths."""
    for name in ("bad", "good"):
        jr, tr = getattr(jbuf, name), getattr(tbuf, name)
        np.testing.assert_array_equal(tr.size.numpy(), np.asarray(jr.size))
        np.testing.assert_array_equal(tr.insert.numpy(),
                                      np.asarray(jr.insert))
        sizes = np.asarray(jr.size).reshape(-1)
        for path, leaf in tree_leaves(tr.data):
            want = jr.data
            for k in path:
                want = want[k]
            want = np.asarray(want).reshape((-1,) + np.shape(want)[
                len(lead):])
            got = leaf.reshape((-1,) + tuple(leaf.shape[len(lead):]))
            for s, n in enumerate(sizes):
                close(got[s, :n], want[s, :n], f"{name} {'/'.join(path)}")
    close(trs.stage_t, jrs.stage_t, "stage_t")
    for path, leaf in tree_leaves(trs.stage):
        want = jrs.stage
        for k in path:
            want = want[k]
        close(leaf.narrow(len(lead) + 1, 0, T_SLAB), want,
              "stage " + "/".join(path))


def _truncations(td):
    """Wrap the port's slab flush to count episodes that ended after
    filling the slab (their tail dropped)."""
    seen = {"truncated": 0}
    flush = td._stage_and_flush

    def wrapped(buf, rs, tr, done, env_state, ep_ret):
        seen["truncated"] += int((done & (rs.stage_t == T_SLAB)).sum())
        return flush(buf, rs, tr, done, env_state, ep_ret)
    td._stage_and_flush = wrapped
    return seen


def test_dual_chunk_matches_jax():
    """One seed: the fill and the training chunk, the memories, slab
    and rollout after each, then the state after the 3 updates; the
    period row's counts read the fills."""
    _, _, jd, td, ta = drivers(train=DUAL)
    k0, k1, k2 = (jax.random.PRNGKey(i) for i in (3, 31, 32))
    jts, jbuf, jrs = jax_start(jd, k0)
    tts = convert.state_from_jax(ta, jax.device_get(jts))
    jts, jbuf, jrs, _ = jd._chunk_fill(jts, jbuf, jrs, EPS, k1)
    fill = jax.device_get((jbuf, jrs))
    jts, jbuf, jrs, jm = jd._chunk_train(jts, jbuf, jrs, EPS, k2)
    sizes = (int(jbuf.bad.size), int(jbuf.good.size))
    d = tp.RoadwayDraws(2)
    d.reset(k0, E)
    d.chunk(k1, E, SPT, True)
    d.chunk(k2, E, SPT, False, U, B, sizes)
    draws = d.fed()
    trs = init_rollout(td.hooks, E, draws, 16)
    tbuf, trs = td.init_replay(trs)
    seen = _truncations(td)
    tts, tbuf, trs, _ = td._chunk(tts, tbuf, trs, EPS, draws, False, True)
    _hold_dual(fill[0], tbuf, fill[1], trs)
    hold_rollout(fill[1], trs)
    tts, tbuf, trs, tm = td._chunk(tts, tbuf, trs, EPS, draws, True, False)
    assert not any(draws.remaining().values()), draws.remaining()
    _hold_dual(jbuf, tbuf, jrs, trs)
    hold_rollout(jrs, trs)
    tp.hold_states(tts, convert.state_from_jax(ta, jax.device_get(jts)),
                   ta.net_names(), **tp.ROADWAY_QC_TOL)
    for k in tm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=RTOL,
                                   atol=ATOL, err_msg=k)
    assert min(sizes) > 0 and seen["truncated"] > 0
    assert td._routed(tbuf) == sizes
    assert sum(sizes) <= T_SLAB * int(trs.episodes)


def test_dual_chunk_seeds_match_jax_vmap():
    """Three seeds in lockstep against ``jax.vmap`` of JAX's chunk, each
    seed its own keys and epsilon: the per-seed fills differ, and each
    seed's memories, slab, rollout and state equal JAX's."""
    _, _, jd, td, ta = drivers(n_seeds=S, train=DUAL)
    eps = np.array([0.1, 0.3, 0.5], np.float32)
    k0s = [jax.random.PRNGKey(40 + i) for i in range(S)]
    starts = [jax_start(jd, k) for k in k0s]
    jts, jbuf, jrs = jax.tree_util.tree_map(lambda *x: jnp.stack(x), *starts)
    tts = convert.state_from_jax(ta, jax.device_get(jts))
    keys = [[jax.random.PRNGKey(100 * i + c) for i in range(S)]
            for c in (1, 2)]
    chunk = lambda train, rand: jax.jit(jax.vmap(
        lambda t, b, r, e, k: jd._chunk(t, b, r, e, k, train, rand)))
    jeps = jnp.asarray(eps)
    jts, jbuf, jrs, _ = chunk(False, True)(jts, jbuf, jrs, jeps,
                                           jnp.stack(keys[0]))
    fill = jax.device_get((jbuf, jrs))
    jts, jbuf, jrs, jm = chunk(True, False)(jts, jbuf, jrs, jeps,
                                            jnp.stack(keys[1]))
    per = []
    for i in range(S):
        d = tp.RoadwayDraws(2)
        d.reset(k0s[i], E)
        d.chunk(keys[0][i], E, SPT, True)
        d.chunk(keys[1][i], E, SPT, False, U, B,
                (int(jbuf.bad.size[i]), int(jbuf.good.size[i])))
        per.append(d)
    draws = tp.stacked_particle_draws(per)
    trs = init_rollout(td.hooks, E, draws, 16, n_seeds=S)
    tbuf, trs = td.init_replay(trs)
    teps = torch.from_numpy(eps)
    tts, tbuf, trs, _ = td._chunk(tts, tbuf, trs, teps, draws, False, True)
    _hold_dual(fill[0], tbuf, fill[1], trs, lead=(S,))
    tts, tbuf, trs, tm = td._chunk(tts, tbuf, trs, teps, draws, True, False)
    assert not any(draws.remaining().values()), draws.remaining()
    _hold_dual(jbuf, tbuf, jrs, trs, lead=(S,))
    hold_rollout(jrs, trs)
    tp.hold_states(tts, convert.state_from_jax(ta, jax.device_get(jts)),
                   ta.net_names(), **tp.ROADWAY_QC_TOL)
    for k, v in tm.items():
        np.testing.assert_allclose(v.numpy(), np.asarray(jm[k]), rtol=RTOL,
                                   atol=ATOL, err_msg=k)
    fills = tbuf.bad.size + tbuf.good.size
    assert len(set(fills.tolist())) > 1
