"""The port's rings with device cursors against ``cm3_tpu.replay.buffer``:
the masked add (``add_batch(..., valid=)``), ``add_episode``,
``sample_subsequence`` with fed starts, and shard-local replay
(``init_sharded``, ``add_batch_sharded``, ``sample_sharded`` and the
dual buffer's ``*_sharded``), for one ring set and for three seeds in
lockstep (against ``jax.vmap``), exactly: rows, cursors and samples
are integers and copied floats, so every value is bit for bit.

Mirrors ``tests/test_replay.py:38-101`` and the one-device cases of
``tests/test_parallel.py:106-124`` (JAX's sharded ops called directly,
without a mesh): rows of env block d land in shard d, each shard
samples batch/D rows from its own contents, drawn below its own fill
(the draws JAX makes: ``jax.random.split(key, D)``, one ``randint`` per
shard), merged shard-major."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cm3_tpu.replay import buffer as jreplay
from cm3_tpu_torch.core.tree import tree_leaves
from cm3_tpu_torch.replay import buffer as treplay
from tests import torch_parity as tp

tp.set_torch_cpu()

S = 3


def _ex():
    return {"x": np.zeros(3, np.float32), "a": np.int32(0)}


def _t(tree):
    return tp.to_torch(tree)


def _rows(rng, lead, e):
    return {"x": rng.normal(size=lead + (e, 3)).astype(np.float32),
            "a": rng.integers(0, 1000, lead + (e,)).astype(np.int32)}


def _hold_ring(tring, jring, k):
    """Cursors and every row below the capacity (the spare row past it
    takes dropped rows) equal; ``k`` leading dims."""
    np.testing.assert_array_equal(tring.size.numpy(), np.asarray(jring.size))
    np.testing.assert_array_equal(tring.insert.numpy(),
                                  np.asarray(jring.insert))
    cap = tring.capacity
    for path, leaf in tree_leaves(tring.data):
        np.testing.assert_array_equal(leaf.narrow(k, 0, cap).numpy(),
                                      np.asarray(jring.data[path[0]]),
                                      err_msg=str(path))


def _hold_tree(got, want):
    for path, leaf in tree_leaves(got):
        np.testing.assert_array_equal(leaf.numpy(),
                                      np.asarray(want[path[0]]),
                                      err_msg=str(path))


def _jax_init(lead, init):
    return jax.vmap(lambda _: init())(jnp.arange(lead[0])) if lead \
        else init()


def _jmap(fn, lead):
    return jax.vmap(fn) if lead else fn


# --------------------------------------------------------------------- #
# the masked add, add_episode and sample_subsequence
# --------------------------------------------------------------------- #


def test_valid_mask_packs_rows():
    """``tests/test_replay.py:38-45``: the valid rows packed in order."""
    tr = {"x": torch.arange(15, dtype=torch.float32).reshape(5, 3),
          "a": torch.arange(5)}
    ring = treplay.init_ring(_t(_ex()), 8)
    treplay.add_batch(ring, tr, torch.tensor([True, False, True, False,
                                              True]))
    assert int(ring.size) == int(ring.insert) == 3
    assert ring.data["a"][:3].tolist() == [0, 2, 4]


@pytest.mark.parametrize("lead", [(), (S,)], ids=["one", "seeds"])
def test_masked_adds_match_jax(lead):
    """Six masked adds of 5 rows into rings of 8 (they wrap), then a
    sample at JAX's indices below the fill."""
    rng = np.random.default_rng(len(lead))
    jring = _jax_init(lead, lambda: jreplay.init(
        jax.tree_util.tree_map(jnp.asarray, _ex()), 8))
    tring = treplay.init_ring(_t(_ex()), 8, lead)
    add = jax.jit(_jmap(jreplay.add_batch, lead))
    for _ in range(6):
        rows, valid = _rows(rng, lead, 5), rng.random(lead + (5,)) < 0.6
        jring = add(jring, rows, valid)
        treplay.add_batch(tring, _t(rows), torch.from_numpy(valid))
        _hold_ring(tring, jring, len(lead))
    key = jax.random.PRNGKey(4)
    keys = jax.random.split(key, S) if lead else key
    want = _jmap(lambda st, k: jreplay.sample(st, k, 7), lead)(jring, keys)
    idx = _jmap(lambda st, k: jax.random.randint(
        k, (7,), 0, jnp.maximum(st.size, 1)), lead)(jring, keys)
    _hold_tree(treplay.sample(tring, _t(idx)), want)


def test_masked_add_needs_device_cursors():
    buf = treplay.init(_t(_ex()), 8)
    with pytest.raises(ValueError, match="device cursors"):
        treplay.add_batch(buf, _t(_rows(np.random.default_rng(0), (), 2)),
                          torch.ones(2, dtype=torch.bool))


def _dual_sample(jbuf, tbuf, key, b):
    """JAX's ``sample_dual`` from ``key`` and the port's at its indices."""
    want = jreplay.sample_dual(jbuf, key, b)
    k1, k2 = jax.random.split(key)
    below = lambda k, ring: jax.random.randint(k, (b,), 0,
                                               jnp.maximum(ring.size, 1))
    got = treplay.sample_dual(tbuf, _t(below(k1, jbuf.bad)),
                              _t(below(k2, jbuf.good)))
    _hold_tree(got, want)
    return got


def test_add_episode_routes_and_mixes():
    """``tests/test_replay.py:48-65``: a bad and a good episode of 10
    rows each, a 50/50 batch; then the fallback with only good rows;
    and ``add_episode``'s masks, routing and cursors against JAX's."""
    ex = _t(_ex())
    tbuf = treplay.init_dual(ex, 64)
    jbuf = jreplay.init_dual(jax.tree_util.tree_map(jnp.asarray, _ex()), 64)
    bad = {"x": np.zeros((10, 3), np.float32), "a": np.full(10, 1, np.int32)}
    good = {"x": np.ones((10, 3), np.float32), "a": np.full(10, 2, np.int32)}
    ones = np.ones(10, bool)
    for rows, is_bad in ((bad, True), (good, False)):
        jbuf = jreplay.add_episode(jbuf, rows, ones, jnp.bool_(is_bad))
        treplay.add_episode(tbuf, _t(rows), torch.from_numpy(ones),
                            torch.tensor(is_bad))
    assert int(tbuf.bad.size) == int(tbuf.good.size) == 10
    a = _dual_sample(jbuf, tbuf, jax.random.PRNGKey(1), 8)["a"]
    assert (a[:4] == 1).all() and (a[4:] == 2).all()

    tbuf = treplay.init_dual(ex, 64)
    jbuf = jreplay.init_dual(jax.tree_util.tree_map(jnp.asarray, _ex()), 64)
    valid = np.arange(10) < 6
    jbuf = jreplay.add_episode(jbuf, good, valid, jnp.bool_(False))
    treplay.add_episode(tbuf, _t(good), torch.from_numpy(valid),
                        torch.tensor(False))
    a = _dual_sample(jbuf, tbuf, jax.random.PRNGKey(1), 8)["a"]
    assert (a == 2).all() and int(tbuf.bad.size) == 0

    rng = np.random.default_rng(5)
    for i in range(8):
        rows = _rows(rng, (), 10)
        valid = rng.random(10) < 0.7
        jbuf = jreplay.add_episode(jbuf, rows, valid, jnp.bool_(i % 3 == 0))
        treplay.add_episode(tbuf, _t(rows), torch.from_numpy(valid),
                            torch.tensor(i % 3 == 0))
        _hold_ring(tbuf.bad, jbuf.bad, 0)
        _hold_ring(tbuf.good, jbuf.good, 0)
        _dual_sample(jbuf, tbuf, jax.random.PRNGKey(10 + i), 12)


@pytest.mark.parametrize("ring", ["host", "device", "device_seeds"])
def test_sample_subsequence_with_fed_starts(ring):
    """JAX's ``sample_subsequence`` (``buffer.py:83-92``) from a key and
    the port's from the start it draws, below max(size - length + 1, 1),
    on a ring of 8 that has wrapped: windows cross its end."""
    rng = np.random.default_rng(2)
    lead = (S,) if ring == "device_seeds" else ()
    jring = _jax_init(lead, lambda: jreplay.init(
        jax.tree_util.tree_map(jnp.asarray, _ex()), 8))
    add = jax.jit(_jmap(jreplay.add_batch, lead))
    if ring == "host":
        tring = treplay.init(_t(_ex()), 8)
    else:
        tring = treplay.init_ring(_t(_ex()), 8, lead)
    length = 5
    for step in range(4):
        rows = _rows(rng, lead, 3)
        jring = add(jring, rows)
        treplay.add_batch(tring, _t(rows))
        for i in range(4):
            key = jax.random.PRNGKey(100 * step + i)
            keys = jax.random.split(key, S) if lead else key
            want = _jmap(lambda st, k: jreplay.sample_subsequence(
                st, k, length), lead)(jring, keys)
            start = _jmap(lambda st, k: jax.random.randint(
                k, (), 0, jnp.maximum(st.size - length + 1, 1)),
                lead)(jring, keys)
            got = treplay.sample_subsequence(tring, _t(start), length)
            _hold_tree(got, want)
    assert (np.asarray(jring.insert) < 5).all()     # wrapped


# --------------------------------------------------------------------- #
# shard-local replay
# --------------------------------------------------------------------- #


def _sharded_idx(jring, key, b, shards, lead):
    """The per-shard indices JAX's ``sample_sharded`` draws from
    ``key`` (per seed: ``keys`` [S])."""
    def one(st, k):
        ks = jax.random.split(k, shards)
        return jax.vmap(lambda s, kk: jax.random.randint(
            kk, (b // shards,), 0, jnp.maximum(s, 1)))(st.size, ks)
    return _jmap(one, lead)(jring, key)


def test_sharded_membership_and_cursors():
    """``tests/test_parallel.py:106-124`` on one device: 16 envs into 8
    shards, env i into shard i // 2, and each sampled row its own
    shard's."""
    shards = 8
    ring = treplay.init_sharded({"x": torch.zeros(())}, 64 * shards, shards)
    treplay.add_batch_sharded(ring, {"x": torch.arange(16.0)}, shards)
    np.testing.assert_array_equal(ring.size.numpy(), np.full(shards, 2))
    np.testing.assert_array_equal(ring.data["x"][:, :2].reshape(-1).numpy(),
                                  np.arange(16))
    jring = jreplay.add_batch_sharded(
        jreplay.init_sharded({"x": jnp.zeros(())}, 64 * shards, shards),
        {"x": jnp.arange(16, dtype=jnp.float32)}, shards)
    key = jax.random.PRNGKey(0)
    want = jreplay.sample_sharded(jring, key, 32, shards)
    got = treplay.sample_sharded(ring, _t(_sharded_idx(jring, key, 32,
                                                       shards, ())))
    _hold_tree(got, want)
    rows = got["x"].reshape(shards, 4).numpy()
    for d in range(shards):
        assert set(rows[d]) <= {2 * d, 2 * d + 1}, (d, rows[d])


@pytest.mark.parametrize("shards", [2, 4])
@pytest.mark.parametrize("lead", [(), (S,)], ids=["one", "seeds"])
def test_sharded_adds_and_samples_match_jax(lead, shards):
    """Adds of 8 instances into shards of 24/D rows, whole and masked
    (the shards' fills then differ), wrapping; each ring, its cursors
    and a sample of 8 rows at JAX's per-shard indices, every step."""
    rng = np.random.default_rng(shards + len(lead))
    jring = _jax_init(lead, lambda: jreplay.init_sharded(
        jax.tree_util.tree_map(jnp.asarray, _ex()), 24, shards))
    tring = treplay.init_sharded(_t(_ex()), 24, shards, lead[0] if lead
                                 else None)
    differed = False
    for i in range(6):
        rows = _rows(rng, lead, 8)
        if i % 2:
            valid = rng.random(lead + (8,)) < 0.5
            fn = lambda st, r, v: jreplay.add_batch_sharded(st, r, shards, v)
            jring = _jmap(fn, lead)(jring, rows, valid)
            treplay.add_batch_sharded(tring, _t(rows), shards,
                                      torch.from_numpy(valid))
        else:
            fn = lambda st, r: jreplay.add_batch_sharded(st, r, shards)
            jring = _jmap(fn, lead)(jring, rows)
            treplay.add_batch_sharded(tring, _t(rows), shards)
        _hold_ring(tring, jring, len(lead) + 1)
        key = jax.random.PRNGKey(7 * i)
        keys = jax.random.split(key, S) if lead else key
        want = _jmap(lambda st, k: jreplay.sample_sharded(st, k, 8, shards),
                     lead)(jring, keys)
        got = treplay.sample_sharded(tring, _t(_sharded_idx(
            jring, keys, 8, shards, lead)))
        _hold_tree(got, want)
        cursors = tring.insert.numpy().reshape(-1, shards)
        differed |= bool((cursors != cursors[:, :1]).any())
    assert differed and (tring.size.numpy() == 24 // shards).any()


def test_sharded_dual_flush_and_sample():
    """``tests/test_replay.py:68-101``: env i's episode into shard
    i // 2, odd envs bad; a 50/50 mix per shard with the fallback (3 bad
    rows < half a shard's 8)."""
    shards, e, t = 4, 8, 3
    stage = {"x": (np.arange(e, dtype=np.float32)[:, None] * 10
                   + np.arange(t, dtype=np.float32)[None, :])}
    valid, is_bad = np.ones((e, t), bool), (np.arange(e) % 2).astype(bool)
    jbuf = jreplay.flush_episodes_sharded(
        jreplay.init_dual_sharded({"x": jnp.zeros(())}, 16 * shards, shards),
        stage, valid, is_bad, shards)
    tbuf = treplay.flush_episodes_sharded(
        treplay.init_dual_sharded({"x": torch.zeros(())}, 16 * shards,
                                  shards),
        _t(stage), torch.from_numpy(valid), torch.from_numpy(is_bad), shards)
    for name in ("bad", "good"):
        _hold_ring(getattr(tbuf, name), getattr(jbuf, name), 1)
        np.testing.assert_array_equal(getattr(tbuf, name).size.numpy(),
                                      np.full(shards, t))
    key = jax.random.PRNGKey(0)
    got = _dual_sharded_sample(jbuf, tbuf, key, 8 * shards, shards, ())
    x = got["x"].reshape(shards, 8).numpy()
    for d in range(shards):
        assert set(x[d][:t]) <= set((2 * d + 1) * 10 + np.arange(t))
        assert set(x[d][t:]) <= set((2 * d) * 10 + np.arange(t))


def _dual_sharded_sample(jbuf, tbuf, key, b, shards, lead):
    """JAX's ``sample_dual_sharded`` from ``key`` (per seed: [S] keys)
    and the port's at its indices: per shard the bad memory's, then the
    good one's (the port asks for all shards' bad indices first)."""
    want = _jmap(lambda st, k: jreplay.sample_dual_sharded(st, k, b, shards),
                 lead)(jbuf, key)

    def idx(st, k):
        ks = jax.random.split(k, shards)

        def one(s1, s2, kk):
            k1, k2 = jax.random.split(kk)
            return (jax.random.randint(k1, (b // shards,), 0,
                                       jnp.maximum(s1, 1)),
                    jax.random.randint(k2, (b // shards,), 0,
                                       jnp.maximum(s2, 1)))
        return jax.vmap(one)(st.bad.size, st.good.size, ks)
    i_bad, i_good = _jmap(idx, lead)(jbuf, key)
    got = treplay.sample_dual_sharded(tbuf, _t(i_bad), _t(i_good))
    _hold_tree(got, want)
    return got


@pytest.mark.parametrize("lead", [(), (S,)], ids=["one", "seeds"])
def test_sharded_dual_matches_jax(lead):
    """Four flushes of random episodes (6 envs x 5 steps) into D = 2
    shards of dual memories of 12 rows (they wrap), the good memory
    empty after the first; each memory and a sample every flush."""
    shards = 2
    rng = np.random.default_rng(9 + len(lead))
    ex = {"x": np.zeros(2, np.float32), "a": np.int32(0)}
    jbuf = _jax_init(lead, lambda: jreplay.init_dual_sharded(
        jax.tree_util.tree_map(jnp.asarray, ex), 24, shards))
    tbuf = treplay.init_dual_sharded(_t(ex), 24, shards,
                                     lead[0] if lead else None)
    flush = jax.jit(_jmap(lambda st, g, v, b: jreplay.flush_episodes_sharded(
        st, g, v, b, shards), lead))
    for i in range(4):
        stage = {"x": rng.normal(size=lead + (6, 5, 2)).astype(np.float32),
                 "a": rng.integers(0, 9, lead + (6, 5)).astype(np.int32)}
        ended = rng.random(lead + (6,)) < 0.7
        valid = ended[..., None] & (np.arange(5) < rng.integers(
            1, 6, lead + (6,))[..., None])
        bad = rng.random(lead + (6,)) < 0.5
        if i == 0:
            bad[...] = True
        jbuf = flush(jbuf, stage, valid, bad)
        treplay.flush_episodes_sharded(tbuf, _t(stage),
                                       torch.from_numpy(valid),
                                       torch.from_numpy(bad), shards)
        for name in ("bad", "good"):
            _hold_ring(getattr(tbuf, name), getattr(jbuf, name),
                       len(lead) + 1)
        key = jax.random.PRNGKey(3 + i)
        keys = jax.random.split(key, S) if lead else key
        _dual_sharded_sample(jbuf, tbuf, keys, 10, shards, lead)
    assert (tbuf.bad.size == 12).any()
    treplay.reset_dual(tbuf)
    assert not tbuf.bad.size.any() and not tbuf.good.insert.any()


@pytest.mark.parametrize("what", ["capacity", "instances", "batch"])
def test_shards_must_divide(what):
    """JAX asserts divisibility by D (``buffer.py:201, 214, 230, 253``);
    the port raises ``ValueError``."""
    with pytest.raises(ValueError, match="not divisible by 4"):
        if what == "capacity":
            treplay.init_sharded(_t(_ex()), 30, 4)
        elif what == "instances":
            treplay.add_batch_sharded(treplay.init_sharded(_t(_ex()), 32, 4),
                                      _t(_rows(np.random.default_rng(0), (),
                                               6)), 4)
        else:
            treplay.check_shards(4, batch_size=10)
