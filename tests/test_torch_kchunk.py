"""The K-chunk schedule (``chunks_per_sync`` > 1) of the port against the
JAX package's, and the device-gated optimizer steps under it.

Three K = 2 dispatches (``OffPolicyDriver._chunks_scanned`` against JAX's
jitted ``_chunk_train_k``, JAX's draws fed in) of one env instance with
episodes of exactly one chunk (5 steps): the first all fill (episodes 0
and 1 below ``pretrain_episodes`` 3), the second straddling the fill ->
train boundary (2, then 3), the third training with epsilon decaying
inside it, for CM3 on the optax path, CM3 fused with the actor frozen
for 3 updates (the freeze ends inside the third dispatch), QMIX and
COMA.  Then the gated updates alone: a predicate of 0 gives back every
buffer and count bit for bit even where the dropped step is NaN."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cm3_tpu.core import config as jcfg
from cm3_tpu.replay import buffer as jreplay
from cm3_tpu.train.experiments import make_hooks as jax_hooks
from cm3_tpu.train.offpolicy import OffPolicyDriver as JaxDriver
from cm3_tpu.train.offpolicy import init_rollout as jax_init_rollout
from cm3_tpu_torch import convert
from cm3_tpu_torch.algs import common
from cm3_tpu_torch.algs.cm3 import CM3 as TorchCM3
from cm3_tpu_torch.core import config as tcfg
from cm3_tpu_torch.core import prng
from cm3_tpu_torch.core.tree import tree_leaves
from cm3_tpu_torch.ops import fused_opt, polyak
from cm3_tpu_torch.train.experiments import make_hooks
from cm3_tpu_torch.train.offpolicy import OffPolicyDriver, init_rollout
from tests import torch_parity as tp

tp.set_torch_cpu()

E, CAP, B, U, SPT, K, P = 1, 64, 8, 2, 5, 2, 3
TRAIN = dict(n_envs=E, buffer_size=CAP, batch_size=B, steps_per_train=SPT,
             updates_per_chunk=U, pretrain_episodes=P, chunks_per_sync=K,
             epsilon_start=0.4, epsilon_end=0.05, epsilon_div=2.0)
# (kind, AlgConfig options, state tolerances)
CASES = {
    "cm3_optax": ("cm3", dict(fused_opt=False), {}),
    "cm3_fused_freeze": ("cm3", dict(fused_opt=True,
                                     actor_freeze_updates=3), {}),
    "qmix": ("qmix", dict(), tp.QMIX_TOL),
    "coma": ("baseline", dict(use_Q=True), {}),
}


def _algs(kind, spec, opts):
    if kind == "cm3":
        return tp.algs(spec, **opts)
    return tp.other_algs(kind, spec, **opts)


def _fed(draws, qmix):
    if qmix:
        randints, gumbels, uniforms = draws
        return prng.FedDraws(randints, gumbels, device="cpu",
                             uniforms=uniforms)
    return prng.FedDraws(*draws, device="cpu")


@pytest.fixture(scope="module", params=sorted(CASES))
def runs(request):
    kind, opts, tol = CASES[request.param]
    qmix = kind == "qmix"
    je, te = tp.envs(max_steps=SPT)
    ja, ta = _algs(kind, je.spec(), opts)
    jd = JaxDriver(jax_hooks("checkers", je), ja, jcfg.TrainConfig(**TRAIN))
    td = OffPolicyDriver(make_hooks("checkers", te), ta,
                         tcfg.TrainConfig(**TRAIN))
    jrs = jax_init_rollout(jd.hooks, jax.random.PRNGKey(0), E)
    jts = ja.init_state(jax.random.PRNGKey(1), jrs.obs, jrs.state, jrs.goals)
    zeros = jnp.zeros((E, 2), jnp.int32)
    tr = jd._transition(jrs, zeros,
                        jax.vmap(je.step)(jrs.env_state, zeros)[1], None)
    jbuf = jreplay.init(jax.tree_util.tree_map(lambda x: x[0], tr), CAP)
    trs = init_rollout(td.hooks, E)
    tts = convert.state_from_jax(ta, jax.device_get(jts))
    tbuf = td._replay_init(td.example_transition(trs))
    out = {"name": request.param, "alg": ta, "tol": tol,
           "start": tp.copy_state(ta, tts), "dispatches": []}
    size = 0
    for d in range(3):
        key = jax.random.PRNGKey(30 + d)
        jts, jbuf, jrs, jm = jd._chunk_train_k(jts, jbuf, jrs, key, K)
        draws, size = tp.kchunk_draws(key, K, E, 2, 5, SPT, U, B, size, CAP,
                                      qmix=qmix)
        fed = _fed(draws, qmix)
        tts, tbuf, trs, tm = td._chunks_scanned(tts, tbuf, trs, fed, K)
        assert not any(fed.remaining().values())
        out["dispatches"].append((
            convert.state_from_jax(ta, jax.device_get(jts)),
            tp.copy_state(ta, tts), jax.device_get(jm),
            {k: float(v) for k, v in tm.items()},
            jax.device_get((jrs, jbuf)), copy.deepcopy((trs, tbuf))))
    return out


def test_fill_dispatch_leaves_the_state_bit_for_bit(runs):
    """The first dispatch is all fill: its updates were computed and
    dropped, so every network, target, moment and count is the start's
    bit for bit; its metrics are zeros, as JAX's, with ``trained`` and
    ``trained_chunks`` 0."""
    want, got, jm, tm, _, _ = runs["dispatches"][0]
    start = runs["start"]
    alg = runs["alg"]
    tp.hold_states(got, start, alg.net_names(), atol_nu=0, rtol=0, atol=0)
    for name in alg.net_names():
        assert torch.equal(getattr(got, name).flat,
                           getattr(start, name).flat)
        assert getattr(got, "opt_" + name).count == 0
    assert got.step == want.step == 0
    assert sorted(tm) == sorted(jm) and "trained_chunks" in tm
    assert all(v == 0.0 for v in tm.values())
    assert all(float(v) == 0.0 for v in jm.values())


@pytest.mark.parametrize("dispatch", [1, 2])
def test_dispatches_match_jax(runs, dispatch):
    """The straddling dispatch and the training one: networks, targets,
    Adam moments and counts, the step, the metrics (the last chunk's,
    with ``trained`` 1) and ``trained_chunks`` (1, then 2), at the parity
    tolerances (QMIX at ``QMIX_TOL``)."""
    want, got, jm, tm, _, _ = runs["dispatches"][dispatch]
    alg = runs["alg"]
    tp.hold_states(got, want, alg.net_names(), **runs["tol"])
    updates = U * (1 if dispatch == 1 else 3)
    assert got.step == want.step == updates
    assert sorted(tm) == sorted(jm)
    assert tm["trained"] == float(jm["trained"]) == 1.0
    assert tm["trained_chunks"] == float(jm["trained_chunks"]) == dispatch
    for k in tm:
        np.testing.assert_allclose(tm[k], float(jm[k]), rtol=1e-5,
                                   atol=1e-6, err_msg=k)


@pytest.mark.parametrize("dispatch", [0, 1, 2])
def test_rollout_and_replay_match(runs, dispatch):
    """The episode count, the returns, the env state and the ring after
    each dispatch: integers exactly, floats at rtol 1e-5 / atol 1e-6."""
    *_, (jrs, jbuf), (trs, tbuf) = runs["dispatches"][dispatch]
    assert int(trs.episodes) == int(jrs.episodes) == K * (dispatch + 1)
    assert (tbuf.insert, tbuf.size) == (int(jbuf.insert), int(jbuf.size))
    for path, leaf in tree_leaves(tbuf.data):
        want = jbuf.data
        for k in path:
            want = want[k]
        want = np.asarray(want)
        if np.issubdtype(want.dtype, np.floating):
            np.testing.assert_allclose(leaf.numpy(), want, rtol=1e-5,
                                       atol=1e-6, err_msg="/".join(path))
        else:
            np.testing.assert_array_equal(leaf.numpy(), want,
                                          err_msg="/".join(path))
    for name in ("a_prev", "ep_ret_local", "acc_ret_local"):
        np.testing.assert_allclose(getattr(trs, name).numpy(),
                                   np.asarray(getattr(jrs, name)),
                                   rtol=1e-5, atol=1e-6, err_msg=name)


@pytest.mark.parametrize("runs", ["cm3_fused_freeze"], indirect=True)
def test_the_freeze_ends_inside_the_dispatch(runs):
    """CM3 fused, actor frozen for 3 updates: after the straddling
    dispatch (2 trained updates) the actor and its Adam state are the
    start's and its target moved; in the third (4 more) the freeze ends
    after the first update, so the actor took 3 steps, as JAX's."""
    start = runs["start"]
    _, mid, *_ = runs["dispatches"][1]
    want, end, *_ = runs["dispatches"][2]
    assert torch.equal(mid.actor.flat, start.actor.flat)
    assert mid.opt_actor.count == 0
    assert not torch.equal(mid.actor_tgt.flat, start.actor_tgt.flat)
    assert end.opt_actor.count == want.opt_actor.count == 3
    assert not torch.equal(end.actor.flat, start.actor.flat)


def test_device_epsilon_matches_jax():
    """Each chunk's epsilon from the device's episode count, float32 in
    JAX's formula (``offpolicy.py:199-203``), at counts across the fill,
    the decay and the floor."""
    cfg = tcfg.TrainConfig(**TRAIN)
    jc = jcfg.TrainConfig(**TRAIN)
    eps = jax.jit(lambda e: jnp.maximum(
        jc.epsilon_end, jc.epsilon_start - jnp.maximum(
            0, e - jc.pretrain_episodes).astype(jnp.float32)
        * jc.epsilon_step))
    episodes = np.arange(0, 12)
    want = np.asarray(eps(jnp.asarray(episodes, jnp.int32)))
    got = OffPolicyDriver._device_epsilon(cfg, torch.from_numpy(episodes))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def test_feeding_only_the_random_actions_fails():
    """A gated chunk asks for the policy's draws and then the random
    actions, as JAX splits ``k_act`` and ``k_rand``: JAX's draws without
    the policy's (only the random-action randints and the updates')
    leave the port without its Gumbel noise, and the fed run raises."""
    je, te = tp.envs(max_steps=SPT)
    _, ta = tp.algs(je.spec(), fused_opt=False)
    td = OffPolicyDriver(make_hooks("checkers", te), ta,
                         tcfg.TrainConfig(**TRAIN))
    trs = init_rollout(td.hooks, E)
    tbuf = td._replay_init(td.example_transition(trs))
    key = jax.random.PRNGKey(30)
    (randints, gumbels), _ = tp.kchunk_draws(key, K, E, 2, 5, SPT, U, B, 0,
                                             CAP)
    update_noise = gumbels[-U:]
    fed = prng.FedDraws(randints, update_noise, device="cpu")
    with pytest.raises((IndexError, ValueError)):
        td._chunks_scanned(ta.init_state(7), tbuf, trs, fed, K)


# --------------------------------------------------------------------- #
# the gated optimizer steps
# --------------------------------------------------------------------- #


def _buffers(n, seed, nan=False):
    rng = np.random.default_rng(seed)
    p, t, mu, g = (torch.from_numpy(rng.standard_normal(n).astype(np.float32))
                   for _ in range(4))
    nu = torch.from_numpy(rng.random(n).astype(np.float32) * 1e-2)
    if nan:
        g[::3] = float("nan")
    return p, t, mu, nu, g


@pytest.mark.parametrize("count", [0, 5])
@pytest.mark.parametrize("nan", [False, True])
def test_gated_adam_apply_keeps_everything_where_off(count, nan):
    """``common.adam_apply`` under a predicate of False: params, moments
    and count bit for bit (at count 0 the dropped step divides by
    c1 = 0; with NaN gradients it is NaN), with the clip and the lr
    scale on; under True it equals the ungated step bit for bit."""
    p, _, mu, nu, g = _buffers(1003, count + nan, nan)
    st = common.AdamState(mu.clone(), nu.clone(), count)
    q = p.clone()
    common.adam_apply(st, q, g, 1e-3, clip=1.0,
                      lr_scale=torch.tensor(0.5), apply=torch.tensor(False))
    assert torch.equal(q, p) and torch.equal(st.mu, mu)
    assert torch.equal(st.nu, nu) and st.count == count
    a, b = common.AdamState(mu.clone(), nu.clone(), count), \
        common.AdamState(mu.clone(), nu.clone(), count)
    pa, pb = p.clone(), p.clone()
    common.adam_apply(a, pa, g, 1e-3, clip=1.0, apply=torch.tensor(True))
    common.adam_apply(b, pb, g, 1e-3, clip=1.0)
    for x, y in ((pa, pb), (a.mu, b.mu), (a.nu, b.nu), (a.count, b.count)):
        torch.testing.assert_close(x, y, rtol=0, atol=0, equal_nan=True)
    assert a.count == count + 1


@pytest.mark.parametrize("nan", [False, True])
def test_gated_adam_polyak_plain_off_keeps_everything(nan):
    """B1's plain version under the int32 predicate 0: p, tgt, mu and nu
    come back bit for bit though the dropped step is Inf (a zero tile,
    the count-0 tile of a gated-off update) and, with NaN gradients,
    NaN."""
    p, t, mu, nu, g = _buffers(4099, 7, nan)
    bufs = [x.clone() for x in (p, t, mu, nu)]
    zero = torch.zeros(2)
    fused_opt.adam_polyak_plain(*bufs, g, zero[0], zero[1], 1e-3, 0.01,
                                apply=torch.tensor(0, dtype=torch.int32))
    for got, orig in zip(bufs, (p, t, mu, nu)):
        assert torch.equal(got, orig)


@pytest.mark.parametrize("apply", [None, 0, 1])
def test_adam_polyak_many_counts_by_the_predicate(apply):
    """``adam_polyak_many`` with the predicate 0, 1 or none: 0 leaves
    the buffers and the count; 1 equals no predicate bit for bit, and
    both advance the count."""
    p, t, mu, nu, g = _buffers(4099, 8)
    pred = None if apply is None else torch.tensor(apply, dtype=torch.int32)
    st, ref = (common.AdamState(mu.clone(), nu.clone(), 4) for _ in range(2))
    got, want = [p.clone(), t.clone()], [p.clone(), t.clone()]
    fused_opt.adam_polyak_many([(st, *got, g, 1e-3)], 0.01, apply=pred)
    fused_opt.adam_polyak_many([(ref, *want, g, 1e-3)], 0.01)
    if apply == 0:
        want, ref = [p, t], common.AdamState(mu, nu, 4)
    for x, y in zip(got + [st.mu, st.nu, st.count],
                    want + [ref.mu, ref.nu, ref.count]):
        assert torch.equal(x, y)
    assert st.count == (4 if apply == 0 else 5)


@pytest.mark.parametrize("apply", [None, False, True])
def test_gated_polyak_plain_and_soft_update(apply):
    """B3's plain version and ``common.soft_update`` under a predicate:
    False keeps the target bit for bit though the main buffer is NaN;
    True and none blend."""
    rng = np.random.default_rng(3)
    t = torch.from_numpy(rng.standard_normal(1001).astype(np.float32))
    m = torch.full_like(t, float("nan")) if apply is False else \
        torch.from_numpy(rng.standard_normal(1001).astype(np.float32))
    pred = None if apply is None else torch.tensor(apply)
    want = t.clone() if apply is False else 0.01 * m + 0.99 * t
    for fn in (polyak.polyak_update_plain, common.soft_update):
        got = t.clone()
        fn(got, m, 0.01, pred)
        assert torch.equal(got, want)
    got = t.clone()
    polyak.polyak_update(got, m, 0.01,
                         None if pred is None else pred.to(torch.int32))
    assert torch.equal(got, want)


def test_bias_corrections_equal_xla_at_every_count():
    """The tile equals XLA's float32 (1 - b^t) bit for bit at every
    count 0..29,999, both over all the counts at once (PyTorch's
    vectorized power) and one count at a time, a [2] tile, as an update
    computes it (its scalar loop, glibc's ``powf``, whose b^t differs
    from the vectorized one at some counts by an ulp that 1 - b^t
    rounds away); numpy's float32 power missed it at 291 of them, by up
    to 2 ulps."""
    k = jnp.arange(0, 30000, dtype=jnp.int32)
    want = np.asarray(jax.jit(lambda k: jnp.stack(
        [1.0 - 0.9 ** (k + 1).astype(jnp.float32),
         1.0 - 0.999 ** (k + 1).astype(jnp.float32)], -1))(k))
    got = common.bias_corrections(torch.arange(0, 30000, dtype=torch.int32))
    np.testing.assert_array_equal(got.numpy(), want)
    one = np.stack([common.bias_corrections(
        torch.tensor(c, dtype=torch.int32)).numpy() for c in range(30000)])
    np.testing.assert_array_equal(one, want)


def test_counts_live_on_the_device_and_move_into_new_tensors():
    """``AdamState.count`` and a state's ``step`` are 0-dim int32
    tensors (an int assigned becomes one); an update advances them into
    new tensors, so a state that shares them keeps its counts."""
    je, te = tp.envs(max_steps=SPT)
    _, ta = tp.algs(je.spec(), fused_opt=True)
    st = ta.init_state(3)
    assert st.step.dtype == torch.int32 and st.step.shape == ()
    assert st.opt_qg.count.dtype == torch.int32
    st.step = 7
    other = ta.init_state(4)
    other.step, other.opt_actor.count = st.step, st.opt_actor.count
    batch = tp.to_torch(jax.device_get(tp.replay_batch(
        je, B, np.random.default_rng(0))))
    st, _ = ta.update(st, batch, 0.2, torch.zeros(B, 2, 5))
    assert st.step == 8 and st.opt_actor.count == 1
    assert other.step == 7 and other.opt_actor.count == 0


def test_fused_anneal_is_still_refused():
    """JAX refuses the fused path with the actor's lr anneal
    (``cm3_tpu/algs/cm3.py:111-118``): so does the port."""
    _, te = tp.envs()
    with pytest.raises(ValueError, match="actor_lr_anneal_updates"):
        TorchCM3("checkers", te.spec(), tcfg.AlgConfig(
            n_agents=2, stage=2, fused_opt=True, actor_lr_anneal_updates=10),
            tcfg.NNConfig(**tp.SMALL_NN), device="cpu")
