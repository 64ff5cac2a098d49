"""Shared set-up of the parity tests between ``cm3_tpu`` (JAX, the
reference) and ``cm3_tpu_torch`` (the port): one small Checkers stage-2
CM3 configuration built in both packages (and the baselines' and
QMIX's), the same for particle, and the JAX draws of a driver's chunk,
burst or evaluation recomputed from its keys so that they can be fed to
the port."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cm3_tpu.algs.baseline import Baseline as JaxBaseline
from cm3_tpu.algs.cm3 import CM3 as JaxCM3
from cm3_tpu.algs.qmix import QMIX as JaxQMIX
from cm3_tpu.core import config as jcfg
from cm3_tpu.envs.checkers import Checkers as JaxCheckers
from cm3_tpu_torch.algs.baseline import Baseline as TorchBaseline
from cm3_tpu_torch.algs.cm3 import CM3 as TorchCM3
from cm3_tpu_torch.algs.qmix import QMIX as TorchQMIX
from cm3_tpu_torch import convert
from cm3_tpu_torch.ops import fused_opt, polyak
from cm3_tpu_torch.core import config as tcfg
from cm3_tpu_torch.envs.checkers import Checkers as TorchCheckers

# narrow widths; the layer structure is the full one
SMALL_NN = dict(Q_conv_f=2, Q_conv_k=(3, 5), Q_n_h1_1=16, Q_n_h1_2=8,
                Q_n_h2=16, A_conv_f=2, A_conv_k=(3, 3), A_n_h1=16, A_n_h2=12)
# and the baselines' critics (the central V keeps its own default widths,
# as both packages build it)
SMALL_BASE_NN = dict(SMALL_NN, Q_units=16, V_conv_f=2, V_n_h1_1=16,
                     V_n_h1_2=8, V_n_h2=16)


def set_torch_cpu():
    torch.set_num_threads(1)


def envs(max_steps=50, n_agents=2):
    """The JAX and the port's Checkers engines; stage 2 (two agents at
    the stage-2 start cells) or stage 1 (one agent, start row by
    goal)."""
    kw = dict(n_agents=n_agents, max_steps=max_steps)
    if n_agents == 1:
        kw.update(agents_r=(0,), agents_c=(8,))
    j = JaxCheckers(jcfg.CheckersEnvConfig(**kw))
    t = TorchCheckers(tcfg.CheckersEnvConfig(**kw), device="cpu")
    return j, t


def algs(spec, n_seeds=None, **alg):
    """The JAX and the port's CM3 for the engines' spec, at SMALL_NN
    widths; stage 2 for two agents, stage 1 for one."""
    n = spec["n_agents"]
    kw = dict(n_agents=n, stage=2 if n > 1 else 1, fused_opt=True)
    kw.update(alg)
    j = JaxCM3("checkers", spec, jcfg.AlgConfig(**kw),
               jcfg.NNConfig(**SMALL_NN))
    t = TorchCM3("checkers", spec, tcfg.AlgConfig(**kw),
                 tcfg.NNConfig(**SMALL_NN), device="cpu", n_seeds=n_seeds)
    return j, t


def other_algs(kind, spec, n_seeds=None, **alg):
    """The JAX and the port's Baseline (``kind`` "baseline") or QMIX
    ("qmix") for the engines' spec, at SMALL_BASE_NN widths; stage 2
    for two agents, stage 1 for one."""
    n = spec["n_agents"]
    kw = dict(n_agents=n, stage=2 if n > 1 else 1,
              alg_name="qmix" if kind == "qmix" else "coma")
    kw.update(alg)
    jcls, tcls = ((JaxQMIX, TorchQMIX) if kind == "qmix"
                  else (JaxBaseline, TorchBaseline))
    j = jcls("checkers", spec, jcfg.AlgConfig(**kw),
             jcfg.NNConfig(**SMALL_BASE_NN))
    t = tcls("checkers", spec, tcfg.AlgConfig(**kw),
             tcfg.NNConfig(**SMALL_BASE_NN), device="cpu", n_seeds=n_seeds)
    return j, t


def goal_draws(key, n):
    """The goal indices that ``CheckersHooks.episode_init`` draws for n
    single-agent instances from ``key`` (``prng.split_batch``, then the
    first half of each instance key's split), [n] in [0, 2)."""
    keys = jax.vmap(lambda i: jax.random.fold_in(key, i))(jnp.arange(n))
    return np.asarray(jax.vmap(lambda k: jax.random.randint(
        jax.random.split(k)[0], (), 0, 2))(keys))


def to_torch(tree):
    """JAX pytree of arrays -> the same dict of CPU tensors (ints as
    int64, the port's index type)."""
    def conv(x):
        x = np.array(x)
        if np.issubdtype(x.dtype, np.integer):
            x = x.astype(np.int64)
        return torch.from_numpy(x)
    return jax.tree_util.tree_map(conv, tree)


def qmix_act_draws(key, shape, n_actions):
    """The override's random actions and uniforms that QMIX's ``act``
    draws from ``key`` (``qmix.py:113-115``), ``shape`` = [.., N]."""
    k1, k2 = jax.random.split(key)
    return (np.asarray(jax.random.randint(k1, shape, 0, n_actions)),
            np.asarray(jax.random.uniform(k2, shape)))


def sharded_indices(key, batch, sizes):
    """The replay indices JAX's ``sample_sharded`` draws from ``key``
    (``buffer.py:229-234``): ``jax.random.split(key, D)``, then per
    shard batch/D below its fill ``sizes[d]``; [D, batch/D]."""
    sizes = np.asarray(sizes)
    keys = jax.random.split(key, len(sizes))
    return np.stack([np.asarray(jax.random.randint(
        k, (batch // len(sizes),), 0, max(int(n), 1)))
        for k, n in zip(keys, sizes)])


def sharded_dual_indices(key, batch, s_bad, s_good):
    """The indices JAX's ``sample_dual_sharded`` draws from ``key``
    (``buffer.py:251-257``): per shard the bad memory's and the good
    one's (``sample_dual``'s split); -> (bad [D, b], good [D, b]) in the
    order the port asks for them."""
    s_bad, s_good = np.asarray(s_bad), np.asarray(s_good)
    b = batch // len(s_bad)
    out = ([], [])
    for k, n1, n2 in zip(jax.random.split(key, len(s_bad)), s_bad, s_good):
        k1, k2 = jax.random.split(k)
        for lst, kk, n in ((out[0], k1, n1), (out[1], k2, n2)):
            lst.append(np.asarray(jax.random.randint(kk, (b,), 0,
                                                     max(int(n), 1))))
    return np.stack(out[0]), np.stack(out[1])


def chunk_draws(key, n_envs, n_agents, n_actions, steps, random_actions,
                n_updates=0, batch=0, sizes=(), qmix=False, gated=False):
    """The draws ``OffPolicyDriver._chunk`` makes from ``key``
    (offpolicy.py:242-248,369-371), as (randints, gumbels) in the order
    the port's driver asks for them; for one agent, each step's
    auto-reset goals too.  ``sizes`` is the replay fill seen by each
    update (jax.random.randint's bound), or with shard-local replay the
    shards' fills [D] (``sharded_indices``).  With ``qmix`` the policy's
    steps draw QMIX's override (random actions among the randints, and
    uniforms) and the updates draw nothing: (randints, gumbels,
    uniforms), the gumbels empty.  ``gated``: a chunk of a K-chunk
    dispatch (``_chunk(..., gate=)``), whose policy steps draw the
    policy's draws from ``k_act`` and then random actions from
    ``k_rand``, both whatever the gate."""
    randints, gumbels, uniforms = [], [], []
    for k in jax.random.split(key, steps):
        k_act, k_rand, k_reset = jax.random.split(k, 3)
        rand = lambda: randints.append(np.asarray(jax.random.randint(
            k_rand, (n_envs, n_agents), 0, n_actions)))
        if random_actions:
            rand()
        elif qmix:
            rand_a, u = qmix_act_draws(k_act, (n_envs, n_agents), n_actions)
            randints.append(rand_a)
            uniforms.append(u)
        else:
            gumbels.append(np.asarray(jax.random.gumbel(
                k_act, (n_envs, n_agents, n_actions))))
        if gated and not random_actions:
            rand()
        if n_agents == 1:
            randints.append(goal_draws(k_reset, n_envs))
    ks = jax.random.split(jax.random.fold_in(key, 7), n_updates)
    for k, size in zip(ks, sizes):
        k_sample, k_update = jax.random.split(k)
        if np.ndim(size):
            randints.append(sharded_indices(k_sample, batch, size))
        else:
            randints.append(np.asarray(jax.random.randint(
                k_sample, (batch,), 0, jnp.maximum(jnp.int32(size), 1))))
        if not qmix:
            gumbels.append(np.asarray(jax.random.gumbel(
                k_update, (batch, n_agents, n_actions))))
    return (randints, gumbels, uniforms) if qmix else (randints, gumbels)


def kchunk_draws(key, k_chunks, n_envs, n_agents, n_actions, steps,
                 n_updates, batch, size, capacity, qmix=False):
    """The draws of one K-chunk dispatch (``_chunks_scanned``, JAX's
    ``_chunk_train_k``) from ``key``: each chunk's ``chunk_draws``
    (gated) from its key of ``jax.random.split(key, k_chunks)``, in the
    port's order; ``size`` is the ring's fill before the dispatch, which
    grows by ``n_envs`` rows a step up to ``capacity``.  Returns (the
    draws' lists as ``chunk_draws``', the fill after the dispatch)."""
    out = None
    for k in jax.random.split(key, k_chunks):
        size = min(size + steps * n_envs, capacity)
        d = chunk_draws(k, n_envs, n_agents, n_actions, steps, False,
                        n_updates, batch, [size] * n_updates, qmix=qmix,
                        gated=True)
        out = d if out is None else tuple(a + b for a, b in zip(out, d))
    return out, size


def eval_draws(key, n_eval, n_agents, n_actions, max_steps):
    """The draws ``OffPolicyDriver.evaluate`` makes from ``key``
    (offpolicy.py:389-432): (randints, gumbels) - the goals (one agent),
    then a sample's Gumbel noise per step."""
    randints = [goal_draws(key, n_eval)] if n_agents == 1 else []
    gumbels = [np.asarray(jax.random.gumbel(k, (n_eval, n_agents,
                                                 n_actions)))
               for k in jax.random.split(key, max_steps)]
    return randints, gumbels


def stack_draws(per_seed):
    """Per-seed (randints, gumbels[, uniforms]) lists of equal structure
    -> the seed-stacked draws a driver of S seeds asks for, [S, ...]
    each."""
    return tuple([np.stack(xs) for xs in zip(*(d[i] for d in per_seed))]
                 for i in range(len(per_seed[0])))


def replay_batch(env, b, rng):
    """A replay-like batch of b real Checkers transitions of ``env``
    (JAX): random goals for one agent, identity goals for more, noisy
    local rewards and some terminal rows."""
    n = env.cfg.n_agents
    if n == 1:
        goals = jnp.asarray(np.eye(2, dtype=np.float32)[
            rng.integers(0, 2, b)][:, None])
    else:
        goals = jnp.tile(jnp.eye(n, 2)[None], (b, 1, 1))
    s, ts = jax.vmap(env.reset)(jax.random.split(jax.random.PRNGKey(0), b),
                                goals)
    for _ in range(3):
        s, ts = jax.vmap(env.step)(
            s, jnp.asarray(rng.integers(0, 5, (b, n)), jnp.int32))
    a = jnp.asarray(rng.integers(0, 5, (b, n)), jnp.int32)
    _, ts2 = jax.vmap(env.step)(s, a)
    return {"obs": ts.obs, "state": ts.state, "a": a,
            "a_prev": jnp.asarray(rng.integers(0, 5, (b, n)), jnp.int32),
            "r": ts2.reward,
            "rl": ts2.reward_local + jnp.asarray(rng.normal(size=(b, n)),
                                                 jnp.float32),
            "obs_next": ts2.obs, "state_next": ts2.state,
            "done": jnp.asarray(rng.random(b) < 0.3), "goals": goals}


def hold_states(got, want, nets, atol_nu=1e-9, rtol=1e-5, atol=1e-6):
    """Two port CM3 states equal at the parity tolerance: every network
    of ``nets`` and its target, and each Adam state's moments and
    count."""
    for name in nets:
        for suffix in ("", "_tgt"):
            np.testing.assert_allclose(
                getattr(got, name + suffix).flat.numpy(),
                getattr(want, name + suffix).flat.numpy(), rtol=rtol,
                atol=atol, err_msg=name + suffix)
        g, w = getattr(got, "opt_" + name), getattr(want, "opt_" + name)
        assert g.count == w.count, name
        np.testing.assert_allclose(g.mu.numpy(), w.mu.numpy(), rtol=rtol,
                                   atol=atol, err_msg=name + ".mu")
        np.testing.assert_allclose(g.nu.numpy(), w.nu.numpy(), rtol=rtol,
                                   atol=atol_nu, err_msg=name + ".nu")


# --------------------------------------------------------------------- #
# CM3's options: updates in both packages (test_torch_cm3_options*.py)
# --------------------------------------------------------------------- #

OPTION_B, OPTION_UPDATES = 16, 3


def option_batch(env, rng, with_bp):
    """``replay_batch`` of OPTION_B rows, with a stored behavior
    probability ``bp`` in [0.05, 0.6) when asked."""
    b = replay_batch(env, OPTION_B, rng)
    if with_bp:
        b["bp"] = jnp.asarray(rng.uniform(0.05, 0.6, b["a"].shape),
                              jnp.float32)
    return b


def copy_state(alg, st):
    """A snapshot of a port CM3 state (its buffers copied)."""
    c = alg.empty_state()
    for name in alg.net_names():
        for suffix in ("", "_tgt"):
            getattr(c, name + suffix).flat.copy_(
                getattr(st, name + suffix).flat)
        g, w = getattr(c, "opt_" + name), getattr(st, "opt_" + name)
        g.mu.copy_(w.mu)
        g.nu.copy_(w.nu)
        g.count = w.count
    c.step = st.step
    return c


def metric_tol(cfg, key):
    """rtol 1e-5 and atol 1e-6 for a metric; with ``adv_norm``, atol
    1e-5 for the policy loss: its B x N terms are ~1 in size and their
    standardized advantages sum to 0, so the loss is a cancelling sum
    (~2e-4 here) whose float32 error is absolute, ~1e-6 of the terms'
    size, not relative to the sum (measured 1.8e-6 against JAX and
    across the seed axis)."""
    if cfg.adv_norm and key == "policy_loss":
        return dict(rtol=1e-5, atol=1e-5)
    return dict(rtol=1e-5, atol=1e-6)


def option_runs(name, n, opts):
    """OPTION_UPDATES CM3 updates with the options ``opts`` (optax path
    unless they say fused_opt) in both packages from the same converted
    state, on the same batches and a' noise: after each, the JAX state
    converted, the port's state, both metrics, and the port's optimizer
    calls (the fused kernel's segment sizes, the Polyak calls' sizes,
    each with its predicate's value: None without one)."""
    je, _ = envs(n_agents=n)
    kw = dict(fused_opt=False)
    kw.update(opts)
    ja, ta = algs(je.spec(), **kw)
    rng = np.random.default_rng(0)
    batches = [option_batch(je, rng, "pg_is_clip" in opts)
               for _ in range(OPTION_UPDATES)]
    jts = ja.init_state(jax.random.PRNGKey(1), batches[0]["obs"],
                        batches[0]["state"], batches[0]["goals"])
    tts = convert.state_from_jax(ta, jax.device_get(jts))
    upd = jax.jit(ja.update)
    out = {"name": name, "n": n, "alg": ta, "states": [], "calls": [],
           "start": copy_state(ta, tts)}
    with pytest.MonkeyPatch.context() as mp:
        many, soft = fused_opt.adam_polyak_many, polyak.polyak_update
        calls = []
        on = lambda apply: None if apply is None else bool(apply)
        mp.setattr(fused_opt, "adam_polyak_many",
                   lambda items, tau, apply=None: (
                       calls.append(("adam", [p.numel() for _, p, *_ in items],
                                     on(apply))),
                       many(items, tau, apply)))
        mp.setattr(polyak, "polyak_update", lambda t, m, tau, apply=None: (
            calls.append(("polyak", [t.numel()], on(apply))),
            soft(t, m, tau, apply))[1])
        for i, batch in enumerate(batches):
            key = jax.random.PRNGKey(5 + i)
            jts, jm = upd(jts, batch, 0.2, key)
            gumbel = np.array(jax.random.gumbel(key, (OPTION_B, n, 5)))
            calls.clear()
            tts, tm = ta.update(tts, to_torch(jax.device_get(batch)),
                                0.2, torch.from_numpy(gumbel))
            out["calls"].append(list(calls))
            out["states"].append((convert.state_from_jax(
                ta, jax.device_get(jts)), copy_state(ta, tts),
                jax.device_get(jm), {k: float(v) for k, v in tm.items()}))
    return out


def hold_option_updates(runs, after):
    """After ``after`` updates: networks, targets and Adam moments (V's
    included) at rtol 1e-5 / atol 1e-6 (nu atol 1e-9), as in
    ``test_torch_optax.py``: float32 sums in other orders; the metrics
    (losses, the mean importance weight, the entropy) as ``metric_tol``
    says."""
    want, got, jm, tm = runs["states"][after - 1]
    alg = runs["alg"]
    hold_states(got, want, alg.net_names())
    assert got.step == want.step == after
    assert set(tm) == set(jm) - {"grads"}
    for k in tm:
        np.testing.assert_allclose(tm[k], float(jm[k]), err_msg=k,
                                   **metric_tol(alg.cfg, k))


def hold_options_take_effect(runs):
    """The run has the critics its options ask for, the metrics of its
    corrections, and its freeze: while frozen the actor and its Adam
    state are unchanged (count and moments), after it they move."""
    alg = runs["alg"]
    cfg = alg.cfg
    _, st1, _, m1 = runs["states"][0]
    assert (st1.qc is None) == (runs["n"] == 1 or not cfg.use_Q_credit)
    assert (st1.v is None) == (runs["n"] == 1 or not cfg.use_V)
    if cfg.pg_is_clip:
        assert 0.0 < m1["is_weight_mean"] <= cfg.pg_is_clip
    if cfg.pg_ent_coef:
        assert 0.0 < m1["policy_entropy"] <= np.log(5.0) + 1e-6
    freeze = cfg.actor_freeze_updates
    start = runs["start"]
    for i, (_, st, _, _) in enumerate(runs["states"]):
        assert st.opt_actor.count == max(0, i + 1 - freeze)
        frozen = i < freeze
        assert torch.equal(st.actor.flat, start.actor.flat) == frozen, i
        assert (float(st.opt_actor.mu.abs().max()) == 0.0) == frozen, i


# --------------------------------------------------------------------- #
# the baselines and QMIX: updates in both packages
# (test_torch_baseline*.py, test_torch_qmix.py)
# --------------------------------------------------------------------- #


def update_runs(ja, ta, batches, gumbel=True, eps=0.2):
    """Updates of the JAX and the port's algorithm from the same
    converted state on the same batches (and, with ``gumbel``, the same
    a' noise); after each: (JAX state converted, the port's state, JAX's
    metrics, the port's metrics as floats), plus the algorithm and its
    start."""
    b, n = batches[0]["a"].shape
    jts = ja.init_state(jax.random.PRNGKey(1), batches[0]["obs"],
                        batches[0]["state"], batches[0]["goals"])
    tts = convert.state_from_jax(ta, jax.device_get(jts))
    upd = jax.jit(ja.update)
    out = {"alg": ta, "states": [], "start": copy_state(ta, tts)}
    for i, batch in enumerate(batches):
        key = jax.random.PRNGKey(5 + i)
        jts, jm = upd(jts, batch, eps, key)
        noise = (torch.from_numpy(np.array(jax.random.gumbel(key, (b, n, 5))))
                 if gumbel else None)
        tts, tm = ta.update(tts, to_torch(jax.device_get(batch)), eps, noise)
        out["states"].append((convert.state_from_jax(
            ta, jax.device_get(jts)), copy_state(ta, tts),
            jax.device_get(jm), {k: float(v) for k, v in tm.items()}))
    return out


def other_runs(kind, opts, n_updates=OPTION_UPDATES, b=OPTION_B):
    """``n_updates`` Baseline or QMIX updates (``kind`` as in
    ``other_algs``) with the options ``opts`` in both packages from the
    same converted state, on the same batches (and for the baselines
    the same a' noise): ``update_runs``' record, and the batches."""
    je, _ = envs()
    ja, ta = other_algs(kind, je.spec(), **opts)
    rng = np.random.default_rng(0)
    batches = [replay_batch(je, b, rng) for _ in range(n_updates)]
    out = update_runs(ja, ta, batches, gumbel=kind != "qmix")
    out["batches"] = batches
    return out


# QMIX's state at atol 1e-4 (networks, targets, mu) and 1e-7 (nu).
# Its gradients are large (|g| up to 130: the mixer's hypernetwork
# products), and a float32 gradient sums terms of that size, so XLA's
# and PyTorch's CPU sums differ by up to 1.2e-7 of max |g| (1.5e-5)
# where CM3's differ by ulps of O(1) values, and by at most 1.2e-9
# where |g| < 1e-6 (``test_torch_qmix.py::test_qmix_gradient_matches_jax``).
# nu = (1 - b2) g^2 then differs by ~2e-3 |g| dg: measured 3.05e-8 (24
# of 270,987 floats in the S = 3 update).  One Adam step moves a float
# by lr * g / (|g| + eps) (first step), so a gradient near eps = 1e-8
# carries its rounding into the step amplified up to lr * dg / eps: the
# mixer has such gradients (hyper_w_1's rows of conv units that few
# samples leave nonzero: cancelling sums of ~3e-8).  Measured: 2 of
# 90,329 floats 2.37e-6 apart after one step, 1 of 270,987 1.59e-5
# apart in the S = 3 update; the rest within 1e-6.
QMIX_TOL = dict(atol=1e-4, atol_nu=1e-7)


def hold_other_updates(runs, after, **tol):
    """After ``after`` updates: networks, targets and Adam moments at
    rtol 1e-5 / atol 1e-6 (nu atol 1e-9) unless ``tol`` says otherwise
    (``QMIX_TOL``), as ``hold_option_updates``; the metrics at rtol
    1e-5 / atol 1e-6."""
    want, got, jm, tm = runs["states"][after - 1]
    hold_states(got, want, runs["alg"].net_names(), **tol)
    assert got.step == want.step == after
    assert set(tm) == set(jm)
    for k in tm:
        np.testing.assert_allclose(tm[k], float(jm[k]), rtol=1e-5,
                                   atol=1e-6, err_msg=k)


# --------------------------------------------------------------------- #
# particle (test_torch_particle*.py, test_torch_onpolicy*.py)
# --------------------------------------------------------------------- #

# the particle nets at narrow widths; the layer structure is the full one
SMALL_PARTICLE_NN = dict(Q_units=16, V_n_others=8, V_n_h2=12,
                         Actor_n_others=8, Actor_n_h2=12)


def particle_envs(name, **over):
    """The JAX and the port's particle engines for ``particle_<name>.json``
    (``prob_random`` and ``max_steps`` from ``over``)."""
    from cm3_tpu.envs.particle import Particle as JaxParticle
    from cm3_tpu_torch.envs.particle import Particle as TorchParticle
    j = JaxParticle(jcfg.particle_env_config(name, **over))
    t = TorchParticle(tcfg.particle_env_config(name, **over), device="cpu")
    return j, t


def particle_reset_draws(key, n, n_agents):
    """What ``ParticleHooks.episode_init`` draws for n instances from
    ``key`` (``prng.split_batch``, then the reset's split into four,
    ``particle.py:70-76``): ([branch [n], agents [n, N, 2], landmarks
    [n, N, 2]] uniforms, [noise [n, N, 2]] normals), in the order the
    port's reset asks for them."""
    keys = jax.vmap(lambda i: jax.random.fold_in(key, i))(jnp.arange(n))

    def one(k):
        kb, ka, kl, kn = jax.random.split(k, 4)
        return (jax.random.uniform(kb),
                jax.random.uniform(ka, (n_agents, 2), minval=-1.0,
                                   maxval=1.0),
                jax.random.uniform(kl, (n_agents, 2), minval=-1.0,
                                   maxval=1.0),
                jax.random.normal(kn, (n_agents, 2)))
    b, a, l, z = (np.asarray(x) for x in jax.vmap(one)(keys))
    return [b, a, l], [z]


class ParticleDraws:
    """Accumulates the draws a port driver asks for on particle, kind by
    kind in its order, from JAX keys split as the JAX driver splits them;
    ``fed(device)`` makes the ``prng.FedDraws``."""

    def __init__(self, n_agents, n_actions=5, qmix=False):
        self.n, self.a, self.qmix = n_agents, n_actions, qmix
        self.randints, self.gumbels, self.uniforms, self.normals = \
            [], [], [], []

    def reset(self, key, n):
        u, z = particle_reset_draws(key, n, self.n)
        self.uniforms += u
        self.normals += z

    def act(self, key, e):
        if self.qmix:
            rand_a, u = qmix_act_draws(key, (e, self.n), self.a)
            self.randints.append(rand_a)
            self.uniforms.append(u)
        else:
            self.gumbels.append(np.asarray(jax.random.gumbel(
                key, (e, self.n, self.a))))

    def step(self, key, e, random_actions):
        """One ``_step_once`` (offpolicy.py:242-248): actions, then the
        auto-reset's draws for every instance."""
        k_act, k_rand, k_reset = jax.random.split(key, 3)
        if random_actions:
            self.randints.append(np.asarray(jax.random.randint(
                k_rand, (e, self.n), 0, self.a)))
        else:
            self.act(k_act, e)
        self.reset(k_reset, e)

    def rollout(self, key, e, steps, random_actions):
        for k in jax.random.split(key, steps):
            self.step(k, e, random_actions)

    def update(self, key, batch, size):
        """One update of a burst or chunk: the replay indices, then the
        update's a' noise (none for QMIX); ``size`` [D] for shards."""
        k_sample, k_update = jax.random.split(key)
        if np.ndim(size):
            self.randints.append(sharded_indices(k_sample, batch, size))
        else:
            self.randints.append(np.asarray(jax.random.randint(
                k_sample, (batch,), 0, jnp.maximum(jnp.int32(size), 1))))
        if not self.qmix:
            self.gumbels.append(np.asarray(jax.random.gumbel(
                k_update, (batch, self.n, self.a))))

    def chunk(self, key, e, steps, random_actions, n_updates=0, batch=0,
              sizes=0):
        """``OffPolicyDriver._chunk`` (offpolicy.py:345-385): the env
        steps, then each update's draws; ``sizes`` is the replay fill
        the updates see, or (bad, good) for the dual buffer."""
        self.rollout(key, e, steps, random_actions)
        for k in jax.random.split(jax.random.fold_in(key, 7), n_updates):
            if isinstance(sizes, tuple):
                self.update_dual(k, batch, *sizes)
            else:
                self.update(k, batch, sizes)

    def update_dual(self, key, batch, s_bad, s_good):
        """One update on the dual buffer (``buffer.py:153-195``): the
        bad memory's indices, the good one's, then the a' noise (none
        for QMIX); the fills [D] for shards."""
        k_sample, k_update = jax.random.split(key)
        if np.ndim(s_bad):
            self.randints += list(sharded_dual_indices(k_sample, batch,
                                                       s_bad, s_good))
        else:
            k1, k2 = jax.random.split(k_sample)
            for k, size in ((k1, s_bad), (k2, s_good)):
                self.randints.append(np.asarray(jax.random.randint(
                    k, (batch,), 0, jnp.maximum(jnp.int32(size), 1))))
        if not self.qmix:
            self.gumbels.append(np.asarray(jax.random.gumbel(
                k_update, (batch, self.n, self.a))))

    def burst(self, key, epochs, batch, size):
        """``OnPolicyDriver._train_burst`` (onpolicy.py:52-62); ``size``
        is the ring's fill, or (bad, good) for the dual buffer."""
        for k in jax.random.split(key, epochs):
            if isinstance(size, tuple):
                self.update_dual(k, batch, *size)
            else:
                self.update(k, batch, size)

    def evaluate(self, key, n_eval, max_steps):
        """``OffPolicyDriver.evaluate`` (offpolicy.py:389-432)."""
        self.reset(key, n_eval)
        for k in jax.random.split(key, max_steps):
            self.act(k, n_eval)

    def lists(self):
        return self.randints, self.gumbels, self.uniforms, self.normals

    def fed(self, device="cpu"):
        from cm3_tpu_torch.core import prng
        return prng.FedDraws(self.randints, self.gumbels, device=device,
                             uniforms=self.uniforms, normals=self.normals)


def stacked_particle_draws(per_seed, device="cpu"):
    """``ParticleDraws`` of S seeds with equal structure -> the FedDraws
    of a driver of S seeds, every draw [S, ...]."""
    from cm3_tpu_torch.core import prng
    lists = [d.lists() for d in per_seed]
    stack = [[np.stack(xs) for xs in zip(*(l[i] for l in lists))]
             for i in range(4)]
    return prng.FedDraws(stack[0], stack[1], device=device,
                         uniforms=stack[2], normals=stack[3])


def particle_algs(kind, spec, n_seeds=None, **alg):
    """The JAX and the port's CM3 (``kind`` "cm3"), Baseline
    ("baseline") or QMIX ("qmix") for a particle engine's spec at
    SMALL_PARTICLE_NN widths; stage 2 for several agents, stage 1 for
    one.  CM3 runs the optax path unless ``alg`` says fused_opt."""
    n = spec["n_agents"]
    kw = dict(n_agents=n, stage=2 if n > 1 else 1,
              alg_name={"cm3": "cm3", "qmix": "qmix"}.get(kind, "coma"))
    kw.update(alg)
    jcls, tcls = {"cm3": (JaxCM3, TorchCM3), "qmix": (JaxQMIX, TorchQMIX),
                  "baseline": (JaxBaseline, TorchBaseline)}[kind]
    j = jcls("particle", spec, jcfg.AlgConfig(**kw),
             jcfg.NNConfig(**SMALL_PARTICLE_NN))
    t = tcls("particle", spec, tcfg.AlgConfig(**kw),
             tcfg.NNConfig(**SMALL_PARTICLE_NN), device="cpu",
             n_seeds=n_seeds)
    return j, t


def particle_batch(env, b, rng):
    """A replay-like batch of b real particle transitions of ``env``
    (JAX): uniform-random starts, a few random steps, noisy local
    rewards, some terminal rows; no previous action (particle stores
    none)."""
    n = env.cfg.n_agents
    keys = jax.random.split(jax.random.PRNGKey(int(rng.integers(1 << 30))),
                            b)
    s, ts = jax.vmap(env.reset)(keys)
    for _ in range(3):
        s, ts = jax.vmap(env.step)(
            s, jnp.asarray(rng.integers(0, 5, (b, n)), jnp.int32))
    a = jnp.asarray(rng.integers(0, 5, (b, n)), jnp.int32)
    _, ts2 = jax.vmap(env.step)(s, a)
    return {"obs": ts.obs, "state": ts.state, "a": a, "r": ts2.reward,
            "rl": ts2.reward_local + jnp.asarray(rng.normal(size=(b, n)),
                                                 jnp.float32),
            "obs_next": ts2.obs, "state_next": ts2.state,
            "done": jnp.asarray(rng.random(b) < 0.3), "goals": s.landmarks}


PARTICLE_B, PARTICLE_UPDATES = 16, 3


def particle_case_runs(kind, scenario, opts):
    """PARTICLE_UPDATES updates of ``kind`` (``particle_algs``) with the
    options ``opts`` on ``scenario``'s engine in both packages
    (``update_runs``), on batches from uniform-random starts."""
    je, _ = particle_envs(scenario, prob_random=1.0)
    ja, ta = particle_algs(kind, je.spec(), **opts)
    rng = np.random.default_rng(0)
    batches = [particle_batch(je, PARTICLE_B, rng)
               for _ in range(PARTICLE_UPDATES)]
    out = update_runs(ja, ta, batches, gumbel=kind != "qmix")
    out["kind"] = kind
    return out


def hold_particle_seeds(kind, opts, s=3):
    """One update with S seeds (each its own batch, epsilon and a'
    noise) in the port's seed stacks against ``jax.vmap`` of JAX's
    update on four-agent particle batches, at ``hold_states``'
    tolerances; the seeds apart."""
    je, _ = particle_envs("stage2_antipodal", prob_random=1.0)
    ja, ta = particle_algs(kind, je.spec(), n_seeds=s, **opts)
    hold_seeds(ja, ta, lambda rng: particle_batch(je, PARTICLE_B, rng), s)


def hold_seeds(ja, ta, make_batch, s=3):
    """One update of the JAX algorithm ``ja`` under ``jax.vmap`` and of
    the port's ``ta`` (built for S seeds) from the same converted state,
    each seed on its own batch of ``make_batch(rng)``, epsilon and a'
    noise; states at ``hold_states``' tolerances, metrics [S] at rtol
    1e-5 / atol 1e-6, the seeds apart."""
    eps = np.array([0.1, 0.2, 0.3], np.float32)[:s]
    rng = np.random.default_rng(3)
    batches = [jax.device_get(make_batch(rng)) for _ in range(s)]
    batch = jax.tree_util.tree_map(lambda *x: np.stack(x), *batches)
    b, n = batch["a"].shape[1:]
    jts = jax.vmap(ja.init_state)(
        jax.random.split(jax.random.PRNGKey(1), s), batch["obs"],
        batch["state"], batch["goals"])
    tts = convert.state_from_jax(ta, jax.device_get(jts))
    keys = jax.random.split(jax.random.PRNGKey(9), s)
    jts, jm = jax.jit(jax.vmap(ja.update))(jts, batch, jnp.asarray(eps),
                                           keys)
    noise = torch.from_numpy(np.stack(
        [np.asarray(jax.random.gumbel(k, (b, n, 5))) for k in keys]))
    tts, tm = ta.update(tts, to_torch(batch), torch.from_numpy(eps), noise)
    want = convert.state_from_jax(ta, jax.device_get(jts))
    hold_states(tts, want, ta.net_names())
    assert tts.step == want.step == 1
    assert set(tm) == set(jm)
    for k, v in tm.items():
        assert v.shape == (s,)
        np.testing.assert_allclose(v.numpy(), np.asarray(jm[k]), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    first = getattr(tts, ta.net_names()[0]).flat
    assert not torch.equal(first[0], first[1])


def hold_particle_networks(runs, want):
    """The state has exactly the networks ``want`` and every one moved."""
    assert runs["alg"].net_names() == want
    _, st, _, _ = runs["states"][-1]
    for name in want:
        assert not torch.equal(getattr(st, name).flat,
                               getattr(runs["start"], name).flat), name


# --------------------------------------------------------------------- #
# roadway and the dual buffer (test_torch_roadway_*.py,
# test_torch_dual_*.py)
# --------------------------------------------------------------------- #

# the baselines' roadway critics at narrow widths (the roadway actor,
# CM3's critics and QMIX's agent net have fixed widths in both packages)
SMALL_ROADWAY_NN = dict(Q_units=16, V_n_others=8, V_n_h2=12)
# a short road at top speed: cars start 40 m before the goal at 50 m/s
# (v_max), so that episodes end in 4-6 steps (or at a collision),
# auto-resets fall inside chunks, and the filter replaces every ACC
# until a car has slowed down
SHORT_ROAD = dict(init_position=(150.0, 150.0), speed=(50.0, 50.0))


def roadway_envs(stage=2, prob_random=0.5, **over):
    """The JAX and the port's roadway engines for
    ``roadway_stage<stage>.json`` with ``prob_random`` and the config
    fields ``over``."""
    import dataclasses
    from cm3_tpu.envs.roadway import Roadway as JaxRoadway
    from cm3_tpu_torch.envs.roadway import Roadway as TorchRoadway
    jc = dataclasses.replace(jcfg.roadway_env_config(stage, prob_random),
                             **over)
    tc = dataclasses.replace(tcfg.roadway_env_config(stage, prob_random),
                             **over)
    return JaxRoadway(jc), TorchRoadway(tc, device="cpu")


def roadway_reset_draws(key, n, n_agents, n_lanes=4):
    """What ``RoadwayHooks.episode_init`` draws for n instances from
    ``key`` (``prng.split_batch``, then the split into four,
    ``experiments.py:138-151``, the fourth key the reset's normal):
    ([branch [n]] uniforms, [lanes [n, N], goal lanes [n, N]] randints,
    [depart noise [n, N]] normals)."""
    keys = jax.vmap(lambda i: jax.random.fold_in(key, i))(jnp.arange(n))

    def one(k):
        kr, kl, kg, ke = jax.random.split(k, 4)
        return (jax.random.uniform(kr),
                jax.random.randint(kl, (n_agents,), 0, n_lanes),
                jax.random.randint(kg, (n_agents,), 0, 4),
                jax.random.normal(ke, (n_agents,)))
    u, lanes, goals, z = (np.asarray(x) for x in jax.vmap(one)(keys))
    return [u], [lanes, goals], [z]


class RoadwayDraws(ParticleDraws):
    """``ParticleDraws`` for roadway: the reset draws the branch
    uniform, the lanes, the goal lanes and the depart noise."""

    def reset(self, key, n):
        u, r, z = roadway_reset_draws(key, n, self.n)
        self.uniforms += u
        self.randints += r
        self.normals += z


def roadway_algs(kind, spec, n_seeds=None, **alg):
    """The JAX and the port's CM3, Baseline or QMIX (as
    ``particle_algs``) on roadway; the baselines' critics at
    SMALL_ROADWAY_NN widths."""
    n = spec["n_agents"]
    kw = dict(n_agents=n, stage=2 if n > 1 else 1,
              alg_name={"cm3": "cm3", "qmix": "qmix"}.get(kind, "coma"))
    kw.update(alg)
    jcls, tcls = {"cm3": (JaxCM3, TorchCM3), "qmix": (JaxQMIX, TorchQMIX),
                  "baseline": (JaxBaseline, TorchBaseline)}[kind]
    j = jcls("roadway", spec, jcfg.AlgConfig(**kw),
             jcfg.NNConfig(**SMALL_ROADWAY_NN))
    t = tcls("roadway", spec, tcfg.AlgConfig(**kw),
             tcfg.NNConfig(**SMALL_ROADWAY_NN), device="cpu",
             n_seeds=n_seeds)
    return j, t


def roadway_batch(env, b, rng):
    """A replay-like batch of b real roadway transitions of ``env``
    (JAX): random lanes and goal lanes, a few random feasible steps,
    noisy local rewards, some terminal rows; no previous action."""
    n = env.cfg.n_agents
    lanes = jnp.asarray(rng.integers(0, 4, (b, n)), jnp.int32)
    goal_lanes = jnp.asarray(rng.integers(0, 4, (b, n)), jnp.int32)
    keys = jax.random.split(jax.random.PRNGKey(int(rng.integers(1 << 30))),
                            b)
    acts = jnp.asarray(rng.integers(0, 5, (4, b, n)), jnp.int32)
    ts, a, ts2 = _roadway_steps(env)(keys, lanes, goal_lanes, acts)
    return {"obs": ts.obs, "state": ts.state, "a": a, "r": ts2.reward,
            "rl": ts2.reward_local + jnp.asarray(rng.normal(size=(b, n)),
                                                 jnp.float32),
            "obs_next": ts2.obs, "state_next": ts2.state,
            "done": jnp.asarray(rng.random(b) < 0.3),
            "goals": jax.nn.one_hot(goal_lanes, 4, dtype=jnp.float32)}


_ROADWAY_STEPS = {}


def _roadway_steps(env):
    """A jitted reset and four filtered steps of ``env``'s config
    (compiled once per config): -> (timestep before the last step, its
    filtered action, timestep after)."""
    if env.cfg not in _ROADWAY_STEPS:
        def run(keys, lanes, goal_lanes, acts):
            s, ts = jax.vmap(env.reset)(keys, dict(lanes=lanes,
                                                   goal_lanes=goal_lanes))
            check, step = jax.vmap(env.check_actions), jax.vmap(env.step)
            for k in range(3):
                s, ts = step(s, check(s, acts[k]))
            a = check(s, acts[3])
            return ts, a, step(s, a)[1]
        _ROADWAY_STEPS[env.cfg] = jax.jit(run)
    return _ROADWAY_STEPS[env.cfg]


ROADWAY_B, ROADWAY_UPDATES = 16, 3
# Roadway CM3's stage-2 state at atol 1e-5 (networks, targets, mu).  Its
# Q_credit is 256 wide (102,785 floats), and one float's first gradient
# in these batches is 1.2e-8, next to Adam's eps (1e-8): the two
# packages' gradients, float32 sums in other orders, are 2.3e-10 apart
# there (7.5e-9 at most over the network, of |g| up to 0.042), and the
# first Adam step lr * g / (|g| + eps) turns that into 4.77e-6 (measured
# after 1, 2 and 3 updates, optax and fused alike); every other float
# of every roadway case is within 1e-6, as QMIX_TOL's note explains.
ROADWAY_QC_TOL = dict(atol=1e-5)


def roadway_case_runs(kind, stage, opts):
    """ROADWAY_UPDATES updates of ``kind`` (``roadway_algs``) with the
    options ``opts`` at ``stage`` (one car at 1, two at 2) in both
    packages (``update_runs``), on batches from random lanes."""
    je, _ = roadway_envs(stage)
    ja, ta = roadway_algs(kind, je.spec(), **opts)
    rng = np.random.default_rng(stage)
    batches = [roadway_batch(je, ROADWAY_B, rng)
               for _ in range(ROADWAY_UPDATES)]
    out = update_runs(ja, ta, batches, gumbel=kind != "qmix")
    out["kind"] = kind
    return out
