"""The particle nets against the flax nets: the forwards after
``convert`` (narrow widths and the full widths of ``master.json``'s
"nn", stage 1 and stage 2, two and four agents), the leaf names and
shapes against the flax tree under each init scheme (so that the graft
and ``convert`` find them), and the port's initializers (``FC3``'s and
the mixer's fixed truncated normals; the ablation V's nested
``stage2`` layers)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cm3_tpu.models import nets as jnets
from cm3_tpu_torch import convert
from cm3_tpu_torch.models import nets as tnets
from tests import torch_parity as tp

tp.set_torch_cpu()

B = 24
SMALL = dict(others=8, h2=12, units=16)
FULL = dict(others=128, h2=64, units=256)       # master.json "nn"
NETS = ("actor", "q_global", "q_credit", "v_ablation", "v_local",
        "v_global", "q_coma", "qmix_agent", "qmix_mixer")


def _spec(n):
    return dict(l_action=5, l_goal=2, l_obs_self=4,
                l_obs_others=4 * max(n - 1, 1), l_state_one=4, n_agents=n)


def _pair(name, w, n=4, stage=2):
    """(flax module, torch module, example inputs as numpy) for n agents
    at ``stage``."""
    rng = np.random.default_rng(n + stage)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    a1h = lambda *s: np.eye(5, dtype=np.float32)[rng.integers(0, 5, s)]
    spec = _spec(n)
    oth = spec["l_obs_others"]
    if name == "actor":
        kw = dict(n_h1_others=w["others"], n_h2=w["h2"], stage=stage)
        return (jnets.ActorParticle(n_actions=5, **kw),
                tnets.ActorParticle(spec, **kw), [f(B, oth), f(B, 4),
                                                  f(B, 2)])
    if name == "q_global":
        return (jnets.QGlobalParticle(stage=stage),
                tnets.QGlobalParticle(spec, stage=stage),
                [f(B, 4), f(B, 2), a1h(B), f(B, 4 * (n - 1)),
                 a1h(B, n - 1)])
    if name == "q_credit":
        return (jnets.QCreditParticle(stage=stage),
                tnets.QCreditParticle(spec, stage=stage),
                [f(B, 4), f(B, 2), a1h(B), f(B, 4), f(B, 4 * (n - 1))])
    if name == "v_ablation":
        return (jnets.VParticleAblation(), tnets.VParticleAblation(spec),
                [f(B, 4), f(B, 2), f(B, 4 * (n - 1))])
    if name in ("v_local", "v_global"):
        kw = dict(n_h1_2=w["others"], n_h2=w["h2"], stage=stage)
        if name == "v_local":
            return (jnets.VParticleLocal(**kw),
                    tnets.VParticleLocal(spec, **kw),
                    [f(B, oth), f(B, 4), f(B, 2)])
        return (jnets.VParticleGlobal(**kw), tnets.VParticleGlobal(spec, **kw),
                [f(B, 4), f(B, 2), f(B, 4 * (n - 1)), f(B, 2 * (n - 1))])
    if name == "q_coma":
        return (jnets.QComa(n_actions=5, units=w["units"]),
                tnets.QComa(spec, units=w["units"]),
                [f(B, 4 * n), a1h(B, n - 1), f(B, 2), f(B, 2 * (n - 1)),
                 np.tile(np.eye(n, dtype=np.float32), (B // n, 1)),
                 f(B, 4)])
    if name == "qmix_agent":
        return (jnets.QmixSingleParticle(n_actions=5),
                tnets.QmixSingleParticle(spec), [f(B, oth), f(B, 4),
                                                 f(B, 2)])
    return (jnets.QmixMixer(n_agents=n), tnets.QmixMixer(spec),
            [f(B, n), f(B, 4 * n), f(B, 2 * n)])


# (name, agents, stage) of every net as the algorithms build it: the
# staged nets at stage 1 (one agent) and 2, the others at stage 2 with
# four agents and (the merge scenario) two
CASES = ([(name, 1, 1) for name in ("actor", "q_global", "v_local",
                                    "v_global")]
         + [(name, 4, 2) for name in NETS]
         + [(name, 2, 2) for name in ("q_credit", "q_coma", "qmix_mixer")])


def _perturbed(params):
    """Every leaf moved off its initial value (zero biases included)."""
    return jax.tree_util.tree_map(
        lambda x: x + 0.01 * jnp.arange(x.size, dtype=x.dtype).reshape(
            x.shape) / x.size, params)


@pytest.mark.parametrize("width", ["small", "full"])
@pytest.mark.parametrize("name,n,stage", CASES)
def test_forward_matches_flax_after_convert(name, n, stage, width):
    """Tolerance 1e-5, as ``test_torch_nets.py``: float32 sums in
    another order (XLA's and PyTorch's CPU matrix products)."""
    jmod, tmod, inputs = _pair(name, SMALL if width == "small" else FULL,
                               n, stage)
    params = _perturbed(jmod.init(jax.random.PRNGKey(0),
                                  *map(jnp.asarray, inputs)))
    tmod = tnets.flatten_parameters(tmod)
    convert.load_params(tmod, jax.device_get(params))
    want = np.asarray(jmod.apply(params, *map(jnp.asarray, inputs)))
    with torch.no_grad():
        got = tmod(*map(torch.from_numpy, inputs)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("scheme", ["ref", "tf1", "trunc001"])
@pytest.mark.parametrize("name,n,stage", CASES)
def test_leaves_follow_the_flax_tree(name, n, stage, scheme):
    """The port's parameters, in flat order, are the flax tree's leaves
    in ``ravel_pytree`` order: the same paths and (in flax layout) the
    same sizes, under each init scheme."""
    jmod, tmod, inputs = _pair(name, SMALL, n, stage)
    with jnets.init_scheme(scheme):
        params = jmod.init(jax.random.PRNGKey(1), *map(jnp.asarray, inputs))
    leaves = jax.tree_util.tree_flatten_with_path(params["params"])[0]
    got = [(tnets.flax_path(k), convert._flax_shape(tnets.flax_path(k),
                                                    tuple(p.shape)))
           for k, p in tnets.ordered_parameters(tmod)]
    assert got == [(tuple(k.key for k in path), leaf.shape)
                   for path, leaf in leaves]


def test_full_width_sizes():
    """At N = 4 and master.json's widths: the actor 14,789 floats,
    Q_global 16,704, Q_credit 15,296 (the fused update's two segments:
    the actor, and both critics' 32,000 together)."""
    sizes = {name: sum(p.numel() for p in _pair(name, FULL)[1].parameters())
             for name in ("actor", "q_global", "q_credit")}
    assert sizes == {"actor": 14789, "q_global": 16704, "q_credit": 15296}


@pytest.mark.parametrize("scheme", ["ref", "tf1", "trunc001"])
@pytest.mark.parametrize("name", ["actor", "v_ablation", "q_coma",
                                  "qmix_mixer"])
def test_init_rules(name, scheme):
    """``FC3``'s kernels and the mixer's ``hyper_w_*`` and every ``W_h2``
    are truncated normal 0.01 under every scheme; other kernels and
    ``hyper_b_1`` Glorot except under trunc001; biases zero; ``b`` zero
    except under tf1."""
    _, tmod, _ = _pair(name, FULL)
    tnets.init_parameters(tmod, torch.Generator().manual_seed(0), scheme)
    for k, x in tmod.named_parameters():
        x = x.detach()
        leaf = k.split(".")[-1]
        trunc = (name == "q_coma" and leaf == "weight") or leaf in (
            "W_h2", "hyper_w_1", "hyper_w_final") or (
            scheme == "trunc001" and leaf in ("weight", "hyper_b_1"))
        if leaf == "bias":
            assert torch.all(x == 0), k
        elif trunc:
            assert x.abs().max() <= 0.02 and x.std() > 0.003, k
        elif leaf == "b":
            if scheme == "tf1":
                assert x.abs().max() <= (3.0 / x.numel()) ** 0.5, k
                assert x.abs().max() > 0.0, k
            else:
                assert torch.all(x == 0), k
        else:
            fan_in, fan_out = tnets._fans(tuple(x.shape))
            limit = (6.0 / (fan_in + fan_out)) ** 0.5
            assert limit >= x.abs().max() > 0.5 * limit, k
