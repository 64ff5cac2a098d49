"""The baselines' and QMIX's Checkers nets against the flax nets: the
forwards after ``convert`` (small and full widths, both stages of the V
critics), the leaf names and shapes against the flax tree under each
init scheme, the port's initializers (``FC3``'s and the mixer's fixed
truncated normals), the mixer's raw matrices loaded untransposed, and
QMIX's joint buffer in ``optax.flatten`` order over (agent, mixer)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from cm3_tpu.models import nets as jnets
from cm3_tpu_torch import convert
from cm3_tpu_torch.models import nets as tnets
from cm3_tpu_torch.train import checkpoint
from tests import torch_parity as tp
from tests.test_torch_nets import SPEC

tp.set_torch_cpu()

B = 24
SMALL = dict(V=dict(conv_f=2, conv_k=(3, 3), n_h1_1=16, n_h1_2=8, n_h2=16),
             units=16, A=dict(conv_f=2, conv_k=(3, 3)))
FULL = dict(V=dict(conv_f=6, conv_k=(3, 3), n_h1_1=256, n_h1_2=32,
                   n_h2=256), units=256, A=dict(conv_f=6, conv_k=(3, 3)))
NETS = ("v_local1", "v_local2", "v_global1", "v_global2", "q_coma",
        "qmix_agent", "qmix_mixer")


def _pair(name, w):
    """(flax module, torch module, example inputs as numpy)."""
    rng = np.random.default_rng(0)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    a1h = lambda *s: np.eye(5, dtype=np.float32)[rng.integers(0, 5, s)]
    t_obs, grid = f(B, 5, 5, 3), f(B, 3, 9, 2)
    if name.startswith("v_local"):
        kw = dict(w["V"], stage=int(name[-1]))
        return (jnets.VCheckersLocal(**kw), tnets.VCheckersLocal(SPEC, **kw),
                [t_obs, f(B, 4), f(B, 2), f(B, 2)])
    if name.startswith("v_global"):
        kw = dict(stage=int(name[-1]))
        return (jnets.VCheckersGlobal(**kw),
                tnets.VCheckersGlobal(SPEC, **kw),
                [grid, f(B, 4), f(B, 2), f(B, 4)])
    if name == "q_coma":
        return (jnets.QComaCheckers(n_actions=5, units=w["units"]),
                tnets.QComaCheckers(SPEC, units=w["units"]),
                [grid, f(B, 8), a1h(B, 1), f(B, 2), f(B, 2),
                 np.tile(np.eye(2, dtype=np.float32), (B // 2, 1)), t_obs,
                 f(B, 4)])
    if name == "qmix_agent":
        return (jnets.QmixSingleCheckers(n_actions=5, **w["A"]),
                tnets.QmixSingleCheckers(SPEC, **w["A"]),
                [a1h(B), t_obs, f(B, 4), f(B, 2), f(B, 2)])
    return (jnets.QmixMixerCheckers(n_agents=2), tnets.QmixMixerCheckers(SPEC),
            [f(B, 2), grid, f(B, 8), f(B, 4)])


def _perturbed(params):
    """Every leaf moved off its initial value (zero biases included),
    so that the test sees each leaf's layout."""
    return jax.tree_util.tree_map(
        lambda x: x + 0.01 * jnp.arange(x.size, dtype=x.dtype).reshape(
            x.shape) / x.size, params)


def _loaded(name, w, seed=0):
    jmod, tmod, inputs = _pair(name, w)
    params = _perturbed(jmod.init(jax.random.PRNGKey(seed),
                                  *map(jnp.asarray, inputs)))
    tmod = tnets.flatten_parameters(tmod)
    convert.load_params(tmod, jax.device_get(params))
    return jmod, tmod, params, inputs


@pytest.mark.parametrize("width", ["small", "full"])
@pytest.mark.parametrize("name", NETS)
def test_forward_matches_flax_after_convert(name, width):
    """Tolerance 1e-5, as ``test_torch_nets.py``: float32 sums in
    another order (XLA against PyTorch's CPU convolutions and matrix
    products)."""
    jmod, tmod, params, inputs = _loaded(name, SMALL if width == "small"
                                         else FULL)
    want = np.asarray(jmod.apply(params, *map(jnp.asarray, inputs)))
    with torch.no_grad():
        got = tmod(*map(torch.from_numpy, inputs)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("scheme", ["ref", "tf1", "trunc001"])
@pytest.mark.parametrize("name", NETS)
def test_leaves_follow_the_flax_tree(name, scheme):
    """Under each init scheme the port's parameters, in flat order, are
    the flax tree's leaves in ``ravel_pytree`` order: the same paths and
    (in flax layout) the same sizes; raw leaves keep flax's shape."""
    jmod, tmod, inputs = _pair(name, SMALL)
    with jnets.init_scheme(scheme):
        params = jmod.init(jax.random.PRNGKey(1), *map(jnp.asarray, inputs))
    leaves = jax.tree_util.tree_flatten_with_path(params["params"])[0]
    got = [(tnets.flax_path(n), convert._flax_shape(tnets.flax_path(n),
                                                    tuple(p.shape)))
           for n, p in tnets.ordered_parameters(tmod)]
    assert got == [(tuple(k.key for k in path), leaf.shape)
                   for path, leaf in leaves]


def _bounded(x, limit, share=0.8):
    return x.abs().max() <= limit and x.abs().max() > share * limit


@pytest.mark.parametrize("scheme", ["ref", "tf1", "trunc001"])
@pytest.mark.parametrize("name", ["q_coma", "qmix_agent", "qmix_mixer"])
def test_init_rules(name, scheme):
    """``FC3``'s kernels and the mixer's ``hyper_w_*`` are truncated
    normal 0.01 under every scheme (``nets.py:364-377, 694-700``);
    ``hyper_b_1`` and the other kernels are Glorot except under
    trunc001; biases are zero; ``b`` is zero except under tf1."""
    _, tmod, _ = _pair(name, FULL)
    tnets.init_parameters(tmod, torch.Generator().manual_seed(0), scheme)
    for n, x in tmod.named_parameters():
        x = x.detach()
        leaf = n.split(".")[-1]
        trunc = (n.startswith("stage2.") and leaf == "weight") or leaf in (
            "W_h2", "hyper_w_1", "hyper_w_final") or (
            scheme == "trunc001" and leaf in ("weight", "hyper_b_1"))
        if leaf == "bias":
            assert torch.all(x == 0), n
        elif trunc:
            assert x.abs().max() <= 0.02 and x.std() > 0.004, n
        elif leaf == "b":
            if scheme == "tf1":
                assert _bounded(x, (3.0 / x.numel()) ** 0.5, 0.5), n
            else:
                assert torch.all(x == 0), n
        else:
            fan_in, fan_out = tnets._fans(tuple(x.shape))
            assert _bounded(x, (6.0 / (fan_in + fan_out)) ** 0.5), n


def test_mixer_raw_matrices_load_untransposed():
    """``hyper_w_1``, ``hyper_b_1`` and ``hyper_w_final`` are raw (d, .)
    matrices, not kernels: they land in the port exactly as flax holds
    them, while the dense kernels beside them are transposed."""
    _, tmod, params, _ = _loaded("qmix_mixer", SMALL)
    p = params["params"]
    views = checkpoint.named_views(tmod)
    for leaf in ("hyper_w_1", "hyper_b_1", "hyper_w_final"):
        np.testing.assert_array_equal(views[leaf].numpy(),
                                      np.asarray(p[leaf]))
    np.testing.assert_array_equal(
        views["hyper_b_final_l1.weight"].numpy(),
        np.asarray(p["hyper_b_final_l1"]["kernel"]).T)


def test_qmix_joint_buffer_is_optax_flatten_order():
    """The joint network's flat buffer holds ``ravel_pytree`` of JAX's
    pair (agent, mixer), the vector JAX's one Adam state lives on: the
    agent's leaves, then the mixer's."""
    ja, ta, pa, _ = _loaded("qmix_agent", SMALL, seed=2)
    jm, tm, pm, _ = _loaded("qmix_mixer", SMALL, seed=3)
    joint = tnets.flatten_parameters(tnets.QmixJoint(
        tnets.QmixSingleCheckers(SPEC, **SMALL["A"]),
        tnets.QmixMixerCheckers(SPEC)))
    convert.load_params(joint, {"params": {"agent": pa["params"],
                                           "mixer": pm["params"]}})
    vec, _ = ravel_pytree((pa, pm))
    np.testing.assert_array_equal(
        convert.flat_to_torch(joint, np.asarray(vec)).numpy(),
        joint.flat.numpy())
    np.testing.assert_array_equal(joint.flat.numpy(), np.concatenate(
        [ta.flat.numpy(), tm.flat.numpy()]))
