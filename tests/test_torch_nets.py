"""The port's Checkers nets against the flax nets: forwards after
``convert`` (at most 1e-5 apart), the flat buffer's order against
``ravel_pytree``, and the init schemes."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from cm3_tpu.models import nets as jnets
from cm3_tpu_torch import convert
from cm3_tpu_torch.core import config as tcfg
from cm3_tpu_torch.models import nets as tnets
from tests import torch_parity as tp

tp.set_torch_cpu()

SPEC = dict(rows_state=3, columns_state=9, channels_state=2, l_state_one=4,
            l_obs_others=2, l_obs_self=4, rows_obs=5, columns_obs=5,
            channels_obs=3, l_action=5, l_goal=2, n_agents=2)
FULL_NN = dict(Q_conv_f=4, Q_conv_k=(3, 5), Q_n_h1_1=256, Q_n_h1_2=32,
               Q_n_h2=256, A_conv_f=6, A_conv_k=(3, 3), A_n_h1=256,
               A_n_h2=256)
# parameter counts of the full-width nets (flat buffer sizes)
FULL_SIZES = {"actor": 149645, "qg": 144741, "qc": 144709}
B = 24


def _pair(name, nn):
    """(flax module, torch module, example inputs as numpy)."""
    rng = np.random.default_rng(0)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    a1h = lambda: np.eye(5, dtype=np.float32)[rng.integers(0, 5, B)]
    if name == "actor":
        kw = dict(conv_f=nn["A_conv_f"], conv_k=nn["A_conv_k"],
                  n_h1=nn["A_n_h1"], n_h2=nn["A_n_h2"], stage=2)
        return (jnets.ActorCheckers(n_actions=5, **kw),
                tnets.ActorCheckers(SPEC, **kw),
                [a1h(), f(B, 5, 5, 3), f(B, 4), f(B, 2), f(B, 2)])
    kw = dict(conv_f1=nn["Q_conv_f"], conv_k1=nn["Q_conv_k"],
              n_h1_1=nn["Q_n_h1_1"], n_h1_2=nn["Q_n_h1_2"],
              n_h2=nn["Q_n_h2"], stage=2)
    if name == "qg":
        return (jnets.QGlobalCheckers(**kw), tnets.QGlobalCheckers(SPEC, **kw),
                [f(B, 3, 9, 2), f(B, 4), f(B, 2), a1h(), f(B, 4),
                 a1h()[:, None], f(B, 5, 5, 3), f(B, 4)])
    return (jnets.QCreditCheckers(**kw), tnets.QCreditCheckers(SPEC, **kw),
            [f(B, 3, 9, 2), f(B, 4), f(B, 2), a1h(), f(B, 4), f(B, 4),
             f(B, 5, 5, 3), f(B, 4)])


def _loaded(name, nn, seed=0):
    jmod, tmod, inputs = _pair(name, nn)
    params = jmod.init(jax.random.PRNGKey(seed), *map(jnp.asarray, inputs))
    # perturb the zero-initialised biases so the test sees their layout
    params = jax.tree_util.tree_map(
        lambda x: x + 0.01 * jnp.arange(x.size, dtype=x.dtype).reshape(
            x.shape) / x.size, params)
    tmod = tnets.flatten_parameters(tmod)
    convert.load_params(tmod, jax.device_get(params))
    return jmod, tmod, params, inputs


@pytest.mark.parametrize("width", ["small", "full"])
@pytest.mark.parametrize("name", ["actor", "qg", "qc"])
def test_forward_matches_flax_after_convert(name, width):
    """Tolerance 1e-5: float32 sums in another order (XLA vs PyTorch
    CPU convolutions and matmuls) over at most ~300 terms."""
    nn = tp.SMALL_NN if width == "small" else FULL_NN
    jmod, tmod, params, inputs = _loaded(name, nn)
    want = np.asarray(jmod.apply(params, *map(jnp.asarray, inputs)))
    with torch.no_grad():
        got = tmod(*map(torch.from_numpy, inputs)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    if width == "full":
        assert tmod.flat.numel() == FULL_SIZES[name]


@pytest.mark.parametrize("name", ["actor", "qg", "qc"])
def test_flat_buffer_follows_ravel_pytree_order(name):
    """Leaf by leaf, the flat buffer holds ravel_pytree's vector, each
    leaf transposed to the torch layout; ``flat_to_torch`` of the
    ravelled params is the loaded buffer itself."""
    jmod, tmod, params, _ = _loaded(name, tp.SMALL_NN)
    vec, _ = ravel_pytree(params)
    np.testing.assert_array_equal(
        convert.flat_to_torch(tmod, np.asarray(vec)).numpy(),
        tmod.flat.numpy())
    paths = [tnets.flax_path(n) for n, _ in tnets.ordered_parameters(tmod)]
    leaves = jax.tree_util.tree_flatten_with_path(params["params"])[0]
    assert paths == [tuple(k.key for k in p) for p, _ in leaves]
    for (n, p), (_, leaf) in zip(tnets.ordered_parameters(tmod), leaves):
        assert p.data_ptr() >= tmod.flat.data_ptr()   # a view into flat
        assert p.numel() == leaf.size


def test_conv_branch_matches_flax():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(B, 13, 9, 2)).astype(np.float32)
    jmod = jnets.ConvBranch(conv_f=4, conv_k=(5, 3), n_reduced=16, n_h2=8)
    params = jmod.init(jax.random.PRNGKey(3), jnp.asarray(x))
    tmod = tnets.flatten_parameters(
        tnets.ConvBranch((13, 9, 2), 4, (5, 3), 16, 8))
    convert.load_params(tmod, jax.device_get(params))
    with torch.no_grad():
        got = tmod(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jmod.apply(params, x)),
                               rtol=1e-5, atol=1e-5)


def _init(scheme):
    mod = tnets.ActorCheckers(SPEC, conv_f=6, conv_k=(3, 3), n_h1=64,
                              n_h2=64, stage=2)
    tnets.init_parameters(mod, torch.Generator().manual_seed(0), scheme)
    return dict(mod.named_parameters())


@pytest.mark.parametrize("scheme", ["ref", "tf1", "trunc001"])
def test_init_schemes(scheme):
    """Bounds of each initializer (nets.py:47-92): Glorot-uniform
    kernels (trunc-normal 0.01 under trunc001), zero biases,
    trunc-normal 0.01 W_h2, and b zero except under tf1."""
    p = _init(scheme)
    for name, x in p.items():
        x = x.detach()
        leaf = name.split(".")[-1]
        if leaf == "bias":
            assert torch.all(x == 0)
        elif leaf == "W_h2" or (leaf == "weight" and scheme == "trunc001"):
            assert x.abs().max() <= 0.02 and x.std() > 0.004
        elif leaf == "weight":
            fan_in, fan_out = tnets._fans(tuple(x.shape))
            lim = (6.0 / (fan_in + fan_out)) ** 0.5
            assert x.abs().max() <= lim and x.abs().max() > 0.8 * lim
        elif leaf == "b":
            if scheme == "tf1":
                lim = (3.0 / x.numel()) ** 0.5
                assert x.abs().max() <= lim and x.abs().max() > 0.5 * lim
            else:
                assert torch.all(x == 0)
    with pytest.raises(ValueError):
        tnets.init_scheme("xavier")


def test_checkers_nn_config_reads_stage2_json():
    """The stage-2 JSON's widths, its IAC critic's among them (V_n_h2
    256 over the generic default 64)."""
    assert tcfg.checkers_nn_config(2) == tcfg.NNConfig(
        **FULL_NN, V_conv_f=6, V_conv_k=(3, 3), V_n_h1_1=256, V_n_h1_2=32,
        V_n_h2=256)
    assert tcfg.NNConfig().V_n_h2 == 64
    env = tcfg.checkers_env_config(2)
    assert (env.n_agents, env.agents_r, env.agents_c) == (2, (0, 2), (8, 8))
