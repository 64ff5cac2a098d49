"""The port's fused Adam+Polyak (``cm3_tpu_torch.ops.fused_opt``)
against the JAX Pallas kernel, which runs in interpret mode on the CPU
as in tests/test_fused_opt.py.  On the CPU the port's wrapper runs the
kernel's plain PyTorch version; the Triton kernel itself is held
against that plain version on the card (tests/test_torch_cuda.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cm3_tpu.algs import common as jcommon
from cm3_tpu.ops import fused_opt as jfused
from cm3_tpu_torch.algs import common
from cm3_tpu_torch.ops import fused_opt
from tests import torch_parity as tp

tp.set_torch_cpu()


def _tree(key):
    k1, k2, k3 = jax.random.split(key, 3)
    return {"a": {"kernel": jax.random.normal(k1, (37, 53)),
                  "bias": jax.random.normal(k2, (53,))},
            "b": jax.random.normal(k3, (129,))}


def _flat(tree):
    return torch.from_numpy(np.array(
        jax.flatten_util.ravel_pytree(tree)[0]))


@pytest.mark.parametrize("lr,tau", [(1e-3, 0.01), (1e-4, 0.05)])
def test_plain_matches_jax_adam_polyak_over_steps(lr, tau):
    """5 steps; tolerances of tests/test_fused_opt.py (p and tgt rtol
    1e-6 atol 1e-7; mu/nu rtol 2e-5 atol 1e-7)."""
    params = _tree(jax.random.PRNGKey(0))
    tgt = jax.tree_util.tree_map(lambda x: x + 0.1, params)
    opt = jcommon.adam(lr).init(params)
    p, t = _flat(params), _flat(tgt)
    st = common.adam_init(p)
    for i in range(5):
        grads = _tree(jax.random.PRNGKey(100 + i))
        params, tgt, opt = jfused.adam_polyak(opt, params, tgt, grads, lr,
                                              tau)
        fused_opt.adam_polyak(st, p, t, _flat(grads), lr, tau)
        np.testing.assert_allclose(p.numpy(), _flat(params).numpy(),
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(t.numpy(), _flat(tgt).numpy(),
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(st.mu.numpy(), np.asarray(opt[0].mu),
                                   rtol=2e-5, atol=1e-7)
        np.testing.assert_allclose(st.nu.numpy(), np.asarray(opt[0].nu),
                                   rtol=2e-5, atol=1e-7)
        assert st.count == int(opt[0].count) == i + 1
    assert fused_opt.adam_polyak.launches == 0   # no kernel on the CPU


def test_soft_update_matches_jax():
    rng = np.random.default_rng(3)
    t, m = (rng.normal(size=300).astype(np.float32) for _ in range(2))
    want = np.asarray(jcommon.soft_update(jnp.asarray(t), jnp.asarray(m),
                                          0.01))
    got = common.soft_update(torch.from_numpy(t.copy()),
                             torch.from_numpy(m), 0.01)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("n", [1, 1000, 8193])
def test_plain_matches_jax_kernel_at_ragged_sizes(n):
    """Sizes off the TPU kernel's 8192-element tile; the JAX kernel at
    a step count of 7; same tolerances."""
    rng = np.random.default_rng(n)
    p, t, g = (rng.normal(size=n).astype(np.float32) for _ in range(3))
    mu = 0.1 * rng.normal(size=n).astype(np.float32)
    nu = 0.01 * rng.random(n).astype(np.float32)
    want = jfused._adam_polyak_flat(*map(jnp.asarray, (p, t, mu, nu, g)),
                                    jnp.int32(7), 1e-3, 0.01)
    got = [torch.from_numpy(x.copy()) for x in (p, t, mu, nu)]
    st = common.AdamState(mu=got[2], nu=got[3], count=7)
    fused_opt.adam_polyak(st, got[0], got[1], torch.from_numpy(g), 1e-3,
                          0.01)
    for w, x in zip(want, got):
        np.testing.assert_allclose(x.numpy(), np.asarray(w), rtol=2e-5,
                                   atol=1e-7)


@pytest.mark.parametrize("count", [0, 1, 4, 99, 1000, 100000])
def test_bias_corrections_match_the_tpu_kernel(count):
    """The host-side corrections equal the kernel's float32 ones
    (``fused_opt.py:86-88``, under jit) to one float32 ulp."""
    c = jax.jit(lambda k: (1.0 - jfused.B1 ** (k + 1).astype(jnp.float32),
                           1.0 - jfused.B2 ** (k + 1).astype(jnp.float32)))(
        jnp.int32(count))
    np.testing.assert_allclose(fused_opt.bias_corrections(count),
                               np.asarray(c, np.float64), rtol=2.0 ** -23,
                               atol=0)


def test_wrapper_checks_its_inputs():
    x = torch.zeros(8)
    st = common.adam_init(x)
    with pytest.raises(ValueError):
        fused_opt.adam_polyak(st, x.double(), x, x, 1e-3, 0.01)
    with pytest.raises(ValueError):
        fused_opt.adam_polyak(st, torch.zeros(16)[::2], x, x, 1e-3, 0.01)
    with pytest.raises(ValueError):
        fused_opt.adam_polyak(st, x, torch.zeros(9), x, 1e-3, 0.01)
    m = torch.zeros(8, device="meta")
    with pytest.raises(RuntimeError):
        fused_opt.adam_polyak(common.adam_init(m), m, m, m, 1e-3, 0.01)
    assert st.count == 0
