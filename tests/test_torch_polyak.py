"""The port's Polyak soft update (plain version on the CPU) against
``cm3_tpu.ops.polyak.polyak_update`` (Pallas, interpret mode), at the
sizes and tau values of ``tests/test_ops.py``.  The CUDA C++ kernel is
held against the plain version on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``) and, built for the host, on the CPU
(``scripts/torch_host_rehearsal.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

import torch_parity
from cm3_tpu.ops.polyak import polyak_update as jax_polyak
from cm3_tpu_torch.ops import polyak


@pytest.fixture(autouse=True)
def _cpu():
    torch_parity.set_torch_cpu()


def _trees(seed):
    rng = np.random.default_rng(seed)
    mk = lambda *s: rng.standard_normal(s).astype(np.float32)
    return ({"w": mk(33, 17), "b": mk(9), "nest": {"x": mk(5, 3)}},
            {"w": mk(33, 17), "b": mk(9), "nest": {"x": mk(5, 3)}})


@pytest.mark.parametrize("tau", [0.0, 0.01, 0.5, 1.0])
def test_plain_matches_jax(tau):
    """The tree of ``test_polyak_matches_tree_map`` flattened in
    ``ravel_pytree`` order, as the port's networks keep theirs:
    rtol 1e-6, atol 1e-7 (both round tau*m, (1-tau)*t and their sum
    in float32; XLA may contract the sum into a fused multiply-add)."""
    t_tree, m_tree = _trees(int(tau * 100))
    want, _ = ravel_pytree(jax_polyak(jax.tree_util.tree_map(
        jnp.asarray, t_tree), jax.tree_util.tree_map(jnp.asarray, m_tree),
        tau))
    t_flat = torch.from_numpy(np.asarray(ravel_pytree(t_tree)[0]).copy())
    m_flat = torch.from_numpy(np.asarray(ravel_pytree(m_tree)[0]).copy())
    out = polyak.polyak_update(t_flat, m_flat, tau)
    assert out is t_flat                       # in place
    torch.testing.assert_close(out, torch.from_numpy(np.array(want)),
                               rtol=1e-6, atol=1e-7)


def test_tau_extremes_and_odd_size():
    """``test_polyak_tau_extremes`` and ``test_polyak_odd_sizes``:
    tau 0 keeps the target, tau 1 copies the main, and 1001 elements
    (no multiple of any block) at tau 0.5 halve an arange."""
    for tau, want in ((0.0, 1.0), (1.0, 7.0)):
        t = torch.ones(16)
        polyak.polyak_update(t, torch.full((16,), 7.0), tau)
        assert torch.equal(t, torch.full((16,), want))
    t = torch.arange(1001, dtype=torch.float32)
    polyak.polyak_update(t, torch.zeros(1001), 0.5)
    j = jax_polyak({"a": jnp.arange(1001, dtype=jnp.float32)},
                   {"a": jnp.zeros(1001)}, 0.5)["a"]
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    np.testing.assert_array_equal(
        t.numpy(), np.arange(1001, dtype=np.float32) * 0.5)


def test_checks_and_no_fallback():
    with pytest.raises(ValueError):
        polyak.polyak_update(torch.zeros(4), torch.zeros(5), 0.1)
    with pytest.raises(ValueError):
        polyak.polyak_update(torch.zeros(4, dtype=torch.float64),
                             torch.zeros(4, dtype=torch.float64), 0.1)
    meta = lambda: torch.zeros(8, device="meta")
    before = polyak.polyak_update.launches
    with pytest.raises(RuntimeError, match="no kernel"):
        polyak.polyak_update(meta(), meta(), 0.1)
    assert polyak.polyak_update.launches == before


@pytest.mark.parametrize("tau", [0.0, 0.01, 1.0])
def test_plain_rounds_as_the_kernel(tau):
    """The plain version rounds tau*m, (1-tau)*t (1 - tau rounded once
    from the double) and their sum once each in float32, as the kernel
    does: equal to numpy's float32 arithmetic bit for bit, on a view at
    an offset of 3 floats too."""
    rng = np.random.default_rng(int(tau * 100))
    t = rng.standard_normal(1003).astype(np.float32)
    m = rng.standard_normal(1003).astype(np.float32)
    want = np.float32(tau) * m + np.float32(1.0 - tau) * t
    for off in (0, 3):
        buf = torch.zeros(1003 + off)
        buf[off:] = torch.from_numpy(t)
        got = polyak.polyak_update(buf[off:], torch.from_numpy(m), tau)
        np.testing.assert_array_equal(got.numpy(), want)
