"""Seeds in lockstep for the baselines and QMIX: one update of COMA and
of QMIX with S = 3 (each seed its own batch, epsilon and a' noise) in
the port's seed stacks against ``jax.vmap`` of JAX's update, from the
same converted state."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cm3_tpu_torch import convert
from tests import torch_parity as tp

tp.set_torch_cpu()

S, B = 3, 16
EPS = np.array([0.1, 0.2, 0.3], np.float32)


@pytest.mark.parametrize("kind,opts", [("baseline", dict(use_Q=True)),
                                       ("qmix", dict())],
                         ids=["coma", "qmix"])
def test_seed_stacked_update_matches_jax_vmap(kind, opts):
    """Networks, targets, Adam moments and the per-seed metrics at
    rtol 1e-5 / atol 1e-6 (nu atol 1e-9; QMIX at ``tp.QMIX_TOL``), and
    the seeds apart from each other."""
    je, _ = tp.envs()
    ja, ta = tp.other_algs(kind, je.spec(), n_seeds=S, **opts)
    rng = np.random.default_rng(3)
    batches = [jax.device_get(tp.replay_batch(je, B, rng)) for _ in range(S)]
    batch = jax.tree_util.tree_map(lambda *x: np.stack(x), *batches)
    jts = jax.vmap(ja.init_state)(
        jax.random.split(jax.random.PRNGKey(1), S), batch["obs"],
        batch["state"], batch["goals"])
    tts = convert.state_from_jax(ta, jax.device_get(jts))
    keys = jax.random.split(jax.random.PRNGKey(9), S)
    jts, jm = jax.jit(jax.vmap(ja.update))(jts, batch, jnp.asarray(EPS),
                                           keys)
    noise = None if kind == "qmix" else torch.from_numpy(np.stack(
        [np.asarray(jax.random.gumbel(k, (B, 2, 5))) for k in keys]))
    tts, tm = ta.update(tts, tp.to_torch(batch), torch.from_numpy(EPS),
                        noise)
    want = convert.state_from_jax(ta, jax.device_get(jts))
    tp.hold_states(tts, want, ta.net_names(),
                   **(tp.QMIX_TOL if kind == "qmix" else {}))
    assert tts.step == want.step == 1
    assert set(tm) == set(jm)
    for k, v in tm.items():
        assert v.shape == (S,)
        np.testing.assert_allclose(v.numpy(), np.asarray(jm[k]), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    name = ta.net_names()[0]
    flat = getattr(tts, name).flat
    assert not torch.equal(flat[0], flat[1])
