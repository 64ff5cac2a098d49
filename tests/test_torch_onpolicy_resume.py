"""Seeds in lockstep, on-policy, resumed: JAX's and the port's
``train_vmapped_seeds(onpolicy=True)`` from the same converted state at
16 episodes per seed, with JAX's draws fed in
(``test_torch_onpolicy_seeds.py``'s set-up and tolerances)."""

import jax
import numpy as np

from cm3_tpu_torch import convert
from cm3_tpu_torch.core import config as tcfg
from tests import torch_parity as tp
from tests.test_torch_onpolicy_run import EPOCHS, RUN, _hold_rows
from tests.test_torch_onpolicy_seeds import S, _lockstep

tp.set_torch_cpu()


def test_lockstep_resume_rebuilds_epsilon():
    """Resumed at 16 episodes per seed: no fill and no warm-up (policy
    chunks from the start), epsilon rebuilt from the (16 - 8) // 4 = 2
    bursts the count implies, then decayed once per burst (a burst
    after each of the two chunks: the row at 24 reads 4 decays); as
    JAX's."""
    jhist, thist, jts, tts, ta = _lockstep(16, 8)
    _hold_rows(jhist, thist, per_seed=True)
    step = tcfg.TrainConfig(**RUN).epsilon_step
    assert [r["episode"].tolist() for r in thist] == [[24] * S]
    np.testing.assert_allclose(thist[0]["epsilon"], 0.5 - 4 * step,
                               rtol=1e-12)
    assert thist[0]["policy_loss"].shape == (S,)
    tp.hold_states(tts, convert.state_from_jax(ta, jax.device_get(jts)),
                   ta.net_names())
    assert tts.step == 2 * EPOCHS
