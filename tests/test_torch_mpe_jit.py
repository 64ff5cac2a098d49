"""The port's MPE suite against JAX's compiled engine
(``jax.jit(jax.vmap(MPEEnv.step))`` and ``step_multihead``): for each
of the nine scenarios, one port step from each of JAX's compiled states
of ``test_torch_mpe.py``'s trajectory (11 steps alternating the index
and the multi-head path, 6 instances) against JAX's compiled step.
Compiled XLA contracts ``a*b + c`` into fused multiply-adds, so the
floats are held at ``JIT_TOL`` (measured: at most 4.8e-7 apart, 2.0e-5
of a value's size where it is above 1e-3; 1,923 of 52,206 floats
differ), the step counts, goals and done flags exactly."""

import pytest

from cm3_tpu_torch.envs import mpe as tmpe
from tests import torch_parity as tp
from tests.test_torch_mpe import (MAX_STEPS, NAMES, _hold, _port_record,
                                  _port_step, _state_from, jax_trajectory)

tp.set_torch_cpu()

JIT_TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", NAMES)
def test_jitted_step_within_tolerance(name):
    traj = jax_trajectory(name, jitted=True)
    te = tmpe.MPEEnv(name, max_steps=MAX_STEPS, device="cpu")
    recs = traj["recs"]
    for t, a in enumerate(traj["acts"]):
        s, o = _port_step(te, _state_from(recs[t]), a)
        _hold(_port_record(s, o), recs[t + 1], f"{name} t={t}", **JIT_TOL)
