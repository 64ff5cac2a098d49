"""The port's MPE suite against ``cm3_tpu.envs.mpe`` on the four
scenarios whose entities collide (contact forces, collision rewards):
``simple_push``, ``simple_spread``, ``simple_tag`` and
``simple_world_comm``; the reset from JAX's draws and 11 steps
alternating the index and the multi-head path, op by op, as
``test_torch_mpe.py`` holds the others, with its tolerances: to the
bit with XLA's exp and log1p and flushed subnormals, at ``OWN_TOL``
with PyTorch's own."""

import pytest

from tests import torch_parity as tp
from tests.test_torch_mpe import (CONTACT, hold_bit_for_bit,
                                  hold_own_functions, jax_trajectory,
                                  xla_rounding)  # noqa: F401

tp.set_torch_cpu()


@pytest.fixture(scope="module", params=CONTACT)
def traj(request):
    return jax_trajectory(request.param)


def test_op_by_op_bit_for_bit(traj, xla_rounding):  # noqa: F811
    hold_bit_for_bit(traj)


def test_own_functions_within_tolerance(traj):
    hold_own_functions(traj)
