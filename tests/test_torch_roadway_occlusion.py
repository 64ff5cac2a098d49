"""``test_torch_roadway_extras.py``'s occluded observation and traffic
surfaces against JAX's engine run op by op, with two cars (where the
other car casts shadows)."""

import pytest

from tests import torch_parity as tp
from tests.test_torch_roadway_extras import (  # noqa: F401 (the tests)
    _run, test_extras_match_jax, test_occluded_observation_matches_jax)

tp.set_torch_cpu()


@pytest.fixture(scope="module")
def runs():
    return _run(2)
