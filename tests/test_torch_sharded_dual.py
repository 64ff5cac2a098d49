"""The off-policy chunk with shard-local dual replay (``dual_buffer``
and ``replay_shards`` = D) against the JAX package's: CM3 on roadway's
short road, a slab of 3 transitions, a fill and a training chunk, at
D = 2 for one seed and at D = 4 for three seeds in lockstep; the
memories' fills differ between shards.  The set-up and the checks are
``test_torch_sharded_driver.py``'s."""

import pytest

from tests.test_torch_sharded_driver import (S, case_id, check_fill,
                                             check_training, chunk_runs)

CASES = [("dual", 2, None), ("dual", 4, S)]


@pytest.fixture(scope="module", params=CASES, ids=case_id)
def chunks(request):
    return chunk_runs(*request.param)


def test_fill_chunk_matches_jax(chunks):
    check_fill(chunks)


def test_training_chunk_matches_jax(chunks):
    check_training(chunks)
