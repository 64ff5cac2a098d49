"""The port's replay ring against ``cm3_tpu.replay.buffer``: adds that
wrap around the ring, and samples at fed indices."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cm3_tpu.replay import buffer as jreplay
from cm3_tpu_torch.core.tree import tree_map
from cm3_tpu_torch.replay import buffer as treplay
from tests import torch_parity as tp

tp.set_torch_cpu()


def _rows(rng, e):
    return {"x": rng.normal(size=(e, 3)).astype(np.float32),
            "o": {"a": rng.integers(0, 5, (e, 2)).astype(np.int32)},
            "d": rng.random(e) < 0.5}


@pytest.mark.parametrize("cap,e", [(10, 3), (12, 4), (7, 7)])
def test_add_and_sample_match_jax(cap, e):
    rng = np.random.default_rng(cap)
    first = _rows(rng, e)
    jbuf = jreplay.init(jax.tree_util.tree_map(lambda x: x[0], first), cap)
    tbuf = treplay.init(tree_map(lambda x: x[0], tp.to_torch(first)), cap)
    for i in range(5):
        rows = _rows(rng, e)
        jbuf = jreplay.add_batch(jbuf, jax.tree_util.tree_map(jnp.asarray,
                                                              rows))
        tbuf = treplay.add_batch(tbuf, tp.to_torch(rows))
        assert (tbuf.insert, tbuf.size) == (int(jbuf.insert), int(jbuf.size))
        want = tp.to_torch(jax.device_get(jbuf.data))
        tree_map(lambda a, b: np.testing.assert_array_equal(a.numpy(),
                                                            b.numpy()),
                 tbuf.data, want)
    key = jax.random.PRNGKey(cap)
    jb = jreplay.sample(jbuf, key, 6)
    idx = jax.random.randint(key, (6,), 0, jnp.maximum(jbuf.size, 1))
    tb = treplay.sample(tbuf, torch.from_numpy(np.asarray(idx, np.int64)))
    tree_map(lambda a, b: np.testing.assert_array_equal(a.numpy(), b.numpy()),
             tb, tp.to_torch(jax.device_get(jb)))


def test_add_larger_than_ring_raises():
    buf = treplay.init({"x": torch.zeros(2)}, 4)
    with pytest.raises(ValueError):
        treplay.add_batch(buf, {"x": torch.zeros(5, 2)})
