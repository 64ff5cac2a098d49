"""Actions stay in [0, A).  ``common.one_hot`` is a compare against
``arange`` (usable inside ``torch.func.vmap``), which has no range check:
an action outside [0, A) would become an all-zero row.  These tests hold
that nothing the port feeds it is outside: ``sample_actions`` on edge
inputs, and the actions a fill and a training chunk write into replay
(``a``, ``a_prev``), for one seed and for seeds in lockstep, stage 2 and
stage 1."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from cm3_tpu_torch.algs import common
from cm3_tpu_torch.algs.cm3 import CM3
from cm3_tpu_torch.core import config, prng
from cm3_tpu_torch.envs.checkers import Checkers
from cm3_tpu_torch.train.experiments import make_hooks
from cm3_tpu_torch.train.offpolicy import OffPolicyDriver, init_rollout

torch.set_num_threads(1)

A = 5
SMALL = config.NNConfig(Q_conv_f=2, Q_n_h1_1=8, Q_n_h1_2=4, Q_n_h2=8,
                        A_conv_f=2, A_n_h1=8, A_n_h2=8)


def _probs(case, rng, shape):
    if case == "random":
        p = rng.random(shape)
        return p / p.sum(-1, keepdims=True)
    if case == "one_hot":
        return np.eye(A)[rng.integers(0, A, shape[:-1])]
    if case == "zeros":
        return np.zeros(shape)
    if case == "last_only":
        p = np.zeros(shape)
        p[..., -1] = 1.0
        return p
    raise ValueError(case)


@pytest.mark.parametrize("case", ["random", "one_hot", "zeros",
                                  "last_only"])
@pytest.mark.parametrize("epsilon", [0.0, 0.3, 1.0])
def test_sample_actions_in_range(case, epsilon):
    """Eps-mixed probabilities with zeros, a single certain action or
    none at all, under large Gumbel noise of either sign: every sample
    is in [0, A), and its one-hot is ``F.one_hot``'s."""
    rng = np.random.default_rng(0)
    shape = (64, 3, A)
    probs = common.epsilon_probs(
        torch.from_numpy(_probs(case, rng, shape)).float(), epsilon, A)
    gumbel = torch.from_numpy(rng.gumbel(size=shape).astype(np.float32))
    for g in (gumbel, 1e6 * gumbel, -1e6 * gumbel):
        a = common.sample_actions(probs, g)
        assert a.shape == shape[:-1]
        assert int(a.min()) >= 0 and int(a.max()) < A
        assert torch.equal(common.one_hot(a, A), F.one_hot(a, A).float())


def test_one_hot_outside_range_is_a_zero_row():
    """What the range tests guard against: no error, a zero row."""
    x = torch.tensor([-1, 0, A - 1, A])
    out = common.one_hot(x, A)
    assert torch.equal(out[1:3], F.one_hot(x[1:3], A).float())
    assert torch.equal(out[[0, 3]], torch.zeros(2, A))


@pytest.mark.parametrize("n_agents,n_seeds", [(2, None), (2, 3), (1, None),
                                              (1, 3)])
def test_chunk_actions_in_range(n_agents, n_seeds):
    """A random fill chunk and a policy training chunk: every replay row
    written holds actions in [0, A) (``a`` and ``a_prev``)."""
    env = Checkers(config.checkers_env_config(n_agents, max_steps=6),
                   device="cpu")
    alg = CM3("checkers", env.spec(),
              config.AlgConfig(n_agents=n_agents, stage=min(n_agents, 2)),
              SMALL, device="cpu", n_seeds=n_seeds)
    cfg = config.TrainConfig(n_envs=4, batch_size=8, buffer_size=256,
                             steps_per_train=6, updates_per_chunk=2)
    driver = OffPolicyDriver(make_hooks("checkers", env), alg, cfg)
    draws = prng.GeneratorDraws(prng.generator(3, "cpu"))
    rs = init_rollout(driver.hooks, cfg.n_envs, draws, n_seeds=n_seeds)
    keys = [prng.root_key(1 + i) for i in range(n_seeds or 1)]
    ts = alg.init_state(keys[0] if n_seeds is None else keys)
    buf = driver._replay_init(driver.example_transition(rs))
    for train, rand in ((False, True), (True, False)):
        ts, buf, rs, _ = driver._chunk(ts, buf, rs, 0.2, draws, train, rand)
    n_act = alg.n_actions
    rows = slice(0, buf.size)
    for key in ("a", "a_prev"):
        a = buf.data[key]
        a = a[rows] if n_seeds is None else a[:, rows]
        assert a.numel() and int(a.min()) >= 0 and int(a.max()) < n_act, key
