"""Shared set-up of the parity tests between ``cm3_tpu`` (JAX, the
reference) and ``cm3_tpu_torch`` (the port): one small Checkers stage-2
CM3 configuration built in both packages, and the JAX draws of one
``OffPolicyDriver._chunk`` recomputed from its key so that they can be
fed to the port."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from cm3_tpu.algs.cm3 import CM3 as JaxCM3
from cm3_tpu.core import config as jcfg
from cm3_tpu.envs.checkers import Checkers as JaxCheckers
from cm3_tpu_torch.algs.cm3 import CM3 as TorchCM3
from cm3_tpu_torch.core import config as tcfg
from cm3_tpu_torch.envs.checkers import Checkers as TorchCheckers

# narrow widths; the layer structure is the full one
SMALL_NN = dict(Q_conv_f=2, Q_conv_k=(3, 5), Q_n_h1_1=16, Q_n_h1_2=8,
                Q_n_h2=16, A_conv_f=2, A_conv_k=(3, 3), A_n_h1=16, A_n_h2=12)


def set_torch_cpu():
    torch.set_num_threads(1)


def envs(max_steps=50):
    j = JaxCheckers(jcfg.CheckersEnvConfig(n_agents=2, max_steps=max_steps))
    t = TorchCheckers(tcfg.CheckersEnvConfig(n_agents=2, max_steps=max_steps),
                      device="cpu")
    return j, t


def algs(spec, **alg):
    kw = dict(n_agents=2, stage=2, fused_opt=True, **alg)
    j = JaxCM3("checkers", spec, jcfg.AlgConfig(**kw),
               jcfg.NNConfig(**SMALL_NN))
    t = TorchCM3("checkers", spec, tcfg.AlgConfig(**kw),
                 tcfg.NNConfig(**SMALL_NN), device="cpu")
    return j, t


def to_torch(tree):
    """JAX pytree of arrays -> the same dict of CPU tensors (ints as
    int64, the port's index type)."""
    def conv(x):
        x = np.array(x)
        if np.issubdtype(x.dtype, np.integer):
            x = x.astype(np.int64)
        return torch.from_numpy(x)
    return jax.tree_util.tree_map(conv, tree)


def chunk_draws(key, n_envs, n_agents, n_actions, steps, random_actions,
                n_updates=0, batch=0, sizes=()):
    """The draws ``OffPolicyDriver._chunk`` makes from ``key``
    (offpolicy.py:242-248,369-371), as (randints, gumbels) in the order
    the port's driver asks for them.  ``sizes`` is the replay fill seen
    by each update (jax.random.randint's bound)."""
    randints, gumbels = [], []
    for k in jax.random.split(key, steps):
        k_act, k_rand, _ = jax.random.split(k, 3)
        if random_actions:
            randints.append(np.asarray(jax.random.randint(
                k_rand, (n_envs, n_agents), 0, n_actions)))
        else:
            gumbels.append(np.asarray(jax.random.gumbel(
                k_act, (n_envs, n_agents, n_actions))))
    ks = jax.random.split(jax.random.fold_in(key, 7), n_updates)
    for k, size in zip(ks, sizes):
        k_sample, k_update = jax.random.split(k)
        randints.append(np.asarray(jax.random.randint(
            k_sample, (batch,), 0, jnp.maximum(jnp.int32(size), 1))))
        gumbels.append(np.asarray(jax.random.gumbel(
            k_update, (batch, n_agents, n_actions))))
    return randints, gumbels
