"""Particle through the port's runner against the JAX runner, on the CPU:
``build`` of the paper's particle cells (``scripts/reproduce_paper.py:
160-166, 453-475, 558-562``) against JAX's (configs, widths from
``master.json``'s "nn", the scenario from ``particle_config``, the
on-policy choice); the stage-1 -> stage-2 graft on particle states
against JAX's ``stage2_init_cm3`` and ``stage2_init_baseline`` bit for
bit, one seed and S = 3.  The curriculum through both runners is in
``test_torch_onpolicy_curriculum.py``."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from cm3_tpu.train import checkpoint as jckpt
from cm3_tpu.train import runner as jrunner
from cm3_tpu_torch import convert
from cm3_tpu_torch.core import config as tcfg
from cm3_tpu_torch.train import checkpoint, runner
from cm3_tpu_torch.train.offpolicy import OffPolicyDriver
from cm3_tpu_torch.train.onpolicy import OnPolicyDriver
from tests import torch_parity as tp

tp.set_torch_cpu()

P1 = dict(experiment="particle", particle_config="stage1", stage=1,
          n_envs=16, dir_name="pt_s1", period=100, N_eval=10)
P2 = dict(P1, particle_config="stage2_antipodal", stage=2,
          dir_name="pt_s2", dir_restore="pt_s1", train_from_nothing=0)
CELLS = {
    "particle_s1": P1,
    "particle_s2": P2,
    "particle_s2_V": dict(P2, dir_name="pt_s2V", use_Q_credit=0, use_V=1),
    "particle_coma": dict(P2, alg_name="coma", dir_name="pt_coma",
                          train_from_nothing=1),
    "particle_iac": dict(P2, alg_name="iac", train_from_nothing=1),
    "particle_qmix": dict(P2, alg_name="qmix", dir_name="pt_qmix",
                          train_from_nothing=1),
    "merge_by_file_name": dict(P2, fused_opt=1,
                               particle_config=
                               "config_particle_stage2_merge.json"),
    "default_scenario": dict(experiment="particle", stage=1),
}


def _master(base, **over):
    m = tcfg.load_json("master.json")
    m.update(base)
    m.update(over)
    return m


@pytest.mark.parametrize("name", sorted(CELLS))
def test_build_matches_jax(name):
    """The same AlgConfig, TrainConfig, NNConfig and env config values as
    JAX's ``build``, the same spec and the same driver regime (on-policy
    for particle CM3, COMA and IAC; off-policy for QMIX)."""
    m = _master(CELLS[name])
    jd, ja, jh, jtc = jrunner.build(m)
    td, ta, th, ttc = runner.build(m, device="cpu")
    jnn = jrunner._nn_config(m, "particle", m["stage"])
    for got, want in ((ta.cfg, ja.cfg), (ttc, jtc), (ta.nn_cfg, jnn),
                      (th.env.cfg, jh.env.cfg)):
        for f in dataclasses.fields(got):
            assert getattr(got, f.name) == getattr(want, f.name), f.name
    assert ta.spec == dict(ja.spec, n_agents=ja.n_agents)
    onpolicy = type(jd).__name__ == "OnPolicyDriver"
    assert isinstance(td, OnPolicyDriver) == onpolicy
    assert onpolicy == (m.get("alg_name", "cm3") != "qmix")
    assert isinstance(td, OffPolicyDriver)
    assert th.env.device == torch.device("cpu")


def _jax_state(kind, scenario, key, n_seeds=None, **opts):
    je, _ = tp.particle_envs(scenario, prob_random=1.0)
    ja, ta = tp.particle_algs(kind, je.spec(), n_seeds=n_seeds, **opts)
    b = jax.device_get(tp.particle_batch(je, 4, np.random.default_rng(0)))
    init = jax.jit(lambda k: ja.init_state(k, b["obs"], b["state"],
                                           b["goals"]))
    if n_seeds is None:
        return jax.device_get(init(jax.random.PRNGKey(key))), ta
    keys = jax.random.split(jax.random.PRNGKey(key), n_seeds)
    return jax.device_get(jax.vmap(init)(keys)), ta


@pytest.mark.parametrize("n_seeds", [None, 3])
@pytest.mark.parametrize("kind,opts", [
    ("cm3", {}), ("cm3", dict(use_Q_credit=False, use_V=True)),
    ("baseline", dict(use_V=True, IAC=True))], ids=["cm3", "cm3_V", "iac"])
def test_stage2_graft_equals_jax(kind, opts, n_seeds):
    """Stage 1 (one agent: ``others`` of width 4 in the observations,
    zero-width in the critic's counterfactual) grafted into stage 2 (four
    agents): the port's graft on converted states equals JAX's graft
    converted, bit for bit; the ``stage2`` leaves stay stage 2's own,
    the shared ones are stage 1's."""
    j1, t1 = _jax_state(kind, "stage1", 11, n_seeds, **opts)
    j2, t2 = _jax_state(kind, "stage2_antipodal", 22, n_seeds, **opts)
    s1 = convert.state_from_jax(t1, j1)
    fresh = convert.state_from_jax(t2, j2)
    if kind == "cm3":
        want = jckpt.stage2_init_cm3(j2, j1.actor, j1.qg)
        got = checkpoint.stage2_init_cm3(convert.state_from_jax(t2, j2),
                                         s1.actor, s1.qg)
    else:
        want = jckpt.stage2_init_baseline(j2, j1.actor, j1.v)
        got = checkpoint.stage2_init_baseline(
            convert.state_from_jax(t2, j2), s1.actor, s1.v)
    want = convert.state_from_jax(t2, want)
    for name in t2.net_names():
        for x in ("", "_tgt"):
            assert torch.equal(getattr(got, name + x).flat,
                               getattr(want, name + x).flat), name + x
    views1 = checkpoint.named_views(s1.actor)
    for name, v in checkpoint.named_views(got.actor).items():
        if "stage2" in name.split("."):
            assert torch.equal(v, checkpoint.named_views(fresh.actor)[name])
        else:
            assert torch.equal(v, views1[name]), name
