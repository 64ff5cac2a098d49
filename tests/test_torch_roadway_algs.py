"""The roadway nets and the algorithms' roadway branches against the JAX
package: the six roadway nets' forwards after ``convert`` and their
leaves against the flax tree (so that the graft and ``convert`` find
them); CM3's updates (stage 1, one car: the Q_global counterfactual
with zero-width others and others' goals; stage 2 with Q_credit on the
optax and the fused paths, with the actor frozen, and the V ablation),
COMA, IAC, central-V and QMIX, three updates each from the same
converted state on the same roadway batches and a' noise; then S = 3
seeds in lockstep against ``jax.vmap``.

The roadway actor, CM3's critics and QMIX's agent net have fixed
widths in both packages, so they run at full width; the baselines'
critics at ``torch_parity.SMALL_ROADWAY_NN``.  Tolerances as the
Checkers and particle updates' (``torch_parity``): rtol 1e-5 / atol 1e-6 (nu atol 1e-9) for the
networks and metrics, 1e-5 for a forward (float32 sums in another
order), QMIX's state at ``torch_parity.QMIX_TOL`` and CM3's with
Q_credit at ``torch_parity.ROADWAY_QC_TOL`` (why: their notes)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cm3_tpu.models import nets as jnets
from cm3_tpu_torch import convert
from cm3_tpu_torch.models import nets as tnets
from tests import torch_parity as tp

tp.set_torch_cpu()

B = 24


def _spec(n):
    return dict(l_action=5, l_goal=4, l_state_one=3, l_obs=3, h_obs=13,
                w_obs=9, c_obs=2, n_agents=n)


def _pair(name, n=2, stage=2):
    """(flax module, torch module, example inputs as numpy) for n cars
    at ``stage``."""
    rng = np.random.default_rng(n + stage)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    a1h = lambda *s: np.eye(5, dtype=np.float32)[rng.integers(0, 5, s)]
    spec = _spec(n)
    grid = f(B, 13, 9, 2)
    if name == "actor":
        return (jnets.ActorRoadway(n_actions=5, stage=stage),
                tnets.ActorRoadway(spec, stage=stage), [grid, f(B, 3),
                                                       f(B, 4)])
    if name == "q_global":
        return (jnets.QGlobalRoadway(stage=stage),
                tnets.QGlobalRoadway(spec, stage=stage),
                [f(B, 3), f(B, 4), a1h(B), f(B, 3 * (n - 1)),
                 a1h(B, n - 1), f(B, 4 * (n - 1))])
    if name == "q_credit":
        return (jnets.QCreditRoadway(stage=stage),
                tnets.QCreditRoadway(spec, stage=stage),
                [f(B, 3), f(B, 4), a1h(B), f(B, 3), f(B, 3 * (n - 1)),
                 f(B, 4 * (n - 1))])
    if name == "v_local":
        kw = dict(n_conv_reduced=8, n_h2=12, stage=stage)
        return (jnets.VRoadwayLocal(**kw), tnets.VRoadwayLocal(spec, **kw),
                [grid, f(B, 3), f(B, 4)])
    if name == "v_global":
        kw = dict(n_h1_2=8, n_h2=12, stage=stage)
        return (jnets.VRoadwayGlobal(**kw), tnets.VRoadwayGlobal(spec, **kw),
                [f(B, 3), f(B, 4), f(B, 3 * (n - 1)), f(B, 4 * (n - 1))])
    return (jnets.QmixSingleRoadway(n_actions=5),
            tnets.QmixSingleRoadway(spec), [grid, f(B, 3), f(B, 4)])


NET_CASES = ([(name, 1, 1) for name in ("actor", "q_global", "v_local",
                                        "v_global")]
             + [(name, 2, 2) for name in ("actor", "q_global", "q_credit",
                                          "v_local", "v_global",
                                          "qmix_agent")])


def _perturbed(params):
    return jax.tree_util.tree_map(
        lambda x: x + 0.01 * jnp.arange(x.size, dtype=x.dtype).reshape(
            x.shape) / x.size, params)


@pytest.mark.parametrize("name,n,stage", NET_CASES)
def test_forward_matches_flax_after_convert(name, n, stage):
    jmod, tmod, inputs = _pair(name, n, stage)
    params = _perturbed(jmod.init(jax.random.PRNGKey(0),
                                  *map(jnp.asarray, inputs)))
    tmod = tnets.flatten_parameters(tmod)
    convert.load_params(tmod, jax.device_get(params))
    want = np.asarray(jmod.apply(params, *map(jnp.asarray, inputs)))
    with torch.no_grad():
        got = tmod(*map(torch.from_numpy, inputs)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("scheme", ["ref", "tf1"])
@pytest.mark.parametrize("name,n,stage", NET_CASES)
def test_leaves_follow_the_flax_tree(name, n, stage, scheme):
    """The port's parameters in flat order are the flax leaves in
    ``ravel_pytree`` order (``W_concated_h2``, the conv branch's
    ``stage2``/``conv_branch`` leaves among them), and the port's
    initializer knows every leaf."""
    jmod, tmod, inputs = _pair(name, n, stage)
    with jnets.init_scheme(scheme):
        params = jmod.init(jax.random.PRNGKey(1), *map(jnp.asarray, inputs))
    leaves = jax.tree_util.tree_flatten_with_path(params["params"])[0]
    got = [(tnets.flax_path(k), convert._flax_shape(tnets.flax_path(k),
                                                    tuple(p.shape)))
           for k, p in tnets.ordered_parameters(tmod)]
    assert got == [(tuple(k.key for k in path), leaf.shape)
                   for path, leaf in leaves]
    tnets.init_parameters(tmod, torch.Generator().manual_seed(0), scheme)


# --------------------------------------------------------------------- #
# updates
# --------------------------------------------------------------------- #

CASES = {
    "cm3_stage1": ("cm3", 1, {}, ("actor", "qg")),
    "cm3_stage1_fused": ("cm3", 1, dict(fused_opt=True), ("actor", "qg")),
    "cm3": ("cm3", 2, {}, ("actor", "qg", "qc")),
    "cm3_fused_frozen": ("cm3", 2, dict(fused_opt=True,
                                        actor_freeze_updates=2),
                         ("actor", "qg", "qc")),
    "cm3_V": ("cm3", 2, dict(use_Q_credit=False, use_V=True),
              ("actor", "qg", "v")),
    "coma": ("baseline", 2, dict(use_Q=True), ("actor", "q")),
    "iac": ("baseline", 2, dict(use_V=True, IAC=True), ("actor", "v")),
    "central_v": ("baseline", 2, dict(use_V=True), ("actor", "v")),
    "qmix": ("qmix", 2, {}, ("qmix",)),
}


@pytest.fixture(scope="module", params=sorted(CASES))
def runs(request):
    kind, stage, opts, nets = CASES[request.param]
    out = tp.roadway_case_runs(kind, stage, opts)
    out["nets"] = nets
    return out


@pytest.mark.parametrize("after", [1, tp.ROADWAY_UPDATES])
def test_updates_match_jax(runs, after):
    """Networks, targets, Adam moments and counts, and every metric."""
    tol = (tp.QMIX_TOL if runs["kind"] == "qmix" else
           tp.ROADWAY_QC_TOL if "qc" in runs["nets"] else {})
    tp.hold_other_updates(runs, after, **tol)


def test_configuration_has_its_networks(runs):
    """The state has the networks its configuration asks for, and every
    one moved (the frozen actor too, once its freeze is over)."""
    tp.hold_particle_networks(runs, runs["nets"])


def test_seed_stacked_update_matches_jax_vmap():
    """CM3 with Q_credit, S = 3 (the baselines' seed axis is the same
    code, held on Checkers and particle)."""
    je, _ = tp.roadway_envs(2)
    ja, ta = tp.roadway_algs("cm3", je.spec(), n_seeds=3)
    tp.hold_seeds(ja, ta, lambda rng: tp.roadway_batch(je, tp.ROADWAY_B,
                                                       rng))
