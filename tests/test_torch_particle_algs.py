"""CM3's particle branches against the JAX package's update: three
updates from the same converted state on the same particle batches and
a' noise, at narrow widths: stage 1 (one agent: the Q_global
counterfactual with zero-width others), stage 2 with Q_credit for four
agents (antipodal) and for two (merge), on the optax and the fused
paths, and the V ablation (``use_V``, no Q_credit); then S = 3 seeds in
lockstep against ``jax.vmap`` of JAX's update.

Four agents matter: the "others" inputs are ordered by index skipping
self (``common.others_concat``/``others_stack``), and a permutation
error would pass at two.  Tolerances as PR 11's (``torch_parity``):
rtol 1e-5 / atol 1e-6 (nu atol 1e-9)."""

import pytest

from tests import torch_parity as tp

tp.set_torch_cpu()

CASES = {
    "stage1": ("stage1", {}, ("actor", "qg")),
    "stage1_fused": ("stage1", dict(fused_opt=True), ("actor", "qg")),
    "antipodal": ("stage2_antipodal", {}, ("actor", "qg", "qc")),
    "antipodal_fused": ("stage2_antipodal", dict(fused_opt=True),
                        ("actor", "qg", "qc")),
    "merge": ("stage2_merge", {}, ("actor", "qg", "qc")),
    "V": ("stage2_antipodal", dict(use_Q_credit=False, use_V=True),
          ("actor", "qg", "v")),
}


@pytest.fixture(scope="module", params=sorted(CASES))
def runs(request):
    scenario, opts, nets = CASES[request.param]
    out = tp.particle_case_runs("cm3", scenario, opts)
    out["nets"] = nets
    return out


@pytest.mark.parametrize("after", [1, tp.PARTICLE_UPDATES])
def test_cm3_updates_match_jax(runs, after):
    """Networks, targets, Adam moments and counts, and every metric."""
    tp.hold_other_updates(runs, after)


def test_cm3_configuration_has_its_networks(runs):
    """Stage 1 has no Q_credit and no V; stage 2 Q_credit unless the V
    ablation; every network moved."""
    tp.hold_particle_networks(runs, runs["nets"])


def test_cm3_seed_stacked_update_matches_jax_vmap():
    tp.hold_particle_seeds("cm3", {})
