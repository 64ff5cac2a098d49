"""The baselines' and QMIX's particle branches against the JAX
package's updates: three updates from the same converted state on the
same four-agent particle batches (and a' noise) for COMA (``QComa``),
IAC (``VParticleLocal``), central-V (``VParticleGlobal``) and QMIX
(``QmixSingleParticle`` and ``QmixMixer``), at narrow widths; then COMA
with S = 3 seeds in lockstep against ``jax.vmap``.  Tolerances as PR
11's: rtol 1e-5 / atol 1e-6 (nu atol 1e-9), QMIX at
``torch_parity.QMIX_TOL``."""

import pytest

from tests import torch_parity as tp

tp.set_torch_cpu()

CASES = {
    "coma": ("baseline", dict(use_Q=True), ("actor", "q")),
    "iac": ("baseline", dict(use_V=True, IAC=True), ("actor", "v")),
    "central_v": ("baseline", dict(use_V=True), ("actor", "v")),
    "qmix": ("qmix", {}, ("qmix",)),
}


@pytest.fixture(scope="module", params=sorted(CASES))
def runs(request):
    kind, opts, nets = CASES[request.param]
    out = tp.particle_case_runs(kind, "stage2_antipodal", opts)
    out["nets"] = nets
    return out


@pytest.mark.parametrize("after", [1, tp.PARTICLE_UPDATES])
def test_updates_match_jax(runs, after):
    """Networks, targets, Adam moments and counts, and every metric."""
    tp.hold_other_updates(runs, after,
                          **(tp.QMIX_TOL if runs["kind"] == "qmix" else {}))


def test_configuration_has_its_networks(runs):
    tp.hold_particle_networks(runs, runs["nets"])


def test_coma_seed_stacked_update_matches_jax_vmap():
    tp.hold_particle_seeds("baseline", dict(use_Q=True))
