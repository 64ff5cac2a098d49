"""CM3's opt-in corrections in the port against the JAX update on them:
one, two and three updates from the same converted state on the same
batches and a' noise, for ``adv_norm``, ``pg_is_clip`` (with a stored
``bp``), ``pg_ent_coef``, and stage 1 (one agent) with all three; then
every option at once for seeds in lockstep against one-seed updates, on
both optimizer paths.  The critics' options are in
``test_torch_cm3_options_critics.py``, the actor freeze in
``test_torch_cm3_options_freeze.py`` (apart, so that the test workers
run the files' JAX compilations side by side)."""

import jax
import numpy as np
import pytest
import torch

from cm3_tpu_torch.core import prng
from cm3_tpu_torch.core.tree import tree_map
from cm3_tpu_torch.train import checkpoint
from tests import torch_parity as tp

tp.set_torch_cpu()

# (n_agents, AlgConfig options), on the optax path
CASES = {
    "adv_norm": (2, dict(adv_norm=True)),
    # c = 2: some weights are clipped, others are not
    "pg_is_clip": (2, dict(pg_is_clip=2.0)),
    "pg_ent_coef": (2, dict(pg_ent_coef=0.05)),
    "stage1_corrections": (1, dict(pg_is_clip=2.0, pg_ent_coef=0.05,
                                   adv_norm=True)),
}


@pytest.fixture(scope="module", params=sorted(CASES))
def runs(request):
    return tp.option_runs(request.param, *CASES[request.param])


@pytest.mark.parametrize("after", [1, 2, tp.OPTION_UPDATES])
def test_option_updates_match_jax(runs, after):
    """As ``torch_parity.hold_option_updates`` holds them."""
    tp.hold_option_updates(runs, after)


def test_options_take_effect(runs):
    """As ``torch_parity.hold_options_take_effect`` holds it."""
    tp.hold_options_take_effect(runs)


# --------------------------------------------------------------------- #
# seeds in lockstep
# --------------------------------------------------------------------- #

SEED_CASES = {
    "optax": dict(use_Q_credit=False, use_V=True, adv_norm=True,
                  pg_is_clip=2.0, pg_ent_coef=0.05,
                  actor_freeze_updates=1),
    "fused": dict(use_Q_credit=False, use_V=True, adv_norm=True,
                  pg_is_clip=2.0, pg_ent_coef=0.05,
                  actor_freeze_updates=1, fused_opt=True),
}


@pytest.mark.parametrize("case", sorted(SEED_CASES))
def test_seed_batched_options_equal_one_seed_updates(case):
    """Two seeds in lockstep with every option on (V without Q_credit,
    the corrections, a freeze of one update) against each seed's own
    one-seed updates, three updates on the seeds' own batches and
    noise.  The seed axis sums in other orders (grouped convolutions,
    batched products): the metrics as ``torch_parity.metric_tol`` says,
    the states as ``test_torch_multiseed.py`` holds them after Adam
    steps, 99.9% of the floats within 1e-7 and every float within
    3e-6."""
    opts = SEED_CASES[case]
    je, _ = tp.envs()
    _, ta = tp.algs(je.spec(), **opts)
    ts2 = ta.for_seeds(2)
    rng = np.random.default_rng(1)
    singles = [ta.init_state(prng.root_key(7 + s)) for s in range(2)]
    stacked = checkpoint.stack_states(
        ts2, [tp.copy_state(ta, s) for s in singles])
    for u in range(tp.OPTION_UPDATES):
        batches = [tp.to_torch(jax.device_get(
            tp.option_batch(je, rng, True))) for _ in range(2)]
        gumbels = [torch.from_numpy(rng.gumbel(
            size=(tp.OPTION_B, 2, 5)).astype(np.float32)) for _ in range(2)]
        ms = [ta.update(singles[s], batches[s], 0.2, gumbels[s])[1]
              for s in range(2)]
        stacked, m2 = ts2.update(
            stacked, tree_map(lambda *x: torch.stack(x), *batches),
            torch.tensor([0.2, 0.2]), torch.stack(gumbels))
        assert set(m2) == set(ms[0])
        for k in m2:
            np.testing.assert_allclose(
                m2[k].numpy(), [float(m[k]) for m in ms], err_msg=k,
                **tp.metric_tol(ta.cfg, k))
    for s in range(2):
        got = checkpoint.seed_state(ta, stacked, s)
        for name in ta.net_names():
            pairs = [(getattr(got, name + x).flat,
                      getattr(singles[s], name + x).flat)
                     for x in ("", "_tgt")]
            o, w = getattr(got, "opt_" + name), getattr(singles[s],
                                                        "opt_" + name)
            assert o.count == w.count
            pairs += [(o.mu, w.mu), (o.nu, w.nu)]
            for g, want in pairs:
                diff = (g - want).abs()
                assert float((diff <= 1e-7).float().mean()) >= 0.999, name
                assert float(diff.max()) <= 3e-6, name
        assert got.step == singles[s].step == tp.OPTION_UPDATES


