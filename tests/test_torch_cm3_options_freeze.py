"""``actor_freeze_updates`` in the port against the JAX update: the
actor frozen for the first two of three updates (before, at and after
the window's end) on the optax path and on the fused path (the Polyak
kernel's plain version moving the actor target while frozen, with
Q_credit or with V beside Q_global), and a freeze of one update before
the actor's lr anneal; then the fused path's calls: at every update the
actor's fused launch and the Polyak call over its target, each under a
device predicate, the first writing where the actor is live and the
second where it is frozen."""

import pytest

from tests import torch_parity as tp

tp.set_torch_cpu()

# (n_agents, AlgConfig options); the actor frozen for updates 1 and 2
# (steps 0 and 1), live at 3
CASES = {
    "freeze_optax": (2, dict(actor_freeze_updates=2)),
    "freeze_fused": (2, dict(actor_freeze_updates=2, fused_opt=True)),
    "freeze_fused_v": (2, dict(actor_freeze_updates=2, fused_opt=True,
                               use_Q_credit=False, use_V=True, lr_V=3e-3)),
    # lr scale 1 (frozen), 1, 0.5 after a freeze of one update
    "freeze_anneal": (2, dict(actor_freeze_updates=1,
                              actor_lr_anneal_updates=2)),
}


@pytest.fixture(scope="module", params=sorted(CASES))
def runs(request):
    return tp.option_runs(request.param, *CASES[request.param])


@pytest.mark.parametrize("after", [1, 2, tp.OPTION_UPDATES])
def test_freeze_updates_match_jax(runs, after):
    """As ``torch_parity.hold_option_updates`` holds them."""
    tp.hold_option_updates(runs, after)


def test_freeze_takes_effect(runs):
    """As ``torch_parity.hold_options_take_effect`` holds it."""
    tp.hold_options_take_effect(runs)


@pytest.mark.parametrize("runs", ["freeze_fused", "freeze_fused_v"],
                         indirect=True)
def test_fused_freeze_leaves_the_actor_out(runs):
    """On the fused path every update makes the critics' launch
    (Q_global and Q_credit, or Q_global and V; no predicate), the
    actor's and one Polyak call over the actor's target, the last two
    under the device's freeze predicates: while frozen the actor's
    launch is left out by its predicate (off) and the Polyak call
    writes; once live the actor's launch writes and the Polyak call is
    off."""
    st = runs["states"][0][1]
    critics = [st.qg.flat.numel()] + [
        getattr(st, n).flat.numel() for n in ("qc", "v")
        if getattr(st, n) is not None]
    actor = st.actor.flat.numel()
    frozen = [("adam", critics, None), ("adam", [actor], False),
              ("polyak", [actor], True)]
    assert runs["alg"].cfg.actor_freeze_updates == 2
    assert runs["calls"][:2] == [frozen, frozen]
    assert runs["calls"][2] == [("adam", critics, None),
                                ("adam", [actor], True),
                                ("polyak", [actor], False)]
