"""The port's baselines (``cm3_tpu_torch.algs.baseline``) against the
JAX package's ``Baseline.update``: one and three updates from the same
converted state on the same batches and a' noise, for COMA, IAC,
central-V and the alpha-blend, without a gradient clip and with
``grad_clip`` 10 (the runner's stabilizing setting, idle here: these
gradients' norms are 0.0-2.6), and for the blend with ``grad_clip``
1e-3, which clips every network at every step; and what each variant's
state holds."""

import numpy as np
import pytest
import torch

from cm3_tpu_torch.algs import common
from tests import torch_parity as tp

tp.set_torch_cpu()

VARIANTS = {
    "coma": dict(use_Q=True),
    "iac": dict(use_V=True, IAC=True),
    "central_v": dict(use_V=True),
    "blend": dict(use_Q=True, use_V=True),
}


CASES = [(v, c) for v in sorted(VARIANTS) for c in (0.0, 10.0)] + [
    ("blend", 1e-3)]


@pytest.fixture(scope="module", params=CASES,
                ids=lambda p: f"{p[0]}-clip{p[1]:g}")
def runs(request):
    variant, clip = request.param
    norms = []
    with pytest.MonkeyPatch.context() as mp:
        clip_fn = common.clip_by_global_norm
        mp.setattr(common, "clip_by_global_norm", lambda g, m: (
            norms.append(float(g.norm())), clip_fn(g, m))[1])
        out = tp.other_runs("baseline", dict(VARIANTS[variant],
                                             grad_clip=clip))
    out.update(variant=variant, clip=clip, norms=norms)
    return out


@pytest.mark.parametrize("after", [1, tp.OPTION_UPDATES])
def test_baseline_updates_match_jax(runs, after):
    """Networks, targets, Adam moments and the losses at rtol 1e-5 /
    atol 1e-6 (nu atol 1e-9): float32 sums in other orders, as for CM3
    (``test_torch_optax.py``)."""
    tp.hold_other_updates(runs, after)


def test_variant_has_its_critics(runs):
    """COMA has Q and no V, IAC and central-V V and no Q, the blend
    both; V is the local critic only for IAC; every network moved."""
    alg = runs["alg"]
    v = runs["variant"]
    want_q, want_v = v in ("coma", "blend"), v != "coma"
    assert alg.net_names() == (("actor",) + (("v",) if want_v else ())
                               + (("q",) if want_q else ()))
    _, st, _, m = runs["states"][-1]
    assert (st.q is not None, st.v is not None) == (want_q, want_v)
    assert ("loss_Q" in m, "loss_V" in m) == (want_q, want_v)
    if want_v:
        assert type(st.v.module if hasattr(st.v, "module") else st.v
                    ).__name__ == ("VCheckersLocal" if v == "iac"
                                   else "VCheckersGlobal")
    start = runs["start"]
    for name in alg.net_names():
        assert not torch.equal(getattr(st, name).flat,
                               getattr(start, name).flat), name
        assert getattr(st, "opt_" + name).count == tp.OPTION_UPDATES
    assert np.isfinite(list(m.values())).all()


def test_clip_acts_where_it_should(runs):
    """The clipped runs clip every network's gradient at every step at
    1e-3 and none at 10 (one norm per network and step)."""
    n_nets = len(runs["alg"].net_names())
    if runs["clip"]:
        assert len(runs["norms"]) == n_nets * tp.OPTION_UPDATES
        above = [x > runs["clip"] for x in runs["norms"]]
        assert all(above) if runs["clip"] < 1 else not any(above)
    else:
        assert runs["norms"] == []
