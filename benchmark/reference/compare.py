"""The training cells' comparison: the program's first updates against the
reference's (``train.py``), by four numbers.  Each is first a worst case
of each seed of the sweep, over updates and parameter tensors
("leaves"); ``loss_gap`` then takes the worst seed, the three others the
90th percentile over the seeds (``SEED_QUANTILE``):

* ``loss_gap``: |program's loss - reference's| of the first update's
  critic losses (``loss_Q_global``, ``loss_Q_credit``: computed before
  any optimizer step), over the larger of the reference's |loss| and
  the median over the seeds of it;
* ``later_loss_gap_q90``: the same of every other number the updates
  return: the first update's policy loss and entropy, and all of the
  later updates';
* ``grad_gap_q90``: of the first update's gradient as the optimizer took
  it, the gap between the program's and the reference's norms of a leaf,
  over the larger of the reference's norm of that leaf and of the seed's
  median leaf.  The program's gradient is read back from its Adam state
  after the first update (mu = (1 - b1) g);
* ``change_gap_q90``: the same of each leaf's change over the updates,
  the networks' and their targets' (the soft update), leaving out the
  leaves whose reference gradient is under a thousandth of the seed's
  median leaf's: Adam moves those by round-off alone.

Why a percentile for the last three: a rounding difference that lands on
a kink (a ReLU at 0, a gradient element at 0 that Adam's first step
turns into a full step of either sign) moves one seed's later numbers by
up to a few hundredths, in one or two seeds of the 256 and in another
leaf each run, while the other seeds agree to 1e-7 - 1e-5; the worst
seed samples that tail, the 90th percentile does not, and the TF32
control departs in every seed (PERF.md).  The first update's critic
losses, before any step, are held in the worst seed.

Each number is 0 where the two agree exactly and 1 where the program's
parameters stayed where they started."""

from __future__ import annotations

import torch

B1 = 0.9            # Adam's beta1 (``port/common.py``)
NEGLIGIBLE = 1e-3   # of the median leaf's gradient norm
SEED_QUANTILE = 0.9


def leaf_norms(flat, leaves):
    """[S, L] norms of each seed's leaves of a flat [S, n] buffer."""
    cols = [flat[:, off:off + _numel(shape)].double().norm(dim=1)
            for _, shape, off in leaves]
    return torch.stack(cols, dim=1)


def _numel(shape):
    n = 1
    for d in shape:
        n *= d
    return n


def _gap(prog, ref, med):
    """Leafwise |prog - ref| over max(ref, ``med``, the seed's median
    leaf [S, 1])."""
    return (prog - ref).abs() / torch.maximum(ref, med).clamp_min(1e-30)


def compare(program, reference, initial, layout):
    """The four numbers (floats) of ``program`` against ``reference``,
    and under "detail" each loss's and each network's worst seed (its
    gap, and where it lies) and the worst seed of the three percentile
    numbers ("<number>.max"): each a dict {"losses": [{name: [S]}],
    "grads" (the reference) or "mu1" (the program's Adam first moments
    after one update): {net: [S, n]}, "params": {net or net_tgt: [S,
    n]}}; ``initial`` the weights both started from, ``layout`` the
    networks' leaves (``weights.layout``).  All tensors on the CPU."""
    detail = {}
    first, later = [], []
    for k, (lp, lr) in enumerate(zip(program["losses"],
                                     reference["losses"])):
        for name, r in lr.items():
            r = r.double()
            p = lp[name].double()
            scale = torch.maximum(r.abs(), r.abs().median()).clamp_min(1e-30)
            gap = (p - r).abs() / scale                         # [S]
            detail[f"{name}@{k + 1}"] = float(gap.max())
            (first if name.startswith("loss_") and k == 0
             else later).append(gap)
    inf = torch.full((1,), float("inf"), dtype=torch.float64)
    if len(program["losses"]) != len(reference["losses"]):
        first = later = [inf]
    loss_gap = float(_worst_seed(first or [inf]).max())
    later_seed = _worst_seed(later or [inf])

    nets = list(layout)
    g_ref = {n: leaf_norms(reference["grads"][n], layout[n]) for n in nets}
    g_prog = {n: leaf_norms(program["mu1"][n], layout[n]) / (1.0 - B1)
              for n in nets}
    ref_all = torch.cat([g_ref[n] for n in nets], dim=1)
    med = ref_all.median(dim=1, keepdim=True).values
    grad_seed, change_seed = [], []
    for n in nets:
        gaps = _gap(g_prog[n], g_ref[n], med)
        detail[f"grad.{n}"] = float(gaps.max())
        detail[f"grad.{n}.worst"] = _worst(gaps, layout[n], g_ref[n], med)
        grad_seed.append(gaps.max(dim=1).values)
        moved = g_ref[n] >= NEGLIGIBLE * med                  # [S, L]
        for key in (n, n + "_tgt"):
            d_p = leaf_norms(program["params"][key] - initial[n], layout[n])
            d_r = leaf_norms(reference["params"][key] - initial[n],
                             layout[n])
            d_med = _masked_median(d_r, moved)
            gaps = torch.where(moved, _gap(d_p, d_r, d_med), 0.0)
            detail[f"change.{key}"] = float(gaps.max())
            detail[f"change.{key}.worst"] = _worst(gaps, layout[n], d_r,
                                                   d_med)
            change_seed.append(gaps.max(dim=1).values)
    per_seed = {"later_loss_gap": later_seed,
                "grad_gap": _worst_seed(grad_seed),
                "change_gap": _worst_seed(change_seed)}
    out = {"loss_gap": loss_gap}
    for name, x in per_seed.items():
        detail[name + ".max"] = float(x.max())
        out[name + "_q90"] = float(torch.quantile(x, SEED_QUANTILE))
    out["detail"] = detail
    return out


def _worst_seed(gaps):
    """[S] each seed's worst of a list of [S] gaps."""
    return torch.stack(gaps).double().max(dim=0).values


def _worst(gaps, leaves, ref, med):
    """Where the worst gap of [S, L] lies: its leaf, the leaf's size,
    and the reference's norm of it over the seed's median leaf."""
    s, i = divmod(int(gaps.argmax()), gaps.shape[1])
    name, shape, _ = leaves[i]
    return f"{name}{list(shape)} seed {s} norm/median " \
        f"{float(ref[s, i] / med[s, 0]):.3g}"


def _masked_median(x, keep):
    """Each seed's median of ``x`` [S, L] over the entries ``keep``."""
    return torch.stack([row[k].median() if k.any() else row.new_ones(())
                        for row, k in zip(x, keep)])[:, None]
