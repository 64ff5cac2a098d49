"""The conv nets' convolution -> ReLU -> flatten, every seed in one launch
each way.

Replaces no Pallas kernel of ``cm3_tpu``: the JAX package leaves this
convolution to XLA (``cm3_tpu/models/nets.py``).  It was added for the
port's seed axis.  ``torch.func.vmap`` over ``nets.SeedStack`` made each
convolution of a net one cuDNN grouped convolution with groups = S, and
at 256 seeds cuDNN's weight gradient of it took most of a CM3 update's
device time on the card (PERF.md).  Every conv net of the port reaches
this op through ``models/nets.py:_relu_flat_conv``.

It computes, for one seed, NHWC ``x`` [R, H, W, C], ``weight`` [F, C,
kh, kw] and ``bias`` [F], "same" zero padding (as ``nn.Conv2d(padding=
"same")`` pads: (k - 1) // 2 before, the rest after, so an even kernel
too):

    relu(conv2d(x, weight) + bias) flattened in (H, W, F) order, [R, H*W*F]

and the gradients of ``weight`` and ``bias``.  The input gradient is
never formed: every conv of the port reads observations or state grids,
so a CUDA input that requires grad is refused, not approximated.

Bound on an H100.  The convolutions are tiny (2-3 channels, 2-8 filters,
3x3 to 5x3 taps), so each pass reads its operands once and does 120-162
multiply-adds a position: bound by memory traffic.  At the 256-seed
sweeps' sizes (R = 256 rows a seed) the forward moves 43-184 MB (13-55
us at 3.35 TB/s), the weight gradient 71-307 MB (21-92 us); PERF.md
gives the times.

Design (CUDA C++, ``csrc/seed_conv.cu``; its header has the details):

* ``cm3_seed_conv_forward``: one launch for all seeds, a block of 512
  positions of one seed with the seed's filters and the images those
  positions lie in in shared memory, each thread two positions' F
  outputs, written straight in the flatten order: no permute copies, no
  separate ReLU.
* ``cm3_seed_conv_wgrad``: two launches for all seeds.  A block sums one
  slice of 512 positions of one seed from shared memory (its images and
  its masked output gradient), a lane per tap (the bias the last tap);
  then a second kernel adds the slices in slice order.  No float
  atomics, so the gradient is the same bits in every run; the slices
  follow from the seed's own R*H*W and never from S, so a seed's
  gradient is the same bits whether 1 or 256 seeds run beside it.
* Float32 throughout (fused multiply-adds, no TF32).
* Any size: a launch takes 1 to ``MAX_FILTERS`` filters, and more run in
  groups of ``MAX_FILTERS`` (each group's output and gradient copied into
  place); images too large for a block's shared memory, or filters of
  more taps, take the same kernels reading global memory instead.

Seeds.  ``relu_flat_conv`` is written for one seed.  Under
``torch.func.vmap`` its ``torch.autograd.Function``'s ``vmap`` rule
folds the mapped axis into the stacked seed axis, so one call of the
kernels takes every seed, whatever the nets' forward code does around
it; without seeds the call is the same with S = 1.  A seed's weights may
sit at any stride between seeds (a row of a seed stack's flat buffer).

``relu_flat_conv`` takes ``relu_flat_conv_plain`` (the nets' code before
this op: permute, ``F.conv2d``, ReLU, permute, flatten) for tensors on
the CPU, launches the kernels for CUDA tensors or raises on a shape or
type they do not take (``check``: not float32, more than ``MAX_SEEDS``
seeds, or an index past 32 bits), and raises for any other device.
``forward_plain`` and ``wgrad_plain`` are the kernels' own functions on
the stacked layout in plain PyTorch, for the tests and ``chip_smoke.py``.
``relu_flat_conv.launches`` counts kernel launches: 1 a forward, 2 a
weight gradient, for each group of ``MAX_FILTERS`` filters.
"""

from __future__ import annotations

import os
import re

import torch
import torch.nn.functional as F

from cm3_tpu_torch.ops import _nvcc

_SOURCE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "csrc", "seed_conv.cu")


def _source_constants():
    """The kernels' limits, as ``csrc/seed_conv.cu`` sets them (its
    ``constexpr int k... = n;`` lines): one place for both sides."""
    with open(_SOURCE) as f:
        return {k: int(v) for k, v in
                re.findall(r"constexpr int (k\w+) = (\d+);", f.read())}


_LIMITS = _source_constants()
MAX_FILTERS = _LIMITS["kMaxFilters"]          # filters a launch takes
SLICE_POSITIONS = _LIMITS["kSlicePositions"]  # positions a block sums
MAX_SEEDS = _LIMITS["kMaxSeeds"]              # the grid's y dimension
INT_MAX = 2 ** 31 - 1


def relu_flat_conv_plain(x, weight, bias):
    """One seed's conv -> ReLU -> flatten in plain PyTorch: NHWC ``x``
    permuted to NCHW for ``F.conv2d`` ("same" padding), the activation
    back to NHWC and flattened in (H, W, F) order."""
    c = F.relu(F.conv2d(x.permute(0, 3, 1, 2), weight, bias,
                        padding="same"))
    return c.permute(0, 2, 3, 1).reshape(c.shape[0], -1)


def forward_plain(x, weight, bias):
    """The forward kernel's function on the stacked layout: x [S, R, H,
    W, C], weight [S, F, C, kh, kw], bias [S, F] -> [S, R, H*W*F], a seed
    at a time."""
    return torch.stack([relu_flat_conv_plain(*a)
                        for a in zip(x, weight, bias)])


def wgrad_plain(g, y, x, kh: int, kw: int):
    """The weight-gradient kernels' function on the stacked layout: from
    the output's gradient ``g`` and the output ``y`` [S, R, H*W*F] (the
    ReLU's mask: where y <= 0 the gradient is 0) and the input ``x`` [S,
    R, H, W, C], (dw [S, F, C, kh, kw], db [S, F]) through ``F.unfold``
    (the input's windows, "same" padding) and one product per seed."""
    s, r, h, w, c = x.shape
    d = torch.where(y <= 0, torch.zeros_like(g), g).reshape(s, r * h * w, -1)
    pad = [(k - 1) // 2 for k in (kw, kh)]
    pad = (pad[0], kw - 1 - pad[0], pad[1], kh - 1 - pad[1])
    cols = F.unfold(F.pad(x.reshape(s * r, h, w, c).permute(0, 3, 1, 2),
                          pad), (kh, kw))
    cols = cols.reshape(s, r, c * kh * kw, h * w).permute(0, 2, 1, 3)
    dw = torch.bmm(d.transpose(1, 2), cols.reshape(s, c * kh * kw, -1)
                   .transpose(1, 2))
    return dw.reshape(s, -1, c, kh, kw), d.sum(1)


def check(x, weight, bias):
    """The stacked shapes (S, R, H, W, C, F, kh, kw) of x [S, R, H, W,
    C], weight [S, F, C, kh, kw] and bias [S, F], if the kernels take
    them: float32 on one device, at least one row, filter and tap, at
    most ``MAX_SEEDS`` seeds, and every index within 32 bits.  Raises
    ValueError on anything else."""
    if x.dim() != 5 or weight.dim() != 5 or bias.dim() != 2:
        raise ValueError(f"seed_conv: x [S, R, H, W, C], weight [S, F, C, "
                         f"kh, kw], bias [S, F], got {tuple(x.shape)}, "
                         f"{tuple(weight.shape)}, {tuple(bias.shape)}")
    s, r, h, w, c = x.shape
    _, f, c_w, kh, kw = weight.shape
    if weight.shape[0] != s or bias.shape != (s, f) or c_w != c:
        raise ValueError(f"seed_conv: shapes disagree: x {tuple(x.shape)}, "
                         f"weight {tuple(weight.shape)}, bias "
                         f"{tuple(bias.shape)}")
    for name, t in (("x", x), ("weight", weight), ("bias", bias)):
        if t.dtype != torch.float32 or t.device != x.device:
            raise ValueError(f"seed_conv: {name} must be float32 on "
                             f"{x.device}, got {t.dtype} on {t.device}")
    if not 1 <= s <= MAX_SEEDS or min(r, h, w, c, f, kh, kw) < 1 \
            or s * r * h * w * max(c, f) > INT_MAX \
            or s * (c * kh * kw + 1) * f > INT_MAX:
        raise ValueError(f"seed_conv: {s} seeds of {r} rows of {h} x {w} x "
                         f"{c}, {f} filters of {kh} x {kw} (1 to "
                         f"{MAX_SEEDS} seeds, at least one of each, indices "
                         "within 32 bits)")
    return s, r, h, w, c, f, kh, kw


def slices(r: int, h: int, w: int) -> int:
    """The blocks one seed's weight gradient is summed over: from the
    seed's own positions alone."""
    return -(-r * h * w // SLICE_POSITIONS)


def filter_groups(f: int):
    """(first filter, filters) of each launch for ``f`` filters: groups
    of ``MAX_FILTERS``."""
    return [(f0, min(MAX_FILTERS, f - f0))
            for f0 in range(0, f, MAX_FILTERS)]


def _seed_block(t):
    """``t`` with each seed's block contiguous (a row of a seed stack's
    flat buffer is), and the stride between seeds."""
    if not t[0].is_contiguous():
        t = t.contiguous()
    return t, t.stride(0)


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


def forward_entry(lib, x, weight, bias, stream=None, fail=_nvcc.check):
    """The forward's C entry on the stacked x, weight and bias, once per
    filter group: out [S, R, H*W*F].  ``fail(code, what)`` raises on an
    error code."""
    s, r, h, w, c, f, kh, kw = check(x, weight, bias)
    x = x.contiguous()
    out = torch.empty((s, r, h * w, f), device=x.device)
    for f0, n in filter_groups(f):
        wg, w_stride = _seed_block(weight[:, f0:f0 + n])
        bg, b_stride = _seed_block(bias[:, f0:f0 + n])
        part = out if n == f else torch.empty((s, r, h * w, n),
                                              device=x.device)
        fail(lib.cm3_seed_conv_forward(
            x.data_ptr(), wg.data_ptr(), w_stride, bg.data_ptr(), b_stride,
            part.data_ptr(), s, r, h, w, c, n, kh, kw, stream),
            "seed_conv forward")
        if part is not out:
            out[..., f0:f0 + n] = part
    return out.view(s, r, -1)


def wgrad_entry(lib, g, y, x, kh: int, kw: int, stream=None,
                fail=_nvcc.check):
    """The weight gradient's C entry on the stacked output gradient
    ``g``, output ``y`` and input ``x``, once per filter group: (dw [S, F,
    C, kh, kw], db [S, F])."""
    s, r, h, w, c = x.shape
    f = y.shape[-1] // (h * w)
    x = x.contiguous()
    n_slices = slices(r, h, w)
    dw = torch.empty((s, f, c, kh, kw), device=x.device)
    db = torch.empty((s, f), device=x.device)
    for f0, n in filter_groups(f):
        if n == f:
            gg, yg, dwg, dbg = g.contiguous(), y.contiguous(), dw, db
        else:
            gg, yg = (t.reshape(s, r, h * w, f)[..., f0:f0 + n].contiguous()
                      for t in (g, y))
            dwg = torch.empty((s, n, c, kh, kw), device=x.device)
            dbg = torch.empty((s, n), device=x.device)
        partial = torch.empty(s * n_slices * (c * kh * kw + 1) * n,
                              device=x.device)
        fail(lib.cm3_seed_conv_wgrad(
            gg.data_ptr(), yg.data_ptr(), x.data_ptr(), partial.data_ptr(),
            dwg.data_ptr(), dbg.data_ptr(), s, r, h, w, c, n, kh, kw,
            n_slices, stream), "seed_conv weight gradient")
        if n != f:
            dw[:, f0:f0 + n], db[:, f0:f0 + n] = dwg, dbg
    return dw, db


def _forward_kernel(x, weight, bias):
    with torch.cuda.device(x.device):
        out = forward_entry(_nvcc.library(), x, weight, bias,
                            _stream(x.device))
    relu_flat_conv.launches += len(filter_groups(weight.shape[1]))
    return out


def _wgrad_kernel(g, y, x, kh: int, kw: int):
    with torch.cuda.device(x.device):
        dw, db = wgrad_entry(_nvcc.library(), g, y, x, kh, kw,
                             _stream(x.device))
    relu_flat_conv.launches += 2 * len(filter_groups(dw.shape[1]))
    return dw, db


class _SeedConv(torch.autograd.Function):
    """The stacked op: x [S, R, H, W, C], weight [S, F, C, kh, kw], bias
    [S, F] -> [S, R, H*W*F], the backward to weight and bias only."""

    @staticmethod
    def forward(x, weight, bias):
        if x.requires_grad:
            raise ValueError("seed_conv: the input gradient is not "
                             "computed; the input must not require grad")
        return _forward_kernel(x, weight, bias)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, weight, _ = inputs
        ctx.save_for_backward(x, output)
        ctx.kernel = tuple(weight.shape[-2:])

    @staticmethod
    def backward(ctx, grad):
        x, y = ctx.saved_tensors
        dw, db = _wgrad_kernel(grad, y, x, *ctx.kernel)
        return None, dw, db

    @staticmethod
    def vmap(info, in_dims, x, weight, bias):
        """A mapped axis (seeds under ``torch.func.vmap``) joins the
        stacked axis in front of it: one call for every seed."""
        def fold(t, d):
            t = (t.expand(info.batch_size, *t.shape) if d is None
                 else t.movedim(d, 0))
            return t.flatten(0, 1)
        out = _SeedConv.apply(*(fold(t, d) for t, d in
                                zip((x, weight, bias), in_dims)))
        return out.unflatten(0, (info.batch_size, -1)), 0


def _one_seed(x, weight, bias):
    """One seed's call as a stack of one (under vmap, of every seed)."""
    return _SeedConv.apply(x[None], weight[None], bias[None])[0]


def relu_flat_conv(x, weight, bias):
    """One seed's conv -> ReLU -> flatten: NHWC ``x`` [R, H, W, C],
    ``weight`` [F, C, kh, kw], ``bias`` [F] -> [R, H*W*F] in (H, W, F)
    order.  The plain version on the CPU; on the card the kernels, one
    launch for every seed under ``torch.func.vmap``."""
    if x.device.type == "cpu":
        return relu_flat_conv_plain(x, weight, bias)
    if x.device.type != "cuda":
        raise RuntimeError(f"seed_conv: no kernel for device {x.device}")
    return _one_seed(x, weight, bias)


def occupancy(which: int, filters: int, tiled: bool = True):
    """A built kernel's registers, resident blocks per SM, threads per
    block and spill bytes (``which``: 0 the forward, 1 the weight
    gradient's partial sums, 2 their sum; ``filters`` F; ``tiled`` the
    variant that holds its operands in shared memory); needs the card."""
    return _nvcc.occupancy("cm3_seed_conv_occupancy", which, filters,
                           int(tiled))


relu_flat_conv.launches = 0
