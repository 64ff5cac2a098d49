"""Checkers and roadway networks: the actor and the two CM3 critics.

Port of the nets of ``cm3_tpu.models.nets`` (itself the reference
``alg/networks.py``) as ``nn.Module``s; the roadway nets are dense but
for the actor's convolutional branch over the egocentric grid at stage
2.  Names follow the flax modules, so each torch parameter maps to one
flax leaf: ``<module path>.weight`` is flax's ``kernel``, every other
name is the same (``W_h2``, ``b``, ``bias``).

Layouts.  The public forwards take the JAX layouts: observation and
state grids are NHWC.  Flax convolutions are NHWC/HWIO with SAME
padding (``nets.py:99-101``) and flatten their output in (H, W, C)
order (``nets.py:134,142``).  Here the grid is permuted to NCHW for
``F.conv2d`` and the activation back to NHWC before the flatten, so a
flax dense kernel carries over as a plain transpose.

Flat parameters.  ``flatten_parameters`` moves a module's parameters
into one flat f32 buffer in ``ravel_pytree`` order (the sorted-key
flatten of the flax dict), each parameter a view into it, and gives it
a flat gradient buffer the same way.  The fused optimizer kernel then
updates a whole network in one launch, as ``ops/fused_opt.py`` does in
the JAX package (``fused_opt.py:112-133``).

Initialization (``nets.py:47-92``): dense and conv kernels are
Glorot-uniform, biases zero, the branch-combination matrices ``W_h2``
truncated-normal with sigma 0.01, and the h2 bias ``b`` follows the init
scheme: zeros under "ref" and "trunc001", TF1's rank-1 Glorot under
"tf1"; "trunc001" also draws every kernel truncated-normal 0.01.  The
COMA critic's ``FC3`` draws its kernels truncated-normal 0.01 under
every scheme (``nets.py:364-377``), as do the mixer's ``hyper_w_1``
and ``hyper_w_final``; its ``hyper_b_1`` is a kernel of the scheme.

Precision.  On the card a float32 convolution goes through cuDNN in
TF32 unless ``torch.backends.cudnn.allow_tf32`` is False, and that is
PyTorch's default; a matrix product does when
``torch.backends.cuda.matmul.allow_tf32`` is True (or
``torch.set_float32_matmul_precision`` is not "highest").  The JAX
package pins full float32 (``cm3_tpu/train/runner.py:302,480``), and
reduced precision is measured to trap Checkers stage 1.  So every
entry of the port that runs these nets (each algorithm's ``act`` and
``update``, forward and backward: a backward reads the flags when
it runs) does so inside ``full_float32()``, which turns both flags off
and gives the caller's values back on exit, whatever they were.  The
scope is entered once per ``act`` and once per ``update`` (18 times per
training chunk of 10 steps and 8 updates, against ~6,400 kernel
launches) and costs the host a few microseconds each: four flag reads
and four writes (``chip_smoke.py`` phase 2 prints the time on the
card's host).
"""

from __future__ import annotations

import contextlib
from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn


# The reference's one departure from the frozen code: the control of the
# benchmark's comparison computes the reference with TF32 on, the
# nearest precision below the configuration's float32
# (``reference/train.py:run_reference(tf32=True)``).
TF32 = {"on": False}


@contextlib.contextmanager
def full_float32():
    """Convolutions and matrix products in full float32 (no TF32) inside
    the scope, the caller's flags restored on exit; also a decorator.
    With ``TF32["on"]`` set, TF32 instead (the control)."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = TF32["on"]
    torch.backends.cuda.matmul.allow_tf32 = TF32["on"]
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


def _dense(n_in, feats):
    return nn.Linear(n_in, feats)


def _conv(c_in, feats, kernel):
    return nn.Conv2d(c_in, feats, tuple(kernel), padding="same")


def _relu_flat_conv(conv: nn.Conv2d, t_nhwc: torch.Tensor) -> torch.Tensor:
    """conv -> relu -> flatten in (H, W, C) order, NHWC in."""
    c = F.relu(conv(t_nhwc.permute(0, 3, 1, 2)))
    return c.permute(0, 2, 3, 1).reshape(c.shape[0], -1)


class Branch(nn.Module):
    """dense -> relu, then a bias-free combination matmul into n_h2
    (networks.py:103-122): branch outputs are summed pre-activation."""

    def __init__(self, n_in: int, n_h1: int, n_h2: int):
        super().__init__()
        self.dense = _dense(n_in, n_h1)
        self.W_h2 = nn.Parameter(torch.empty(n_h1, n_h2))

    def forward(self, x):
        return F.relu(self.dense(x)) @ self.W_h2


class ConvBranch(nn.Module):
    """conv -> relu -> flatten -> dense -> relu -> combination matmul
    (networks.py:494-504); NHWC in."""

    def __init__(self, in_hwc: Tuple[int, int, int], conv_f: int,
                 conv_k: Tuple[int, int], n_reduced: int, n_h2: int):
        super().__init__()
        h, w, c = in_hwc
        self.conv = _conv(c, conv_f, conv_k)
        self.reduce = _dense(h * w * conv_f, n_reduced)
        self.W_h2 = nn.Parameter(torch.empty(n_reduced, n_h2))

    def forward(self, t):
        c = _relu_flat_conv(self.conv, t)
        return F.relu(self.reduce(c)) @ self.W_h2


# --------------------------------------------------------------------- #


class ActorCheckers(nn.Module):
    """networks.actor_checkers:549-578 (``nets.py:197``)."""

    def __init__(self, spec: Dict[str, int], conv_f: int = 3,
                 conv_k: Tuple[int, int] = (3, 3), n_h1: int = 64,
                 n_h2: int = 64, stage: int = 1):
        super().__init__()
        n_actions = spec["l_action"]
        h, w = spec["rows_obs"], spec["columns_obs"]
        self.stage = stage
        self.conv = _conv(spec["channels_obs"], conv_f, conv_k)
        self.conv_linear = _dense(h * w * conv_f, 32)
        n_x = 32 + spec["l_obs_self"] + n_actions + spec["l_goal"]
        self.self_branch = Branch(n_x, n_h1, n_h2)
        if stage > 1:
            self.stage2 = Branch(spec["l_obs_others"], n_h1, n_h2)
        self.b = nn.Parameter(torch.empty(n_h2))
        self.out = _dense(n_h2, n_actions)

    def forward(self, a_prev, t_obs_self, v_obs_self, obs_others, goal):
        conv = _relu_flat_conv(self.conv, t_obs_self)
        conv_lin = F.relu(self.conv_linear(conv))
        x = torch.cat([conv_lin, v_obs_self, a_prev, goal], dim=-1)
        h2 = self.self_branch(x)
        if self.stage > 1:
            h2 = h2 + self.stage2(obs_others)
        h2 = F.relu(h2 + self.b)
        return F.softmax(self.out(h2), dim=-1)


class _QCheckers(nn.Module):
    """Shared body of the Checkers critics (networks.py:155-183,
    244-272): two convs over the global grid and the agent's own
    observation, a stage-1 branch over their concat, a stage-2 branch
    over ``n_in2`` more features, relu, and a scalar output."""

    def __init__(self, spec: Dict[str, int], n_in2: int, conv_f1: int,
                 conv_k1: Tuple[int, int], conv_f2: int,
                 conv_k2: Tuple[int, int], n_h1_1: int, n_h1_2: int,
                 n_h2: int, stage: int):
        super().__init__()
        self.stage = stage
        rs, cs = spec["rows_state"], spec["columns_state"]
        ro, co = spec["rows_obs"], spec["columns_obs"]
        self.conv = _conv(spec["channels_state"], conv_f1, conv_k1)
        self.conv_o = _conv(spec["channels_obs"], conv_f2, conv_k2)
        n_x = (rs * cs * conv_f1 + spec["l_state_one"] + spec["l_goal"]
               + spec["l_action"] + ro * co * conv_f2 + spec["l_obs_self"])
        self.branch1 = Branch(n_x, n_h1_1, n_h2)
        if stage > 1:
            self.stage2 = Branch(n_in2, n_h1_2, n_h2)
        self.out = _dense(n_h2, 1)

    def _forward(self, s_grid, s_n, g_n, a, t_obs, v_obs, stage2_in):
        conv = _relu_flat_conv(self.conv, s_grid)
        conv_o = _relu_flat_conv(self.conv_o, t_obs)
        x = torch.cat([conv, s_n, g_n, a, conv_o, v_obs], dim=-1)
        h2 = self.branch1(x)
        if self.stage > 1:
            h2 = h2 + self.stage2(torch.cat(stage2_in, dim=-1))
        return self.out(F.relu(h2))


class QGlobalCheckers(_QCheckers):
    """networks.Q_global_checkers:155-183 (``nets.py:308``)."""

    def __init__(self, spec: Dict[str, int], conv_f1: int = 4,
                 conv_k1: Tuple[int, int] = (3, 5), conv_f2: int = 6,
                 conv_k2: Tuple[int, int] = (3, 3), n_h1_1: int = 128,
                 n_h1_2: int = 32, n_h2: int = 32, stage: int = 1):
        n_others = spec["n_agents"] - 1
        super().__init__(
            spec, n_others * (spec["l_state_one"] + spec["l_action"]),
            conv_f1, conv_k1, conv_f2, conv_k2, n_h1_1, n_h1_2, n_h2, stage)

    def forward(self, s_grid, s_n, g_n, a_n, s_others, a_others, t_obs,
                v_obs):
        return self._forward(s_grid, s_n, g_n, a_n, t_obs, v_obs,
                             [s_others, a_others.flatten(-2)])


class QCreditCheckers(_QCheckers):
    """networks.Q_credit_checkers:244-272 (``nets.py:334``)."""

    def __init__(self, spec: Dict[str, int], conv_f1: int = 4,
                 conv_k1: Tuple[int, int] = (3, 5), conv_f2: int = 6,
                 conv_k2: Tuple[int, int] = (3, 3), n_h1_1: int = 128,
                 n_h1_2: int = 32, n_h2: int = 32, stage: int = 2):
        super().__init__(
            spec, spec["n_agents"] * spec["l_state_one"],
            conv_f1, conv_k1, conv_f2, conv_k2, n_h1_1, n_h1_2, n_h2, stage)

    def forward(self, s_grid, s_n, g_n, a_m, s_m, s_others, t_obs, v_obs):
        return self._forward(s_grid, s_n, g_n, a_m, t_obs, v_obs,
                             [s_m, s_others])


# --------------------------------------------------------------------- #
# roadway (dense, with a convolutional branch over the egocentric grid)
# --------------------------------------------------------------------- #


def _grid_hwc(spec):
    return (spec["h_obs"], spec["w_obs"], spec["c_obs"])


class ActorRoadway(nn.Module):
    """networks.actor_staged:473-514 (``nets.py:172``): dense branches
    over the own vector and the goal, concatenated into h2 through the
    raw ``W_concated_h2``; at stage 2 a ``ConvBranch`` over the grid;
    the raw bias ``b``, softmax.  The JAX package builds it at these
    default widths."""

    def __init__(self, spec: Dict[str, int], n_conv_reduced: int = 64,
                 n_h1: int = 32, n_h2: int = 64, stage: int = 1):
        super().__init__()
        self.stage = stage
        self.branch1 = _dense(spec["l_obs"], n_h1)
        self.branch2 = _dense(spec["l_goal"], n_h1)
        self.W_concated_h2 = nn.Parameter(torch.empty(2 * n_h1, n_h2))
        if stage > 1:
            self.stage2 = ConvBranch(_grid_hwc(spec), 4, (5, 3),
                                     n_conv_reduced, n_h2)
        self.b = nn.Parameter(torch.empty(n_h2))
        self.out = _dense(n_h2, spec["l_action"])

    def forward(self, t_obs, v_obs, goal):
        cat = torch.cat([F.relu(self.branch1(v_obs)),
                         F.relu(self.branch2(goal))], dim=-1)
        h2 = cat @ self.W_concated_h2
        if self.stage > 1:
            h2 = h2 + self.stage2(t_obs)
        h2 = F.relu(h2 + self.b)
        return F.softmax(self.out(h2), dim=-1)


class _QParticle(nn.Module):
    """Shared body of the roadway CM3 critics (the particle critics' too)
    (networks.py:97-152, 186-241): a stage-1 branch over (s^n, g^n, a), a
    stage-2 branch over ``n_in2`` more features, relu, and a scalar
    output, bias-free for particle, with a bias for roadway
    (``out_bias``).  The stage-1 leaves of the two critics have the same
    shapes, so Q_global's graft into Q_credit."""

    def __init__(self, spec: Dict[str, int], n_in2: int, n_h1_1: int,
                 n_h1_2: int, n_h2: int, stage: int, out_bias: bool = False):
        super().__init__()
        self.stage = stage
        self.branch1 = Branch(spec["l_state_one"] + spec["l_goal"]
                              + spec["l_action"], n_h1_1, n_h2)
        if stage > 1:
            self.stage2 = Branch(n_in2, n_h1_2, n_h2)
        self.out = nn.Linear(n_h2, 1, bias=out_bias)

    def _forward(self, s_n, g_n, a, stage2_in):
        h2 = self.branch1(torch.cat([s_n, g_n, a], dim=-1))
        if self.stage > 1:
            h2 = h2 + self.stage2(torch.cat(stage2_in, dim=-1))
        return self.out(F.relu(h2))


class QGlobalRoadway(_QParticle):
    """networks.Q_global_sumo:125-152 (``nets.py:267``); the others'
    goals are an input of the reference's signature that it does not
    use."""

    def __init__(self, spec: Dict[str, int], n_h1_1: int = 256,
                 n_h1_2: int = 128, n_h2: int = 256, stage: int = 1):
        super().__init__(
            spec, (spec["n_agents"] - 1) * (spec["l_state_one"]
                                            + spec["l_action"]),
            n_h1_1, n_h1_2, n_h2, stage, out_bias=True)

    def forward(self, s_n, g_n, a_n, s_others, a_others, g_others):
        return self._forward(s_n, g_n, a_n,
                             [s_others, a_others.flatten(-2)])


class QCreditRoadway(_QParticle):
    """networks.Q_credit_sumo:214-241 (``nets.py:288``)."""

    def __init__(self, spec: Dict[str, int], n_h1_1: int = 256,
                 n_h1_2: int = 128, n_h2: int = 256, stage: int = 2):
        super().__init__(spec, spec["n_agents"] * spec["l_state_one"],
                         n_h1_1, n_h1_2, n_h2, stage, out_bias=True)

    def forward(self, s_n, g_n, a_m, s_m, s_others, g_others):
        return self._forward(s_n, g_n, a_m, [s_m, s_others])


# --------------------------------------------------------------------- #
# flat parameter buffers
# --------------------------------------------------------------------- #


def flax_path(name: str) -> Tuple[str, ...]:
    """Torch parameter name -> the flax leaf path under "params"."""
    parts = name.split(".")
    return tuple(parts[:-1]) + ({"weight": "kernel"}.get(parts[-1],
                                                         parts[-1]),)


def ordered_parameters(module: nn.Module):
    """(name, parameter) in ``ravel_pytree`` order of the flax tree."""
    return sorted(module.named_parameters(), key=lambda kv: flax_path(kv[0]))


@torch.no_grad()
def flatten_parameters(module: nn.Module, with_grad: bool = True):
    """Move ``module``'s parameters into one flat f32 buffer
    ``module.flat`` (``ravel_pytree`` order), each parameter a view into
    it; with ``with_grad`` also preset every ``.grad`` as a view into
    ``module.flat_grad``, which backward then accumulates into in
    place.  Without it the parameters stop requiring grad (targets)."""
    params = ordered_parameters(module)
    dev = params[0][1].device
    n = sum(p.numel() for _, p in params)
    flat = torch.empty(n, dtype=torch.float32, device=dev)
    grad = torch.zeros(n, dtype=torch.float32, device=dev) if with_grad \
        else None
    off = 0
    for _, p in params:
        k = p.numel()
        view = flat[off:off + k].view(p.shape)
        view.copy_(p)
        p.data = view
        if with_grad:
            p.grad = grad[off:off + k].view(p.shape)
        else:
            p.requires_grad_(False)
        off += k
    module.flat = flat
    module.flat_grad = grad
    return module


