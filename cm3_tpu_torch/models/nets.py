"""Checkers, particle and roadway networks: the actor, the two CM3
critics and the V ablation critic; the baselines' IAC critic, V(s, g^n)
critic and COMA critic; QMIX's agent net and mixer.

Port of the nets of ``cm3_tpu.models.nets`` (itself the reference
``alg/networks.py``) as ``nn.Module``s; the particle nets are dense
layers only, the roadway nets dense but for a convolutional branch over
the egocentric grid (the actor's and the IAC critic's at stage 2,
QMIX's agent net's always).  Names follow the
flax modules, so each torch parameter maps to one flax leaf:
``<module path>.weight`` is flax's ``kernel``, every other name is the
same (``W_h2``, ``b``, ``bias``, the mixer's raw matrices
``hyper_w_1``, ``hyper_b_1`` and ``hyper_w_final``, which keep flax's
(d, .) layout and are used as ``x @ W``).

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

Seeds in lockstep.  ``SeedStack`` holds S independent copies of one
network's parameters in one flat [S, n] buffer (each row in the order
above), each parameter an [S, *shape] view into it, and a flat [S, n]
gradient buffer the same way.  The module's forward code is unchanged:
``torch.func.functional_call`` runs it with a given parameter dict, and
a caller maps that over the seed axis with ``torch.func.vmap``, so a
convolution becomes one grouped convolution and a dense layer one
batched product over all seeds.
Seeds share no parameter, so one backward pass of the sum of the S
seeds' losses leaves each seed's gradient in its row of ``flat_grad``.

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
import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

INIT_SCHEMES = ("ref", "tf1", "trunc001")


def init_scheme(name: str = "ref") -> str:
    """Validate an init-scheme name (``AlgConfig.init_scheme``)."""
    if name not in INIT_SCHEMES:
        raise ValueError(f"unknown init scheme {name!r}")
    return name


@contextlib.contextmanager
def full_float32():
    """Convolutions and matrix products in full float32 (no TF32) inside
    the scope, the caller's flags restored on exit; also a decorator."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


def _trunc001(t: torch.Tensor, gen: torch.Generator):
    # flax truncated_normal(0.01): a standard normal cut at +-2, times 0.01
    return nn.init.trunc_normal_(t, 0.0, 0.01, -0.02, 0.02, generator=gen)


def _fans(shape: Tuple[int, ...]):
    """(fan_in, fan_out) of a torch weight, as flax counts them on the
    flax layout: the receptive field times in/out features."""
    receptive = math.prod(shape[2:]) if len(shape) > 2 else 1
    return shape[1] * receptive, shape[0] * receptive


def _glorot(t: torch.Tensor, gen: torch.Generator):
    fan_in, fan_out = _fans(tuple(t.shape))
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    return nn.init.uniform_(t, -limit, limit, generator=gen)


def _glorot_rank1(t: torch.Tensor, gen: torch.Generator):
    """TF1 glorot_uniform on a rank-1 shape [n]: limit sqrt(3/n)."""
    limit = math.sqrt(3.0 / t.shape[0])
    return nn.init.uniform_(t, -limit, limit, generator=gen)


def _kinit(t, gen, scheme):
    """Kernels that are Glorot-uniform in the reference."""
    return _trunc001(t, gen) if scheme == "trunc001" else _glorot(t, gen)


def _binit(t, gen, scheme):
    """The h2 combination bias ``b``."""
    return _glorot_rank1(t, gen) if scheme == "tf1" else nn.init.zeros_(t)


def _dense(n_in, feats):
    return nn.Linear(n_in, feats)


def _conv(c_in, feats, kernel):
    return nn.Conv2d(c_in, feats, tuple(kernel), padding="same")


@torch.no_grad()
def init_parameters(module: nn.Module, gen: torch.Generator,
                    scheme: str = "ref"):
    """Draw every parameter of ``module`` in place (see module doc)."""
    init_scheme(scheme)
    trunc = tuple(name + "." for name, m in module.named_modules()
                  if isinstance(m, FC3))
    for name, p in sorted(module.named_parameters(),
                          key=lambda kv: flax_path(kv[0])):
        leaf = name.split(".")[-1]
        if leaf == "weight" and name.startswith(trunc):
            _trunc001(p, gen)
        elif leaf in ("weight", "hyper_b_1"):
            _kinit(p, gen, scheme)
        elif leaf == "bias":
            nn.init.zeros_(p)
        elif leaf in ("W_h2", "W_concated_h2", "hyper_w_1",
                      "hyper_w_final"):
            _trunc001(p, gen)
        elif leaf == "b":
            _binit(p, gen, scheme)
        else:
            raise KeyError(f"no initializer for parameter {name!r}")


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


class _VInner(nn.Module):
    """The body of ``VCheckersAblation``: conv over the global grid,
    then two relu layers and a bias-free scalar output."""

    def __init__(self, spec: Dict[str, int], conv_f: int,
                 conv_k: Tuple[int, int], n_h1: int, n_h2: int):
        super().__init__()
        rs, cs = spec["rows_state"], spec["columns_state"]
        self.conv = _conv(spec["channels_state"], conv_f, conv_k)
        n_x = (rs * cs * conv_f + spec["l_state_one"] + spec["l_goal"]
               + (spec["n_agents"] - 1) * spec["l_state_one"])
        self.V_h1 = _dense(n_x, n_h1)
        self.V_h2 = _dense(n_h1, n_h2)
        self.V_out = nn.Linear(n_h2, 1, bias=False)

    def forward(self, s_grid, s_n, g_n, s_others):
        conv = _relu_flat_conv(self.conv, s_grid)
        x = torch.cat([conv, s_n, g_n, s_others], dim=-1)
        h1 = F.relu(self.V_h1(x))
        return self.V_out(F.relu(self.V_h2(h1)))


class VCheckersAblation(nn.Module):
    """networks.V_checkers_ablation:461-470 (``nets.py:522``).  Every
    parameter lives under ``stage2``, so the curriculum graft leaves the
    whole critic fresh."""

    def __init__(self, spec: Dict[str, int], conv_f: int = 4,
                 conv_k: Tuple[int, int] = (3, 5), n_h1: int = 128,
                 n_h2: int = 32):
        super().__init__()
        self.stage2 = _VInner(spec, conv_f, conv_k, n_h1, n_h2)

    def forward(self, s_grid, s_n, g_n, s_others):
        return self.stage2(s_grid, s_n, g_n, s_others)


class VCheckersLocal(nn.Module):
    """networks.V_checkers_local:415-435 (``nets.py:479``): the IAC
    critic V(o^n, g^n), a conv over the agent's own observation; its
    output layer has a bias."""

    def __init__(self, spec: Dict[str, int], conv_f: int = 6,
                 conv_k: Tuple[int, int] = (3, 3), n_h1_1: int = 256,
                 n_h1_2: int = 32, n_h2: int = 256, stage: int = 1):
        super().__init__()
        ro, co = spec["rows_obs"], spec["columns_obs"]
        self.stage = stage
        self.conv = _conv(spec["channels_obs"], conv_f, conv_k)
        n_x = ro * co * conv_f + spec["l_obs_self"] + spec["l_goal"]
        self.self_branch = Branch(n_x, n_h1_1, n_h2)
        if stage > 1:
            self.stage2 = Branch(spec["l_obs_others"], n_h1_2, n_h2)
        self.out = _dense(n_h2, 1)

    def forward(self, t_obs_self, v_obs_self, v_obs_others, goal):
        conv = _relu_flat_conv(self.conv, t_obs_self)
        h2 = self.self_branch(torch.cat([conv, v_obs_self, goal], dim=-1))
        if self.stage > 1:
            h2 = h2 + self.stage2(v_obs_others)
        return self.out(F.relu(h2))


class VCheckersGlobal(nn.Module):
    """networks.V_checkers_global:438-458 (``nets.py:501``): the
    central-V critic V(s, g^n); its output layer has a bias.  The
    baseline builds it at these default widths, not ``NNConfig``'s
    (``cm3_tpu/algs/baseline.py:98``)."""

    def __init__(self, spec: Dict[str, int], conv_f: int = 2,
                 conv_k: Tuple[int, int] = (3, 5), n_h1_1: int = 128,
                 n_h1_2: int = 32, n_h2: int = 32, stage: int = 1):
        super().__init__()
        rs, cs = spec["rows_state"], spec["columns_state"]
        self.stage = stage
        self.conv = _conv(spec["channels_state"], conv_f, conv_k)
        n_x = rs * cs * conv_f + spec["l_state_one"] + spec["l_goal"]
        self.branch1 = Branch(n_x, n_h1_1, n_h2)
        if stage > 1:
            self.stage2 = Branch((spec["n_agents"] - 1) * spec["l_state_one"],
                                 n_h1_2, n_h2)
        self.out = _dense(n_h2, 1)

    def forward(self, s_grid, s_n, g_n, s_others):
        conv = _relu_flat_conv(self.conv, s_grid)
        h2 = self.branch1(torch.cat([conv, s_n, g_n], dim=-1))
        if self.stage > 1:
            h2 = h2 + self.stage2(s_others)
        return self.out(F.relu(h2))


class FC3(nn.Module):
    """networks.fc3:20-36 (``nets.py:364``): three dense layers, relu
    between; its kernels are truncated-normal 0.01 under every init
    scheme (``init_parameters``)."""

    def __init__(self, n_in: int, n_h1: int, n_h2: int, n_out: int):
        super().__init__()
        self.h1 = _dense(n_in, n_h1)
        self.h2 = _dense(n_h1, n_h2)
        self.out = _dense(n_h2, n_out)

    def forward(self, x):
        return self.out(F.relu(self.h2(F.relu(self.h1(x)))))


class QComaCheckers(nn.Module):
    """networks.Q_coma_checkers:293-306 (``nets.py:570``): COMA's
    critic, Q(s, a^{-n}, g^n, g^{-n}, label_n, o^n) for every action;
    its ``FC3`` lives under ``stage2``."""

    def __init__(self, spec: Dict[str, int], units: int = 256,
                 conv_f1: int = 4, conv_k1: Tuple[int, int] = (3, 5),
                 conv_f2: int = 6, conv_k2: Tuple[int, int] = (3, 3)):
        super().__init__()
        n, a = spec["n_agents"], spec["l_action"]
        rs, cs = spec["rows_state"], spec["columns_state"]
        ro, co = spec["rows_obs"], spec["columns_obs"]
        self.conv_s = _conv(spec["channels_state"], conv_f1, conv_k1)
        self.conv_o = _conv(spec["channels_obs"], conv_f2, conv_k2)
        n_x = (rs * cs * conv_f1 + n * spec["l_state_one"] + (n - 1) * a
               + n * spec["l_goal"] + n + ro * co * conv_f2
               + spec["l_obs_self"])
        self.stage2 = FC3(n_x, units, units, a)

    def forward(self, s_grid, s_agents, a_others, g_n, g_others, labels,
                t_obs, v_obs):
        conv_s = _relu_flat_conv(self.conv_s, s_grid)
        conv_o = _relu_flat_conv(self.conv_o, t_obs)
        return self.stage2(torch.cat(
            [conv_s, s_agents, a_others.flatten(-2), g_n, g_others, labels,
             conv_o, v_obs], dim=-1))


class QmixSingleCheckers(nn.Module):
    """networks.Qmix_single_checkers:617-637 (``nets.py:628``): one
    agent's action values; the raw bias ``b`` follows the init scheme
    like the actor's."""

    def __init__(self, spec: Dict[str, int], conv_f: int = 3,
                 conv_k: Tuple[int, int] = (3, 3), n_h1: int = 64,
                 n_h2: int = 64):
        super().__init__()
        n_actions = spec["l_action"]
        h, w = spec["rows_obs"], spec["columns_obs"]
        self.conv = _conv(spec["channels_obs"], conv_f, conv_k)
        self.conv_linear = _dense(h * w * conv_f, 32)
        n_x = 32 + spec["l_obs_self"] + n_actions + spec["l_goal"]
        self.self_branch = Branch(n_x, n_h1, n_h2)
        self.others_branch = Branch(spec["l_obs_others"], n_h1, n_h2)
        self.b = nn.Parameter(torch.empty(n_h2))
        self.out = _dense(n_h2, n_actions)

    def forward(self, a_prev, t_obs_self, v_obs_self, v_obs_others, goal):
        conv = _relu_flat_conv(self.conv, t_obs_self)
        conv_lin = F.relu(self.conv_linear(conv))
        x = torch.cat([conv_lin, v_obs_self, a_prev, goal], dim=-1)
        h2 = self.self_branch(x) + self.others_branch(v_obs_others)
        return self.out(F.relu(h2 + self.b))


class QmixMixerCheckers(nn.Module):
    """networks.Qmix_mixer_checkers:688-734 (``nets.py:675``): the
    monotonic hypernetwork mixer over a conv of the state grid, the
    agents' state rows and all goals; abs() weights, ELU hidden."""

    def __init__(self, spec: Dict[str, int], embed_dim: int = 128,
                 conv_f: int = 4, conv_k: Tuple[int, int] = (3, 5)):
        super().__init__()
        n = spec["n_agents"]
        rs, cs = spec["rows_state"], spec["columns_state"]
        self.n_agents, self.embed_dim = n, embed_dim
        self.conv = _conv(spec["channels_state"], conv_f, conv_k)
        d = rs * cs * conv_f + n * (spec["l_state_one"] + spec["l_goal"])
        self.hyper_w_1 = nn.Parameter(torch.empty(d, embed_dim * n))
        self.hyper_b_1 = nn.Parameter(torch.empty(d, embed_dim))
        self.hyper_w_final = nn.Parameter(torch.empty(d, embed_dim))
        self.hyper_b_final_l1 = nn.Linear(d, embed_dim, bias=False)
        self.hyper_b_final = nn.Linear(embed_dim, 1, bias=False)

    def forward(self, agent_qs, state_env, state, goals_all):
        conv = _relu_flat_conv(self.conv, state_env)
        return _mix(self, torch.cat([conv, state, goals_all], dim=-1),
                    agent_qs)


# --------------------------------------------------------------------- #
# particle (dense layers only)
# --------------------------------------------------------------------- #


class ActorParticle(nn.Module):
    """networks.actor_particle:517-538 (``nets.py:150``): a self branch
    over (own velocity and position, goal), a stage-2 branch over the
    others' relative observations, the raw bias ``b``, softmax."""

    def __init__(self, spec: Dict[str, int], n_h1_self: int = 64,
                 n_h1_others: int = 64, n_h2: int = 64, stage: int = 1):
        super().__init__()
        self.stage = stage
        self.self_branch = Branch(spec["l_obs_self"] + spec["l_goal"],
                                  n_h1_self, n_h2)
        if stage > 1:
            self.stage2 = Branch(spec["l_obs_others"], n_h1_others, n_h2)
        self.b = nn.Parameter(torch.empty(n_h2))
        self.out = _dense(n_h2, spec["l_action"])

    def forward(self, obs_others, v_obs, goal):
        h2 = self.self_branch(torch.cat([v_obs, goal], dim=-1))
        if self.stage > 1:
            h2 = h2 + self.stage2(obs_others)
        h2 = F.relu(h2 + self.b)
        return F.softmax(self.out(h2), dim=-1)


class _QParticle(nn.Module):
    """Shared body of the particle and roadway CM3 critics
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


class QGlobalParticle(_QParticle):
    """networks.Q_global_1output:97-122 (``nets.py:226``)."""

    def __init__(self, spec: Dict[str, int], n_h1_1: int = 64,
                 n_h1_2: int = 128, n_h2: int = 64, stage: int = 1):
        super().__init__(
            spec, (spec["n_agents"] - 1) * (spec["l_state_one"]
                                            + spec["l_action"]),
            n_h1_1, n_h1_2, n_h2, stage)

    def forward(self, s_n, g_n, a_n, s_others, a_others):
        return self._forward(s_n, g_n, a_n,
                             [s_others, a_others.flatten(-2)])


class QCreditParticle(_QParticle):
    """networks.Q_credit:186-211 (``nets.py:247``)."""

    def __init__(self, spec: Dict[str, int], n_h1_1: int = 64,
                 n_h1_2: int = 128, n_h2: int = 64, stage: int = 2):
        super().__init__(spec, spec["n_agents"] * spec["l_state_one"],
                         n_h1_1, n_h1_2, n_h2, stage)

    def forward(self, s_n, g_n, a_m, s_m, s_others):
        return self._forward(s_n, g_n, a_m, [s_m, s_others])


class _VParticleInner(nn.Module):
    """The body of ``VParticleAblation``: two relu layers and a
    bias-free scalar output."""

    def __init__(self, n_in: int, n_h1: int, n_h2: int):
        super().__init__()
        self.V_h1 = _dense(n_in, n_h1)
        self.V_h2 = _dense(n_h1, n_h2)
        self.V_out = nn.Linear(n_h2, 1, bias=False)

    def forward(self, x):
        return self.V_out(F.relu(self.V_h2(F.relu(self.V_h1(x)))))


class VParticleAblation(nn.Module):
    """networks.V_particle_ablation:405-412 (``nets.py:418``): V(s, g^n)
    over (s^n, g^n, s^{-n}); every parameter under ``stage2``."""

    def __init__(self, spec: Dict[str, int], n_h1: int = 64, n_h2: int = 64):
        super().__init__()
        n_in = (spec["n_agents"] * spec["l_state_one"] + spec["l_goal"])
        self.stage2 = _VParticleInner(n_in, n_h1, n_h2)

    def forward(self, s_n, g_n, s_others):
        return self.stage2(torch.cat([s_n, g_n, s_others], dim=-1))


class VParticleLocal(nn.Module):
    """networks.V_particle_local:356-374 (``nets.py:380``): the IAC
    critic V(o^n, g^n); bias-free output."""

    def __init__(self, spec: Dict[str, int], n_h1_1: int = 64,
                 n_h1_2: int = 64, n_h2: int = 64, stage: int = 1):
        super().__init__()
        self.stage = stage
        self.self_branch = Branch(spec["l_obs_self"] + spec["l_goal"],
                                  n_h1_1, n_h2)
        if stage > 1:
            self.stage2 = Branch(spec["l_obs_others"], n_h1_2, n_h2)
        self.out = nn.Linear(n_h2, 1, bias=False)

    def forward(self, v_obs_others, v_obs, goal):
        h2 = self.self_branch(torch.cat([v_obs, goal], dim=-1))
        if self.stage > 1:
            h2 = h2 + self.stage2(v_obs_others)
        return self.out(F.relu(h2))


class VParticleGlobal(nn.Module):
    """networks.V_particle_global:377-402 (``nets.py:399``): the
    central-V critic V(s, g^n) with the others' states and goals at
    stage 2; bias-free output."""

    def __init__(self, spec: Dict[str, int], n_h1_1: int = 64,
                 n_h1_2: int = 64, n_h2: int = 64, stage: int = 1):
        super().__init__()
        self.stage = stage
        one = spec["l_state_one"] + spec["l_goal"]
        self.branch1 = Branch(one, n_h1_1, n_h2)
        if stage > 1:
            self.stage2 = Branch((spec["n_agents"] - 1) * one, n_h1_2, n_h2)
        self.out = nn.Linear(n_h2, 1, bias=False)

    def forward(self, s_n, g_n, s_others, g_others):
        h2 = self.branch1(torch.cat([s_n, g_n], dim=-1))
        if self.stage > 1:
            h2 = h2 + self.stage2(torch.cat([s_others, g_others], dim=-1))
        return self.out(F.relu(h2))


def _l_obs_self(spec):
    """The width of an agent's own observation vector: particle's
    ``l_obs_self``, roadway's ``l_obs``."""
    return spec["l_obs_self"] if "l_obs_self" in spec else spec["l_obs"]


class QComa(nn.Module):
    """networks.Q_global:84-94 (``nets.py:555``): COMA's critic for
    particle and roadway, Q(s, a^{-n}, g^n, g^{-n}, label_n, o^n) for every action;
    its ``FC3`` lives under ``stage2``."""

    def __init__(self, spec: Dict[str, int], units: int = 256):
        super().__init__()
        n, a = spec["n_agents"], spec["l_action"]
        n_x = (n * spec["l_state_one"] + (n - 1) * a + n * spec["l_goal"]
               + n + _l_obs_self(spec))
        self.stage2 = FC3(n_x, units, units, a)

    def forward(self, v_state, a_others, g_n, g_others, labels, v_obs):
        return self.stage2(torch.cat(
            [v_state, a_others.flatten(-2), g_n, g_others, labels, v_obs],
            dim=-1))


class QmixSingleParticle(nn.Module):
    """networks.Qmix_single_particle:581-594 (``nets.py:597``): one
    agent's action values over (others, self, goal)."""

    def __init__(self, spec: Dict[str, int]):
        super().__init__()
        n_x = spec["l_obs_others"] + spec["l_obs_self"] + spec["l_goal"]
        self.h = _dense(n_x, 64)
        self.h2 = _dense(64, 64)
        self.out = _dense(64, spec["l_action"])

    def forward(self, o_others, o_self, goal):
        x = torch.cat([o_others, o_self, goal], dim=-1)
        return self.out(F.relu(self.h2(F.relu(self.h(x)))))


class QmixMixer(nn.Module):
    """networks.Qmix_mixer:640-685 (``nets.py:649``): the monotonic
    hypernetwork mixer over (state, all goals); abs() weights, ELU
    hidden.  The raw ``hyper_*`` matrices keep flax's (d, .) layout."""

    def __init__(self, spec: Dict[str, int], embed_dim: int = 64):
        super().__init__()
        n = spec["n_agents"]
        self.n_agents, self.embed_dim = n, embed_dim
        d = n * (spec["l_state_one"] + spec["l_goal"])
        self.hyper_w_1 = nn.Parameter(torch.empty(d, embed_dim * n))
        self.hyper_b_1 = nn.Parameter(torch.empty(d, embed_dim))
        self.hyper_w_final = nn.Parameter(torch.empty(d, embed_dim))
        self.hyper_b_final_l1 = nn.Linear(d, embed_dim, bias=False)
        self.hyper_b_final = nn.Linear(embed_dim, 1, bias=False)

    def forward(self, agent_qs, state, goals_all):
        sg = torch.cat([state, goals_all], dim=-1)
        return _mix(self, sg, agent_qs)


def _mix(m, sg, agent_qs):
    """The hypernetwork mix of ``agent_qs`` [B, N] conditioned on ``sg``
    (``nets.py:660-672``), for both mixers."""
    w1 = torch.abs(sg @ m.hyper_w_1).reshape(-1, m.n_agents, m.embed_dim)
    b1 = sg @ m.hyper_b_1
    hidden = F.elu(torch.einsum("bn,bne->be", agent_qs, w1) + b1)
    w_final = torch.abs(sg @ m.hyper_w_final)
    b_final = m.hyper_b_final(F.relu(m.hyper_b_final_l1(sg)))
    return torch.sum(hidden * w_final, dim=-1, keepdim=True) + b_final


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


class VRoadwayLocal(nn.Module):
    """networks.V_sumo_local:309-330 (``nets.py:441``): the IAC critic
    V(o^n, g^n), a self branch over (own vector, goal) and at stage 2 a
    ``ConvBranch`` over the grid; bias-free output."""

    def __init__(self, spec: Dict[str, int], n_h1_1: int = 64,
                 n_conv_reduced: int = 64, n_h2: int = 64, stage: int = 1):
        super().__init__()
        self.stage = stage
        self.self_branch = Branch(spec["l_obs"] + spec["l_goal"], n_h1_1,
                                  n_h2)
        if stage > 1:
            self.stage2 = ConvBranch(_grid_hwc(spec), 4, (5, 3),
                                     n_conv_reduced, n_h2)
        self.out = nn.Linear(n_h2, 1, bias=False)

    def forward(self, t_obs, v_obs, goal):
        h2 = self.self_branch(torch.cat([v_obs, goal], dim=-1))
        if self.stage > 1:
            h2 = h2 + self.stage2(t_obs)
        return self.out(F.relu(h2))


class VRoadwayGlobal(VParticleGlobal):
    """networks.V_sumo_global:333-353 (``nets.py:460``): the central-V
    critic V(s, g^n), the particle one's layout over roadway's state
    rows and goals."""


class QmixSingleRoadway(nn.Module):
    """networks.Qmix_single_sumo:597-614 (``nets.py:610``): one agent's
    action values; a self branch over (own vector, goal) and a
    ``ConvBranch`` over the grid, both always on."""

    def __init__(self, spec: Dict[str, int], n_h1: int = 64,
                 n_conv_reduced: int = 64, n_h2: int = 64):
        super().__init__()
        self.self_branch = Branch(spec["l_obs"] + spec["l_goal"], n_h1,
                                  n_h2)
        self.conv_branch = ConvBranch(_grid_hwc(spec), 4, (5, 3),
                                      n_conv_reduced, n_h2)
        self.out = _dense(n_h2, spec["l_action"])

    def forward(self, o_others, o_self, goal):
        h2 = self.self_branch(torch.cat([o_self, goal], dim=-1))
        h2 = h2 + self.conv_branch(o_others)
        return self.out(F.relu(h2))


class QmixJoint(nn.Module):
    """QMIX's agent net and mixer as one network, so that one flat
    buffer holds both in the order of JAX's ``optax.flatten`` over the
    pair (agent, mixer): the agent's leaves, then the mixer's (the
    sorted paths ``agent.*`` < ``mixer.*``).  ``forward(part, *args)``
    runs ``part`` ("agent" or "mixer"), so ``functional_call`` reaches
    either."""

    def __init__(self, agent: nn.Module, mixer: nn.Module):
        super().__init__()
        self.agent = agent
        self.mixer = mixer

    def forward(self, part: str, *args):
        return getattr(self, part)(*args)

    def agent_size(self) -> int:
        """The agent nets' floats: the flat buffer's first part."""
        return sum(p.numel() for p in self.agent.parameters())


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


class SeedStack:
    """S copies of ``module``'s parameters for seeds in lockstep.

    ``flat`` is [S, n] (row s: seed s's parameters in ``ravel_pytree``
    order, as ``flatten_parameters`` lays out one seed), ``params`` maps
    each parameter name to an [S, *shape] view of it, a leaf tensor that
    requires grad when ``with_grad``, whose ``.grad`` is preset as a
    view into ``flat_grad`` [S, n], so that backward accumulates into
    the flat buffer in place.  ``module`` is the template whose forward
    code runs (``functional_call``); its own parameter values are not
    used."""

    def __init__(self, module: nn.Module, n_seeds: int,
                 with_grad: bool = True):
        named = ordered_parameters(module)
        dev = named[0][1].device
        n = sum(p.numel() for _, p in named)
        self.module = module
        self.flat = torch.zeros((n_seeds, n), device=dev)
        self.flat_grad = (torch.zeros((n_seeds, n), device=dev)
                          if with_grad else None)
        self.params = {}
        off = 0
        for name, p in named:
            k = p.numel()
            view = self.flat[:, off:off + k].unflatten(1, p.shape)
            leaf = view.detach().requires_grad_(with_grad)
            if with_grad:
                leaf.grad = self.flat_grad[:, off:off + k].unflatten(
                    1, p.shape)
            self.params[name] = leaf
            off += k


