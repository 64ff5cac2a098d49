"""Typed configuration: the subset of ``cm3_tpu.core.config`` that the
Checkers stage-2 CM3 training chunk reads.

Same frozen dataclasses, same field names and defaults.  Fields of the
JAX schema that no ported code reads yet (the particle and roadway
configs, the V/QMIX/baseline knobs, the dual and sharded replay, the
runner's schedule) are left out until the module that reads them is
ported (ROADMAP.md, queue A).  The JSON experiment files are read in
place from ``cm3_tpu/configs/`` as data.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Tuple

_CONFIG_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), "cm3_tpu", "configs")


@dataclasses.dataclass(frozen=True)
class CheckersEnvConfig:
    """Checkers grid world (reference ``env/checkers.py:5-36``)."""

    n_rows: int = 3
    n_columns: int = 8
    n_obs: int = 2
    agents_r: Tuple[int, ...] = (0, 2)
    agents_c: Tuple[int, ...] = (8, 8)
    n_agents: int = 2
    max_steps: int = 50

    @property
    def total_rows(self) -> int:
        return self.n_rows + 2 * self.n_obs

    @property
    def total_columns(self) -> int:
        return self.n_columns + 2 * self.n_obs + 1

    @property
    def max_collectible(self) -> int:
        return self.n_rows * self.n_columns


@dataclasses.dataclass(frozen=True)
class NNConfig:
    """Checkers conv-net sizes (``config_checkers_stage*.json`` "nn")."""

    Q_conv_f: int = 4
    Q_conv_k: Tuple[int, int] = (3, 5)
    Q_n_h1_1: int = 256
    Q_n_h1_2: int = 32
    Q_n_h2: int = 256
    A_conv_f: int = 6
    A_conv_k: Tuple[int, int] = (3, 3)
    A_n_h1: int = 256
    A_n_h2: int = 256


@dataclasses.dataclass(frozen=True)
class AlgConfig:
    """CM3 hyperparameters (reference ``alg/config.json:40-67``); see the
    JAX ``AlgConfig`` for the provenance of each knob."""

    stage: int = 1
    n_agents: int = 1
    tau: float = 0.01
    gamma: float = 0.99
    lr_Q: float = 1e-3
    lr_actor: float = 1e-4
    # global-norm gradient clip, 0 = off; the fused update rejects it
    grad_clip: float = 0.0
    # parameter-init scheme: "ref" | "tf1" | "trunc001" (models/nets.py)
    init_scheme: str = "ref"
    # clamp TD targets to [-target_clip, +target_clip] (0 = off)
    target_clip: float = 0.0
    # one fused Adam + apply + Polyak pass per network (ops/fused_opt.py)
    fused_opt: bool = False
    # actor lr anneal; the fused update rejects it (static lr)
    actor_lr_anneal_updates: int = 0


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Off-policy chunk schedule (reference ``alg/config.json``)."""

    buffer_size: int = 20000
    batch_size: int = 128
    steps_per_train: int = 10
    # env instances stepped in lockstep (the reference steps one)
    n_envs: int = 1
    # learning updates per chunk; 0 = auto (= n_envs)
    updates_per_chunk: int = 0


def load_json(name_or_path: str) -> dict:
    path = name_or_path
    if not os.path.exists(path):
        path = os.path.join(_CONFIG_DIR, name_or_path)
    with open(path) as f:
        return json.load(f)


def checkers_env_config(stage: int, max_steps: int = 50) -> CheckersEnvConfig:
    cfg = load_json(f"checkers_stage{stage}.json")
    init = cfg["init"]
    return CheckersEnvConfig(
        n_rows=init["n_rows"], n_columns=init["n_columns"],
        n_obs=init["n_obs"],
        agents_r=tuple(init["agents_r"]), agents_c=tuple(init["agents_c"]),
        n_agents=cfg["n_agents"], max_steps=max_steps)


def checkers_nn_config(stage: int) -> NNConfig:
    """The "nn" block of ``checkers_stage{stage}.json`` (as the JAX
    runner's ``_nn_config`` reads it for Checkers)."""
    sub = load_json(f"checkers_stage{stage}.json")["nn"]
    known = {f.name for f in dataclasses.fields(NNConfig)}
    return NNConfig(**{k: (tuple(v) if isinstance(v, list) else v)
                       for k, v in sub.items() if k in known})
