"""Typed configuration: the subset of ``cm3_tpu.core.config`` that the
copied modules read: CM3 training on Checkers, particle and roadway,
and the roadway struct-of-arrays engine of the fused rollout.

Same frozen dataclasses, same field names and defaults.  ``NNConfig`` has the Checkers
widths and the generic staged nets' widths of ``master.json``'s "nn"
block (``Q_units``, ``V_n_others``, ``V_n_h2``, ``Actor_n_others``,
``Actor_n_h2``).  The benchmark's configuration files
hold the values.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


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
class ParticleEnvConfig:
    """Cooperative navigation particle env
    (reference ``multiagent/core.py`` + ``scenarios/multi-goal_spread.py``)."""

    n_agents: int = 4
    agents_x: Tuple[float, ...] = (-0.9, 0.9, -0.9, 0.9)
    agents_y: Tuple[float, ...] = (-0.9, 0.9, 0.9, -0.9)
    landmarks_x: Tuple[float, ...] = (0.9, -0.9, 0.9, -0.9)
    landmarks_y: Tuple[float, ...] = (0.9, -0.9, -0.9, 0.9)
    initial_std: float = 0.0
    prob_random: float = 0.2
    max_steps: int = 33
    # physics constants (reference core.py:94-99)
    dt: float = 0.1
    damping: float = 0.25
    contact_force: float = 100.0
    contact_margin: float = 1e-3
    agent_size: float = 0.15
    accel: float = 5.0  # action force sensitivity (environment.py:211)


@dataclasses.dataclass(frozen=True)
class RoadwayEnvConfig:
    """Kinematic sublane lane-change roadway (reference ``env_sumo/simple/*``
    + ``env/egocar_simple.py`` + ``env/multicar_simple.py``).

    Geometry: one straight edge, 4 lanes x 3.2 m, 200 m long, 0.8 m
    sublane resolution (16 absolute sublanes), 0.2 s control step.
    """

    n_agents: int = 2
    goal_lane: Tuple[int, ...] = (3, 0)
    goal_pos: Tuple[float, ...] = (190.0, 190.0)
    speed: Tuple[float, ...] = (30.0, 30.0)
    lane: Tuple[int, ...] = (1, 2)
    init_position: Tuple[float, ...] = (0.0, 0.0)
    depart_mean: Tuple[float, ...] = (0.0, 0.0)
    depart_stdev: float = 0.5
    total_length: float = 200.0
    total_width: float = 12.8
    save_threshold: float = 18.0
    prob_random: float = 0.2
    # dynamics (egocar_simple.py:63-92)
    dt: float = 0.2
    n_lanes: int = 4
    sublanes_per_lane: int = 4
    sublane_res: float = 0.8
    car_length: float = 5.0
    car_width: float = 1.8
    acc_val: float = 2.5
    dec_val: float = 2.5
    v_max: float = 50.0  # vType maxSpeed (merge_stage2.rou.xml)
    v_min: float = 10.0
    overspeed: float = 35.7
    ttc_thres: float = 2.0
    # observation grid (egocar_simple.py:75, observation.py:13-44)
    obs_front: float = 15.0
    obs_back: float = 15.0
    obs_left: int = 4
    obs_right: int = 4
    res_forward: float = 2.5
    # ray-cast shadow occlusion on the egocentric grid (off by default)
    occlusion: bool = False
    # traffic metrics (multicar_simple.py:19-20,37-38)
    follow_threshold: float = 15.0
    v_threshold: float = 29.05

    @property
    def n_sublanes(self) -> int:
        return self.n_lanes * self.sublanes_per_lane

    @property
    def max_step(self) -> int:
        # round((total_length/25)/dt) (egocar_simple.py:79)
        return round((self.total_length / 25.0) / self.dt)

    @property
    def obs_rows(self) -> int:
        return int(round(self.obs_front / self.res_forward)) + int(
            round(self.obs_back / self.res_forward)) + 1

    @property
    def obs_cols(self) -> int:
        return self.obs_left + self.obs_right + 1

    # global-tensor grid over the whole road (multicar_simple.py:62-63)
    @property
    def n_rows(self) -> int:
        return int(self.total_length / self.res_forward)

    @property
    def n_cols(self) -> int:
        return int(self.total_width / self.sublane_res)


@dataclasses.dataclass(frozen=True)
class NNConfig:
    """Network sizes: the generic staged nets' (``master.json`` "nn")
    and the Checkers nets' (``config_checkers_stage*.json`` "nn")."""

    # generic staged nets (config.json "nn"): the particle actor, V
    # critics and COMA critic; the Checkers COMA critic reads Q_units,
    # its IAC critic V_n_h2 (checkers_stage2.json: 256)
    Q_units: int = 256
    V_n_others: int = 128
    V_n_h2: int = 64
    Actor_n_others: int = 128
    Actor_n_h2: int = 64
    # checkers conv nets (config_checkers_stage*.json "nn")
    Q_conv_f: int = 4
    Q_conv_k: Tuple[int, int] = (3, 5)
    Q_n_h1_1: int = 256
    Q_n_h1_2: int = 32
    Q_n_h2: int = 256
    A_conv_f: int = 6
    A_conv_k: Tuple[int, int] = (3, 3)
    A_n_h1: int = 256
    A_n_h2: int = 256
    V_conv_f: int = 6
    V_conv_k: Tuple[int, int] = (3, 3)
    V_n_h1_1: int = 256
    V_n_h1_2: int = 32


@dataclasses.dataclass(frozen=True)
class AlgConfig:
    """Algorithm hyperparameters (reference ``alg/config.json:40-67``);
    see the JAX ``AlgConfig`` for the provenance of each knob."""

    alg_name: str = "cm3"  # cm3 | coma | iac | qmix
    stage: int = 1
    n_agents: int = 1
    # the baselines' critics (algs/baseline.py): the COMA critic, the
    # per-agent local V instead of V(s, g^n), and the blend's weight of
    # the local (V) term when both critics are on
    use_Q: bool = False
    IAC: bool = False
    alpha: float = 0.7
    tau: float = 0.01
    gamma: float = 0.99
    lr_Q: float = 1e-3
    lr_actor: float = 1e-4
    # global-norm gradient clip, 0 = off (optax path; the fused update
    # rejects it)
    grad_clip: float = 0.0
    # QMIX: feed the MAIN agent nets' q-values into the target mixer, as
    # the reference's Checkers QMIX does (alg_qmix_checkers.py:106)
    qmix_ref_bug: bool = False
    # parameter-init scheme: "ref" | "tf1" | "trunc001" (models/nets.py)
    init_scheme: str = "ref"
    # clamp TD targets to [-target_clip, +target_clip] (0 = off)
    target_clip: float = 0.0
    # fused Adam + apply + Polyak kernel launches (ops/fused_opt.py)
    # instead of the optax-order plain update (algs/common.adam_apply)
    fused_opt: bool = False
    # actor lr anneal to 0 over this many updates counted from the end
    # of the freeze window (optax path; the fused update rejects it: its
    # lr is static)
    actor_lr_anneal_updates: int = 0
    # the Q_credit critic (n > 1); off with use_V gives the paper's V
    # ablation, off with neither gives the summed Q_actual advantage
    use_Q_credit: bool = True
    # the V(s, g^n) ablation critic and its learning rate (n > 1)
    use_V: bool = False
    lr_V: float = 1e-3
    # standardize the policy-gradient advantages over each update batch
    adv_norm: bool = False
    # clipped importance weight min(pi_now(a) / bp(a), c) on the policy
    # gradient, bp the stored behavior probability (0 = off)
    pg_is_clip: float = 0.0
    # entropy bonus of the pure (epsilon 0) softmax on the policy loss
    pg_ent_coef: float = 0.0
    # keep the actor, its Adam state and its target's main frozen for
    # the first K updates (0 = off)
    actor_freeze_updates: int = 0


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Driver schedule (reference ``alg/config.json`` + trainers): the
    JAX package's fields, in its order.  ``episodes_per_train`` and
    ``epochs`` set the on-policy driver's bursts; ``dual_buffer``
    routes whole episodes into a bad and a good memory by the hooks'
    predicate (roadway's reads ``threshold``, which the runner hands
    the hooks); ``prob_random``, ``seed``, ``n_seeds`` and ``dir_name``
    are carried from the master config as the JAX runner carries them,
    and the drivers do not read them.  ``summarize`` adds gradient
    snapshots to the period rows (and the runner's TensorBoard files),
    ``chunks_per_sync`` = K > 1 runs K chunks per host sync, and
    ``replay_shards`` = D > 1 keeps D shard-local replay rings on the
    one device, as in JAX."""

    N_train: int = 50000
    period: int = 100
    N_eval: int = 10
    epsilon_start: float = 0.5
    epsilon_end: float = 0.05
    epsilon_div: float = 1000.0
    dual_buffer: bool = False
    buffer_size: int = 20000
    # dual-buffer routing threshold (only the roadway predicate reads it)
    threshold: float = 16.0
    batch_size: int = 128
    pretrain_episodes: int = 50
    steps_per_train: int = 10
    episodes_per_train: int = 10
    epochs: int = 24
    # greedy-eval rollout length (the env's own cap is its config's)
    max_steps: int = 33
    prob_random: float = 0.2
    seed: int = 12341
    n_seeds: int = 1
    # env instances stepped in lockstep (the reference steps one)
    n_envs: int = 1
    # learning updates per chunk; 0 = auto (= n_envs)
    updates_per_chunk: int = 0
    # eval threshold of the snapshots (None: the experiment's rule)
    save_threshold: Optional[float] = None
    dir_name: str = "try"
    # TensorBoard gradient summaries
    summarize: bool = False
    # training chunks per host sync
    chunks_per_sync: int = 1
    # shard-local replay rings (n_envs, batch_size and buffer_size
    # divisible by it)
    replay_shards: int = 1
    # rows of the sampled per-episode return ring flushed per period
    # (the reference's log.csv stream); 0 disables
    episode_log: int = 1024

    @property
    def epsilon_step(self) -> float:
        return (self.epsilon_start - self.epsilon_end) / float(
            self.epsilon_div)


