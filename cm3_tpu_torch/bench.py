"""The port's env-throughput figures, as ``bench.py`` defines them.

* ``checkers_fused_env_steps_per_s`` (``bench.py:30-54``): the fused
  rollout kernel (``ops/checkers_rollout.py``) runs B = 2^20 two-agent
  Checkers instances (``max_steps`` 50) for T = 8192 steps of a random
  policy and returns reward sums and episode counts; one warm-up call,
  then ``reps`` timed calls, each ended by reading its reward sum on
  the host.  Figure: B x T x reps / seconds.
* ``checkers_grid_env_steps_per_s`` (``bench.py:57-97``): the grid
  engine (``envs/checkers.py``) stepped B = 8192 instances for T = 256
  steps of uniform random actions, with auto-reset to the cached reset
  state and the observations kept live (summed into the result, as the
  reference keeps XLA from dropping them).  Same formula.
* ``particle_fused_env_steps_per_s`` (``bench.py:202-224``): the fused
  particle rollout kernel (``ops/particle_rollout.py``) runs B = 2^20
  four-agent particle instances (``prob_random=0``, ``initial_std=0``)
  for T = 2048 steps of a random policy; warm-up, then ``reps`` timed
  calls, each ended by reading its reward sum on the host.
* ``roadway_fused_env_steps_per_s`` (``bench.py:177-199``): the fused
  roadway rollout kernel (``ops/roadway_rollout.py``, with its
  time-to-collision filter) runs B = 2^20 two-car roadway instances
  (``depart_stdev=0``) for T = 2048 control steps the same way.

* ``train_env_steps_per_s`` (``bench.py:264-335``, the headline):
  CM3 off-policy training of 16 seeds in lockstep, each with 256
  two-agent Checkers instances (stage 2, ``max_steps`` 50), replay of
  20000 rows per seed, and per chunk 10 env steps then 8 updates on
  B = 128 samples per seed, epsilon 0.2, the optax optimizer path
  (``AlgConfig(n_agents=2, stage=2)``), full float32; 3 warm-up chunks,
  then 5 blocks of 10 chunks, each block ended by reading the episode
  counts on the host.  Figure: S x n_envs x 10 x 10 / block seconds,
  the median of the blocks (``--one`` prints the lo and hi of the
  blocks on a line before).

    python -m cm3_tpu_torch.bench --one checkers_fused_env_steps_per_s

prints ``{NAME: value}`` (the figure rounded to an integer), as
``bench.py --one`` does.  It needs a CUDA device; the functions take
``device`` so that the tests can drive them on the CPU at small sizes.

Left out: ``bench.py``'s single-seed ``train_chunk_env_steps_per_s``
(``train_program(n_seeds=None)`` is its program; ``chip_smoke.py`` times
it beside the headline).
"""

from __future__ import annotations

import json
import sys
import time

import torch

from cm3_tpu_torch.core.config import (CheckersEnvConfig,
                                       ParticleEnvConfig, RoadwayEnvConfig)


def _cfg():
    return CheckersEnvConfig(n_agents=2, agents_r=(0, 2), agents_c=(8, 8),
                             max_steps=50)


def _fused(rollout_prng, cfg, batch, steps, reps, device):
    """``bench.py``'s fused-rollout program: a warm-up call, then
    ``reps`` calls, each ended by reading its reward sum on the host;
    B x T x reps / seconds."""
    def run(seed):
        rew, ep = rollout_prng(cfg, batch, steps, seed, device=device)
        return rew.sum(), ep.sum()

    r, _ = run(0)
    float(r)                                   # build + sync
    t0 = time.perf_counter()
    for i in range(reps):
        r, _ = run(i + 1)
        float(r)                               # forces completion
    dt = time.perf_counter() - t0
    return batch * steps * reps / dt


def bench_checkers_fused(batch: int = 1 << 20, steps: int = 8192,
                         reps: int = 3, device="cuda"):
    from cm3_tpu_torch.envs import checkers_packed as cp
    from cm3_tpu_torch.ops import checkers_rollout as cr

    spec = cp.make_spec(_cfg(), (True, False))
    return _fused(cr.rollout_prng, spec, batch, steps, reps, device)


def bench_particle_fused(batch: int = 1 << 20, steps: int = 2048,
                         reps: int = 3, device="cuda"):
    from cm3_tpu_torch.ops import particle_rollout as pr

    cfg = ParticleEnvConfig(prob_random=0.0, initial_std=0.0)
    return _fused(pr.rollout_prng, cfg, batch, steps, reps, device)


def bench_roadway_fused(batch: int = 1 << 20, steps: int = 2048,
                        reps: int = 3, device="cuda"):
    from cm3_tpu_torch.ops import roadway_rollout as rr

    cfg = RoadwayEnvConfig(depart_stdev=0.0)
    return _fused(rr.rollout_prng, cfg, batch, steps, reps, device)


def bench_checkers_throughput(batch: int = 8192, steps: int = 256,
                              reps: int = 5, device="cuda"):
    from cm3_tpu_torch.envs.checkers import Checkers, CheckersState
    from cm3_tpu_torch.train.offpolicy import _where

    env = Checkers(_cfg(), device=device)
    gen = torch.Generator(device=env.device).manual_seed(0)
    goals = torch.eye(2, device=env.device).expand(batch, -1, -1)
    state, _ = env.reset(goals)
    # the reset is deterministic given the goals: cache one reset state
    # and select it where an episode is done
    reset = env.reset(goals[:1])[0]
    fields = ("world", "loc", "collected", "goals", "steps")

    def rollout(state):
        total = torch.zeros((), device=env.device)
        for _ in range(steps):
            actions = torch.randint(0, 5, (batch, 2), device=env.device,
                                    generator=gen)
            state, ts = env.step(state, actions)
            state = CheckersState(**{
                f: _where(ts.done, getattr(reset, f), getattr(state, f))
                for f in fields})
            # observations kept live, as in the reference
            total = total + (ts.reward.sum() + ts.obs["self_t"].sum()
                             + ts.obs["self_v"].sum()
                             + ts.obs["others"].sum())
        return state, total

    state, r = rollout(state)
    float(r)                                   # warm-up + sync
    t0 = time.perf_counter()
    for _ in range(reps):
        state, r = rollout(state)
        float(r)
    dt = time.perf_counter() - t0
    return batch * steps * reps / dt


def train_program(n_seeds=16, n_envs=256, fused_opt=False, device="cuda",
                  nn_cfg=None, seed=0):
    """``bench_train_multiseed``'s training program, built: (driver, CM3
    state, replay, rollout state, draw source).  ``n_seeds=None`` is the
    one-seed program through the single-seed API."""
    from cm3_tpu_torch.algs.cm3 import CM3
    from cm3_tpu_torch.core import prng
    from cm3_tpu_torch.core.config import AlgConfig, NNConfig, TrainConfig
    from cm3_tpu_torch.envs.checkers import Checkers
    from cm3_tpu_torch.train.experiments import make_hooks
    from cm3_tpu_torch.train.offpolicy import OffPolicyDriver, init_rollout

    env = Checkers(_cfg(), device=device)
    alg = CM3("checkers", env.spec(),
              AlgConfig(n_agents=2, stage=2, fused_opt=fused_opt),
              nn_cfg or NNConfig(), device=device, n_seeds=n_seeds)
    cfg = TrainConfig(n_envs=n_envs, batch_size=128, buffer_size=20000,
                      steps_per_train=10, updates_per_chunk=8)
    driver = OffPolicyDriver(make_hooks("checkers", env), alg, cfg)
    draws = prng.GeneratorDraws(prng.generator(
        prng.for_purpose(prng.root_key(seed), prng.ROLLOUT), env.device))
    rs = init_rollout(driver.hooks, n_envs, draws, n_seeds=n_seeds)
    keys = [prng.root_key(seed + 1 + i) for i in range(n_seeds or 1)]
    ts = alg.init_state(keys[0] if n_seeds is None else keys)
    buf = driver._replay_init(driver.example_transition(rs))
    return driver, ts, buf, rs, draws


def train_blocks(program, reps=10, blocks=5, warmup=3, epsilon=0.2):
    """Training chunks of a built ``train_program``: ``warmup`` chunks,
    then ``blocks`` blocks of ``reps``, each ended by reading the episode
    counts on the host (which waits for the device).  Returns the
    env-steps/s of each block; the program advances in place."""
    driver, ts, buf, rs, draws = program
    lead = driver.lead
    steps = driver.cfg.steps_per_train

    def chunks(k):
        nonlocal ts, buf, rs
        for _ in range(k):
            ts, buf, rs, _ = driver._chunk(ts, buf, rs, epsilon, draws,
                                           True, False)
        int(rs.episodes.sum())
    chunks(warmup)
    rates = []
    for _ in range(blocks):
        t0 = time.perf_counter()
        chunks(reps)
        rates.append(lead[0] * (lead[1] if len(lead) > 1 else 1) * steps
                     * reps / (time.perf_counter() - t0))
    program[1:4] = ts, buf, rs
    return rates


def bench_train_multiseed(n_seeds: int = 16, n_envs: int = 256,
                          reps: int = 10, blocks: int = 5, device="cuda",
                          nn_cfg=None):
    """``train_env_steps_per_s``: (median, lo, hi) over ``blocks``
    timed blocks of ``reps`` training chunks, after 3 warm-up chunks."""
    program = list(train_program(n_seeds, n_envs, False, device, nn_cfg))
    rates = sorted(train_blocks(program, reps, blocks))
    return rates[len(rates) // 2], rates[0], rates[-1]


DETAIL = {
    "checkers_fused_env_steps_per_s": bench_checkers_fused,
    "checkers_grid_env_steps_per_s": bench_checkers_throughput,
    "particle_fused_env_steps_per_s": bench_particle_fused,
    "roadway_fused_env_steps_per_s": bench_roadway_fused,
    "train_env_steps_per_s": bench_train_multiseed,
}


def main(argv):
    if "--one" not in argv:
        print(f"usage: python -m cm3_tpu_torch.bench --one "
              f"{{{','.join(DETAIL)}}}", file=sys.stderr)
        return 2
    name = argv[argv.index("--one") + 1]
    if not torch.cuda.is_available():
        print("cm3_tpu_torch.bench: no CUDA device", file=sys.stderr)
        return 1
    value = DETAIL[name]()
    if isinstance(value, tuple):
        value, lo, hi = value
        print(json.dumps({"lo": round(lo), "hi": round(hi)}))
    print(json.dumps({name: round(value)}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
