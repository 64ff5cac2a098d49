#!/usr/bin/env python3
"""Drive the PyTorch port (``cm3_tpu_torch``) on one NVIDIA GPU and
check it.

Run from the root of a checkout:  python3 chip_smoke.py

Seventeen phases, each between progress lines with its elapsed seconds
and held to a time budget (30 + 45 + 10 + 10 + 73 + 10 + 80 + 48 + 37 +
120 + 112 + 93 + 67 + 251 + 73 + 61 + 60 s = 1180 s: about 1.46x each
phase's longest cold time on an H100 over PR 15's and PR 16's runs, 0:
5.0, 1: 26.3, 2: 3.6, 3: 5.3, 4: 50.2, 5: 1.2, 6: 54.6, 7: 33.2, 8:
25.6, 9: 82.2, 10: 76.8, 11: 63.5, 12: 45.7, 13: 213.4 (before its K = 1
/ K = 32 turns were cut from 100 episodes each to 50, ~40 s less), 14:
50.3, 15: 41.1 s, with at least 10 s a phase and 30 s for a cold
``nvcc`` build; phase 16 got the 60 s taken from phase 13; a whole run
493.9-753.8 s):

0. build: the CUDA C++ kernels of ``cm3_tpu_torch/csrc`` built into
   ``build/cm3_tpu_torch/`` by one ``nvcc -c`` per source, all started
   together, and one link (or found there by their hash): the nvcc
   path and version, the commands, the seconds and ptxas' register
   report.
1. Adam + Polyak (CUDA C++, ``csrc/flat_update.cu``): the kernel against
   its plain PyTorch version bit for bit (rtol 0, atol 0) for 5 steps at
   the three flat-buffer sizes of the main path and at ragged sizes, on
   views offset by 1-3 floats, for two networks in one launch (also
   against one launch each) and for four ragged networks; then, for the
   main path's two launches (the actor; both critics in one), its time
   per launch back to back and in CUDA graphs (the device time alone):
   after a PyTorch kernel (as on the main path, where a backward pass
   comes before it: the time a launch adds to a PyTorch kernel's), warm
   (launches back to back on the same buffers), cold (rotating over 128
   MB of buffer sets, so that every launch misses the L2) and at n = 0
   (the launch floor), beside its memory bound and the share of it, the
   plain version's time and a library yardstick over the same networks
   (``torch.optim.Adam(fused=True, capturable=True).step`` plus
   ``torch._foreach_lerp_``; the port never calls it), kernel and
   yardstick timed in turns (the kernel alone through its C entry,
   reading its step counts from device memory, with no predicate and
   with a device predicate of 1, and through its wrapper
   ``adam_polyak_many``, also back to back); the same at the
   seed-batched path's sizes
   (16 seeds: segments of 16 x n floats); one CM3 update's tail as two
   launches against three, warm and cold, in turns; the kernel's
   registers and resident blocks per SM.
2. the slice: the Checkers stage-2 CM3 training chunk at full width
   (n_envs 256, 10 env steps, 8 updates on B=128, buffer 20000,
   fused optimizer), as ``bench.py``'s headline program runs it for one
   seed: 2 random-fill chunks, then training chunks, with the kernel's
   launch count set to 0 just before and read just after; the host
   cost of the nets' full-float32 scope.
3. card against CPU: one fill and one training chunk from the same
   seeded state with the same fed draws on the card and on the CPU
   (plain versions there), compared at a stated tolerance; then the
   same for three seeds in lockstep (n_envs 8, the nets at full width)
   for stage 2 and for stage 1 (one agent, random goals) on the optax
   path.
4. the fused Checkers rollout (CUDA C++): the kernel against its plain
   version on fed actions at a ragged batch, and with Philox draws on
   the card and on the CPU; then ``bench.py``'s
   ``checkers_fused_env_steps_per_s`` program at full size (B = 2^20,
   T = 8192) through ``cm3_tpu_torch.bench``, with the launch count set
   to 0 just before and read just after; that call timed and held
   against the plain version at the same size and seed; the kernel's
   time against its instruction-issue bound (the operations one step
   needs, counted in ``cm3_tpu_torch/ops/checkers_rollout.py``), the
   plain version's time, the kernel's registers and resident blocks
   per SM, and the grid-engine figure ``checkers_grid_env_steps_per_s``.
5. Polyak (CUDA C++, ``csrc/flat_update.cu``): the kernel against its
   plain version bit for bit at five sizes and three tau values and on
   views offset by 1-3 floats; a soft update of the three networks of
   the slice's CM3 state, with the launch count set to 0 just before and
   read just after; its time back to back and in CUDA graphs, after a
   PyTorch kernel, warm, cold and at n = 0, beside its memory bound, the
   plain version's and ``Tensor.lerp_``'s (kernel and ``lerp_`` in graphs
   in turns, after a PyTorch kernel, warm and cold, with their spread;
   the kernel also under a device predicate of 1); registers and blocks
   per SM.
6. the fused particle rollout (CUDA C++) and
7. the fused roadway rollout (CUDA C++), each: the kernel against its
   plain version on fed actions at a ragged batch over several
   episodes (particle: also from a start within contact range), and
   with Philox draws on the card and on the CPU; then
   ``bench.py``'s ``particle_fused_env_steps_per_s`` /
   ``roadway_fused_env_steps_per_s`` program at full size (B = 2^20,
   T = 2048, 3 reps) through ``cm3_tpu_torch.bench``, with the launch
   count set to 0 just before and read just after; one full-size call
   timed and held against the plain version at the same size and seed;
   the plain version run again on those inputs with an observer that
   counts the work the data decide (pairs in contact, live cars, TTC
   candidates, ...; particle: also the share of warps, 32
   consecutive instances, in which a lane takes a pair's contact
   branch); the kernel's time against its bound (the operations the
   call needs, itemized in ``ops/particle_rollout.py`` and
   ``ops/roadway_rollout.py``, at the issue rate and at the
   special-function unit's rate; the larger bounds it), the plain
   version's time and (particle) the kernel's registers and resident
   blocks per SM.

8. seed-batched training: ``cm3_tpu_torch.bench``'s
   ``train_env_steps_per_s`` program (``bench.py:264-335``: 16 seeds x
   256 envs, 10 env steps then 8 optax updates on B = 128 per seed a
   chunk) at full size, its blocks of 10 chunks taken in turns with
   the one-seed program's at 256 envs, printing the figure (median,
   lo, hi) beside the one-seed figure; the same 16-seed program on the
   fused path, with the kernel's launch count set to 0 just before and
   read just after (2 per update, 16 per chunk, for all 16 seeds); and
   ``train_vmapped_seeds`` on stage 1 (one agent, 3 seeds x 256 envs)
   through two period rows, with finite evaluation returns.
9. the curriculum through the runner (``cm3_tpu_torch.train.runner``),
   in a temporary workdir, at the full widths of
   ``checkers_stage1.json`` and ``checkers_stage2.json``, with
   ``master.json`` and the paper's ``checkers_s1`` / ``checkers_s2`` /
   ``checkers_s2_V`` settings (16 envs, N_eval 10, a period of 100
   episodes); the episode budgets are cut to fit the phase's time
   (``CURR_*`` below; the paper's runs are 50,000 episodes): stage 1
   (optax) through ``train_function``, with its logs and
   ``model_final``, and the same program through
   ``OffPolicyDriver.run`` alone, in turns (the runner's overhead);
   stage 2 from it (``train_from_nothing`` 0, fused optimizer, the
   actor frozen for its first 20 updates), its grafted start state held
   on the card
   first (shared leaves equal stage 1's bit for bit, Q_credit's equal
   Q_global's, targets equal mains), then trained with the Adam +
   Polyak and the Polyak kernels' launch counts set to 0 just before
   and read just after (the freeze is a device predicate: B1 twice and
   the Polyak kernel once at every update, each writing where its
   predicate holds); the
   autosave's bytes and seconds and a period's CSV writes, timed alone;
   stage 2 resumed with ``auto_resume`` to a larger budget, starting
   at the autosave's episode count; three seeds in lockstep
   (``vmapped_seeds``) with the graft into every seed, held first; the
   V ablation for two periods; and one ``python -m
   cm3_tpu_torch.train.runner`` process, which must exit 0 with period
   rows.  Episodes per second and the wall time of each run.
10. the baselines and QMIX (``algs/baseline.py``, ``algs/qmix.py``):
   card against CPU, one fill and one training chunk from the same
   seeded state with the same fed draws (QMIX's override actions and
   uniforms among them) at full width for QMIX, QMIX with the
   reference's wiring (``qmix_ref_bug``), COMA, IAC, central-V and the
   blend, and for QMIX and COMA with three seeds in lockstep, at phase
   3's tolerance; the paper's ``checkers_qmix``, ``checkers_qmix_ref``,
   ``checkers_coma`` and ``checkers_iac`` cells (16 envs, N_eval 10, a
   period of 100 episodes, stage 2 from nothing; budgets cut from
   50,000 episodes to 150, ``CELL_*`` below) through
   ``runner.train_function`` in turns with CM3's stage 2 from nothing
   (the optax path, as the cells), each with the Adam + Polyak kernel's
   launch count set to 0 just before and read just after (these
   algorithms run the optax path: it must stay 0), their episodes per
   second; ``checkers_coma`` with three seeds in lockstep through
   ``train_multiseed``; QMIX resumed from its autosave to a larger
   budget; and one ``python -m cm3_tpu_torch.train.runner --alg qmix``
   process, which must exit 0 with a period row.
11. particle through the runner (``envs/particle.py``,
   ``train/onpolicy.py``; the particle branches of the algorithms):
   four-agent particle at the full widths of ``master.json``'s "nn",
   card against CPU from the same seeded state with the same fed draws
   (the reset's four draws among them) at phase 3's tolerance: CM3
   on-policy (a fill chunk, a policy chunk and a burst of 24 updates;
   fused for one seed, with B1's launches counted: 2 per update; optax
   for three seeds) and QMIX off-policy (a fill and a training chunk),
   one seed and three; B1 bit for bit at the particle actor's and both
   critics' sizes and its time per launch there; then the paper's
   ``particle_s1``, ``particle_s2``, ``particle_s2_V``,
   ``particle_coma`` and ``particle_qmix`` cells and an IAC run (16
   envs, N_eval 10, a period of 100 episodes; budgets ``PT_*`` below)
   through ``runner.train_function``, each with B1's launch count set
   to 0 just before and read just after (0 on the optax path, which
   the paper's cells run), the stage-1 -> stage-2 graft held on the
   card first; one fused stage 2 with the actor frozen for 20 updates
   (B1 = 2 and B3 = 1 per update: the freeze predicates);
   three seeds in lockstep on-policy with the graft into every seed;
   an auto-resume (the state restored, the episode count restarted, as
   JAX's on-policy runner does); and one ``python -m
   cm3_tpu_torch.train.runner --experiment particle`` process.  Each
   run's episodes per second, and ``t_env`` / ``t_train`` for the
   on-policy ones.
12. roadway and the dual buffer through the runner
   (``envs/roadway.py``, the feasibility filter, ``RoadwayHooks``, the
   roadway nets and branches, the dual buffer and its staging slab):
   card against CPU from the same seeded state with the same fed draws
   (the roadway reset's branch, lanes, goal lanes and depart noise; the
   dual buffer's indices taken modulo each memory's fill) at phase 3's
   tolerance: CM3 on two cars with the dual buffer (a short road at top
   speed, a slab of 3 transitions, a fill and a training chunk of 4
   updates; fused for one seed, with B1's launches counted, optax for
   three seeds) and CM3 on-policy on particle ``stage2_cross`` with the
   dual buffer (a fill chunk, a policy chunk and a burst of 24); B1 bit
   for bit at the roadway actor's and both critics' sizes and its time
   per launch there, B3 bit for bit at the actor's size; then the paper's ``roadway_s1`` through one
   ``python -m cm3_tpu_torch.train.runner --experiment roadway``
   process, its graft into stage 2 held on the card, ``roadway_s2``
   (grafted, dual buffer), ``roadway_s2_stable`` (``grad_clip`` 10),
   ``roadway_qmix``, a fused ``roadway_s2`` with the actor frozen for
   20 updates (B1 = 2 and B3 = 1 per update), ``particle_s2_dual`` (on-policy, from nothing) and
   ``roadway_s2`` with three seeds in lockstep (16 envs, N_eval 10, a
   period of 100 episodes; budgets ``RD_*`` below) through
   ``runner.train_function`` / ``train_multiseed``, each with B1's
   launch count set to 0 just before and read just after.  Each run's
   episodes per second and its last row's ``n_bad``/``n_good``.
13. the single-env cells through the runner (the K-chunk schedule,
   ``chunks_per_sync`` = 32, ``train/offpolicy.py``): B1 (the actor's
   launch; both critics' in one) and B3 under the device predicate 0, 1
   and none against their plain versions bit for bit at the Checkers
   sizes; card against CPU after one K = 6 dispatch across the fill ->
   train boundary at full width (``checkers_s2_e1``'s settings, phase
   3's tolerance); one K = 32 dispatch across that boundary under
   ``torch.cuda.set_sync_debug_mode("error")`` (no host sync) on the
   optax path, the fused path with the actor frozen and QMIX; then the
   paper's ``checkers_s2_e1`` (grafted from a short stage 1 of its own)
   at its settings (n_envs 1, K = 32, N_eval 10, a period of 100
   episodes, a fill of 50; the episodes cut, ``E1_*`` below) through
   ``runner.train_function``, its episodes per second and host syncs
   per episode; ``checkers_s2_e1`` at K = 1 and at K = 32 in turns,
   50 episodes each (about 5 dispatches at K = 32); a
   fused ``checkers_s2_e1`` with the actor frozen for 20 updates, with
   B1's and B3's launch counts set to 0 just before and read just
   after (B1 twice and B3 once per computed update, gated or not); and
   ``checkers_qmix_e1`` (from nothing) through one ``python -m
   cm3_tpu_torch.train.runner`` process.
14. the tools: the paper's ``checkers_s2`` at full width (16 envs,
   N_eval 10, a period of 100 episodes, fused, the actor frozen for 20
   updates; grafted from a stage-1 checkpoint of fresh parameters; 200
   episodes, ``TL_EPISODES``) through ``runner.train_function`` with
   ``summarize`` and again without, deterministic cuDNN, B1's and B3's
   launches counted in each (the snapshots add 2 and 1 each): the
   state and the CSV rows equal at phase 3's tolerance; the event file
   decoded here (``read_events``: each record's length and data CRC
   checked with a CRC32C of its own, the Events' steps, tags, scalar
   values and histogram counts), every histogram's count its leaf's
   size, the tags those of the same run on the CPU (one update a chunk,
   one period); a snapshot's seconds and a period's writer seconds
   (one seed, three seeds); three seeds in lockstep with summaries (100
   episodes each): three event files that decode; ``--render-only``
   through one ``python -m cm3_tpu_torch.train.runner`` process from
   the first run's ``model_final`` (two SVGs, each parsed as XML with
   an ``<animate>``) and one particle and one roadway episode through
   ``render_episodes``; the live viewer on 127.0.0.1 (``/list`` names
   the SVGs, ``..`` and a symlink out of the root get 404); roadway
   with ``occlusion=True`` on the card against the CPU over 42 filtered
   steps of 256 instances (the shadows exactly, every value within
   1e-5), ``avg_speeds``, ``count_remaining`` and ``global_tensor``
   alike.
15. shard-local replay and the MPE suite: card against CPU (phase 3's
   tolerance) after a fill and a training chunk of phase 2's program
   with the replay in 4 shards (each update's indices per shard, below
   its fill) and after roadway's dual chunk with both memories in 2
   shards, one seed and three; the paper's ``checkers_s2`` (phase 9's
   settings, grafted from a stage-1 checkpoint of fresh parameters; 100
   episodes) with ``replay_shards`` 4 and 1 in turns through
   ``runner.train_function``, its episodes per second, B1's and B3's
   launches counted in the sharded run (its main path: 2 and 1 an
   update); one K = 32 dispatch of 4 envs in 4 shards under
   ``set_sync_debug_mode("error")``; ``roadway_s2`` (grafted, dual
   buffer) with ``replay_shards`` 2, 100 episodes, its row's
   ``n_bad``/``n_good`` (summed over the shards); and each of the nine
   MPE scenarios (``envs/mpe.py``) at 65,536 instances for 25 steps on
   the index path and on the multi-head path, timed (env-steps/s), then
   again with every step of the first 4,096 instances repeated on the
   CPU from the card's state before it with the same draws: state,
   observations and rewards at rtol / atol 1e-5, a collision flag that
   differs accepted only within 1e-5 of its threshold, |d - (s_i +
   s_j)| (the observations and rewards of such an instance are then
   not compared at that step).
16. multi-process runs (``cm3_tpu_torch/parallel/``): phase 2's program
   (fused) with the replay in 2 shards over two ranks sharing the card,
   each a process of its own (``chip_smoke.py --mp-rank``) joined over
   gloo with CUDA tensors (NCCL refuses two ranks on one GPU), placed
   with ``mesh.shard_driver_state``: 128 envs and B = 64 a rank, the
   learner replicated, each backward's gradient all-reduced; after 2
   fill and 2 training chunks the ranks' states the same bytes and
   equal to the single-process run on the card at phase 3's tolerance,
   B1's launches and the collectives counted (2 an update each), a
   rank's chunk ms and the bytes an update all-reduces; stage 1 with 2
   seeds over the two ranks (``train_vmapped_seeds(mesh=)``, 64 envs a
   seed, two period rows of 64 episodes after a fill of 64, deterministic
   cuDNN): rows the same on both ranks and equal to the single-process
   2-seed run's, each rank's seed equal to its twin there (at rtol 1e-3 /
   atol 1e-4: stacks of 1 and 2 seeds sum their grouped convolutions in
   other orders, which drift over the run; the witness, with no mesh: a
   one-seed stack against a two-seed stack of one seed, state and draw
   stream, held at that tolerance, while a rank's seed against its
   neighbour's twin and against its own untrained state must fail it);
   then at world
   size 1 over NCCL in this process (a TCP store on a free local port)
   the one-ring program with the mesh equal to it without, bit for bit
   under deterministic cuDNN, and a training chunk with and without the
   mesh timed in turns (the cost of the collectives at W = 1).

Prints a ``kernels`` JSON line (the flat updates' ``ms``, ``plain_ms``
and ``library_ms`` are device times after a PyTorch kernel; B1's the
mean of the main path's two launches; B1's ``launches`` are phase 2's,
B3's phase 9's, its training path: the actor freeze on the fused path;
beside them ``particle_onpolicy_launches``, phase 11's fused stage 2,
``roadway_launches``, phase 12's fused roadway stage 2, and
``kchunk_launches``, phase 13's fused single-env run,
``shards_launches``, phase 15's sharded ``checkers_s2``, and
``multiprocess_launches``, phase 16's on one of two ranks; ``pred_ms``,
the kernel's time under a device predicate of 1; and B1's
``wrapper_ms``, ``adam_polyak_many``'s device time after a PyTorch
kernel as the update calls it, and ``wrapper_b2b_ms``, its time per
call back to back, the host's dispatch included),
the card's name and power limit,
and last ``{"ok": true, "device": {...}}``.  Any failure raises and exits
non-zero; without a CUDA device, or without the package beside it, it
exits non-zero and prints no result.  Writes nothing into the checkout
but the kernel library under ``build/``.
"""

import json
import os
import statistics
import subprocess
import sys
import time

sys.dont_write_bytecode = True

SEED = 0
N_ENVS, BATCH, BUFFER, STEPS, UPDATES = 256, 128, 20000, 10, 8
TRAIN_CHUNKS = 10
EPSILON = 0.2
MAIN_SIZES = {"actor": 149645, "Q_global": 144741, "Q_credit": 144709}
RAGGED = (1, 3, 1000, 8193)
LR, TAU = 1e-3, 0.01
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, float32 non-tensor FLOP/s
HBM_BPS, F32_FLOPS = 3.35e12, 67e12
# Adam + Polyak per element: 5 float32 loads + 4 stores; 16 float32
# operations (mu' 3, nu' 4, the update 4 with a quotient or a root as one,
# p' 2, tgt' 3)
BYTES_PER_ELEM, OPS_PER_ELEM = 36, 16
# the buffer sets a cold-cache graph rotates over: > 2.5x the 50 MB L2
COLD_BYTES = 128 << 20
# card vs CPU after one training chunk: float32 sums in other orders
# (cuDNN/cuBLAS vs CPU kernels, TF32 off) through 8 Adam steps; atol is
# 1% of one Adam step at lr_Q = 1e-3
PARITY_RTOL, PARITY_ATOL = 1e-4, 1e-5
# the fused rollout: bench.py's size, the checks' sizes, the operations
# one step of one instance needs (two agents, Philox; itemized in the note
# of cm3_tpu_torch/ops/checkers_rollout.py: 33 Philox + 2 x 20 per agent
# + 13 per step) and the issue rate (warp-instructions per clock per SM;
# 32 threads a warp)
FUSED_B, FUSED_T, FUSED_REPS = 1 << 20, 8192, 3
FED_B, FED_T, PRNG_B, PRNG_T, PLAIN_T = (1 << 16) + 37, 300, 1 << 14, 300, 64
ROLLOUT_OPS_PER_STEP = 86
WARP_INSTS_PER_CLOCK = 4
# kernel vs plain: the same float32 adds in the same order (in practice
# equal)
ROLLOUT_ATOL = 1e-5
POLYAK_SIZES, POLYAK_TAUS = (1, 3, 1000, 8193, 149645), (0.0, 0.01, 1.0)
# Polyak per element: load t and m, store t; 2 products and a sum
POLYAK_BYTES_PER_ELEM, POLYAK_OPS_PER_ELEM = 12, 3
# the fused particle and roadway rollouts: bench.py's size, the checks'
# sizes, and the work of one call as itemized in the notes of
# cm3_tpu_torch/ops/particle_rollout.py (N = 4) and
# cm3_tpu_torch/ops/roadway_rollout.py (N = 2): per occurrence of each
# item, (operations issued, of them on the special-function unit, MUFU,
# 16 lanes per clock per SM).  "step" occurs B x T times, "reset" once
# per episode, the others as often as the plain version's observer counts
# them at the timed call's inputs.
SOA_B, SOA_T, SOA_REPS = 1 << 20, 2048, 3
SOA_FED_B, SOA_FED_T, SOA_PRNG_B, SOA_PRNG_T = (1 << 16) + 37, 100, 8192, 200
PARTICLE_WORK = {"step": (293, 4), "near_pair": (64, 4), "reset": (17, 0)}
ROADWAY_WORK = {"step": (50, 0), "live_car": (62, 0), "live_pair": (42, 0),
                "ttc_candidate": (13, 1), "rejected_draw": (3, 0),
                "goal_reward": (15, 1), "reset": (10, 0)}
MUFU_LANES_PER_CLOCK = 16
# the kernel against the plain version on the CPU: episodes exactly;
# reward sums at JAX's own tolerance between its particle kernel and its
# scan, since PyTorch's CPU exp and log1p are other approximations than
# CUDA's (the run prints whether they are bit-equal).  On the card the
# kernel is held to its plain version as in phase 4.
SOA_CPU_TOL = (1e-5, 1e-3)          # rtol, atol
# a particle start within contact range: adjacent agents 0.29 apart
# (inside dmin = 0.3), diagonal ones 0.41 apart (at the kernel's far
# threshold, dmin + 0.11), so that contact terms and pairs at the
# threshold are common
PARTICLE_NEAR = dict(agents_x=(-0.145, 0.145, -0.145, 0.145),
                     agents_y=(-0.145, -0.145, 0.145, 0.145),
                     prob_random=0.0, initial_std=0.0)
WARP = 32
# graph timings taken in turns: kernel, yardstick, yardstick, kernel, so
# many times over
TURNS = 3
# the PyTorch kernel that an "after" graph puts before every timed call
FOREIGN_N = 1 << 16
FLOAT32_SCOPE_ENTRIES = 20000
# three seeds in lockstep, card against CPU (phase 3)
PAR_SEEDS, PAR_ENVS, PAR_BATCH, PAR_UPDATES = 3, 8, 32, 4
# seed-batched training (phase 8): bench.py's headline sizes; blocks of
# chunks taken in turns with the one-seed program
SEEDS, BLOCKS, BLOCK_CHUNKS = 16, 5, 10
# stage 1 through train_vmapped_seeds: 3 seeds x 256 envs, episodes of
# at most 33 steps, a period row at 100 episodes and every 100 after
STAGE1_SEEDS, STAGE1_EPISODES = 3, 500
# the curriculum through the runner (phase 9): the paper's checkers_s1 /
# checkers_s2 / checkers_s2_V cells (16 envs, N_eval 10, a period of 100
# episodes) with episode budgets cut to the phase's time: stage 1 200
# episodes (the runner alone, then OffPolicyDriver.run alone), stage 2
# 200 with the actor frozen for its first 20 updates, the resume to 400,
# 3 seeds in lockstep 200 each, the V ablation 200, the CLI 100
CURR_ENVS, CURR_N_EVAL = 16, 10
CURR_S1, CURR_S2, CURR_RESUME, CURR_SEEDS, CURR_SEEDED = 200, 200, 400, 3, 200
CURR_V, CURR_CLI, CURR_FREEZE = 200, 100, 20
# the baselines and QMIX (phase 10): (alg_name, AlgConfig options) of the
# six configurations held card against CPU, their metrics, and the paper
# cells' episode budgets cut to the phase's time (the paper's runs are
# 50,000 episodes): each cell 150, the COMA seeds 200 each, the QMIX
# resume to 400
OTHER_CONFIGS = {
    "qmix": ("qmix", {}), "qmix_ref": ("qmix", dict(qmix_ref_bug=True)),
    "coma": ("coma", dict(use_Q=True)),
    "iac": ("iac", dict(use_V=True, IAC=True)),
    "central_v": ("coma", dict(use_V=True)),
    "blend": ("coma", dict(use_Q=True, use_V=True)),
}
CELL_METRICS = {"qmix": ("loss_mixer",), "coma": ("loss_Q", "policy_loss"),
                "iac": ("loss_V", "policy_loss")}
CELL_EPISODES, CELL_SEEDED, CELL_RESUME = 150, 200, 400
# particle through the runner (phase 11): the paper's particle_s1,
# particle_s2, particle_s2_V, particle_coma and particle_qmix cells and an
# IAC run (16 envs, N_eval 10, a period of 100 episodes; the paper's runs
# are 50,000 episodes) with episode budgets cut to the phase's time: stage
# 1 300, stage 2 300, the fused stage 2 (actor frozen for its first 20
# updates) 200, the V ablation, COMA, IAC and QMIX 200 each, 3 seeds in
# lockstep 200 each, the resume 100 (an on-policy resume restarts its
# count), the CLI 100.  The full widths: master.json's "nn" (the actor
# 14,789 floats at four agents, Q_global 16,704, Q_credit 15,296)
PT_S1, PT_S2, PT_FUSED, PT_CELL, PT_SEEDED, PT_RESUME = (300, 300, 200, 200,
                                                        200, 100)
PT_FREEZE = 20
PT_SIZES = {"actor": 14789, "Q_global": 16704, "Q_credit": 15296}
# card vs CPU on particle: E envs, B-row samples, one burst of the
# reference's 24 updates (on-policy) or a chunk of 4 updates (QMIX)
PT_PAR_ENVS, PT_PAR_BATCH, PT_PAR_EPOCHS, PT_PAR_UPDATES = 16, 128, 24, 4

# roadway and the dual buffer through the runner (phase 12): the paper's
# roadway_s1 (through the CLI), roadway_s2 (grafted, dual buffer),
# roadway_s2_stable (grad_clip 10), roadway_qmix, a fused roadway_s2 (the
# actor frozen for its first 20 updates), roadway_s2 with 3 seeds in
# lockstep and particle_s2_dual (on-policy, from nothing) (16 envs, N_eval
# 10, a period of 100 episodes; the paper's runs are 50,000 episodes) with
# episode budgets cut to the phase's time
RD_S1, RD_S2, RD_CELL, RD_SEEDED, RD_FREEZE = 150, 150, 100, 100, 20
# card vs CPU with the dual buffer: E envs, B-row samples, updates a
# chunk; a short road at top speed (episodes of 4-6 steps) and a slab of
# 3 transitions, so that episodes end inside chunks and lose their tails
RD_PAR_ENVS, RD_PAR_BATCH, RD_PAR_UPDATES, RD_SLAB = 16, 128, 4, 3

# the single-env cells through the runner (phase 13): the paper's
# checkers_s2_e1 and checkers_qmix_e1 (n_envs 1, K = 32 chunks per host
# sync, N_eval 10, a period of 100 episodes, a fill of 50; the paper's
# runs are 50,000 episodes) with the episodes cut to the phase's time
# (one env runs 4.3-5 episodes/s on an H100, and a K = 32 dispatch ~10
# episodes of ~33 steps): checkers_s2_e1 200 episodes (from a stage 1
# of 100 at 16 envs), checkers_qmix_e1 200 through the CLI,
# checkers_s2_e1 at K = 1 and K = 32 in turns 50 each without a fill
# (every chunk trains, at K = 1 as at K = 32), a fused checkers_s2_e1
# with the actor frozen for its first 20 updates 20 without a fill
E1_K, E1_PERIOD, E1_FILL, E1_S1, E1_CELL = 32, 100, 50, 100, 200
E1_TURN, E1_TURN_FILL, E1_FREEZE_RUN, E1_FREEZE = 50, 0, 20, 20

# the tools (phase 14): the paper's checkers_s2 (16 envs, N_eval 10, a
# period of 100 episodes, fused, the actor frozen for its first 20
# updates) with summaries, 200 episodes (and the same without), and three
# seeds in lockstep with summaries, 100 episodes each
TL_EPISODES, TL_SEEDED = 200, 100

# shard-local replay and MPE (phase 15): the plain ring in 4 shards
# (Checkers, card vs CPU at phase 2's sizes; checkers_s2 through the
# runner, 100 episodes, in turns with 1 shard; one K = 32 dispatch of 4
# envs), the dual buffer in 2 (roadway card vs CPU; roadway_s2 100
# episodes); the nine MPE scenarios at 65,536 instances for 25 steps a
# path, the first 4,096 held to the CPU one step at a time: float32 at
# rtol / atol 1e-5 (CUDA's expf and log1pf against the CPU's, an ulp
# apart, in the contact force and the boundary penalty), a collision
# flag that differs accepted within 1e-5 of its threshold
SH_SHARDS, SH_DUAL_SHARDS, SH_EPISODES = 4, 2, 100
MPE_B, MPE_STEPS, MPE_CHECK = 1 << 16, 25, 4096
MPE_RTOL, MPE_ATOL, MPE_COLL_TOL = 1e-5, 1e-5, 1e-5

# multi-process runs (phase 16): phase 2's program (fused, 256 envs, 10
# env steps then 8 updates on B = 128, buffer 20000) with the replay in 2
# shards over two ranks sharing the card (gloo with CUDA tensors: NCCL
# refuses two ranks on one GPU; 128 envs and B = 64 a rank), 2 fill and
# MP_HOLD training chunks held against the single-process run, then
# MP_TIMED timed ones; stage 1 with 2 seeds over the ranks (64 envs a
# seed, a fill of 64 episodes, two period rows of 64: few updates, so
# that seed stacks of 1 and 2, whose grouped convolutions sum in other
# orders, stay within phase 3's tolerance); and at world size 1 over NCCL
# the one-ring program with the mesh and without it, MP_TURNS training
# chunks each in turns
MP_SHARDS, MP_HOLD, MP_TIMED, MP_TURNS, MP_RANK_TIMEOUT = 2, 2, 4, 5, 50
MP_SEEDS, MP_SEED_ENVS, MP_SEED_PERIOD = 2, 64, 64
# a rank's seed against its twin in the single-process run: a stack of 1
# seed and one of 2 run their grouped convolutions in other orders, which
# drift apart over the run's ~30 updates.  On an H100 (700 W) under
# deterministic cuDNN the rank reads 2.08e-5 from its twin, and a
# one-seed stack reads the same 2.08e-5 from a two-seed stack of the same
# seed with no mesh; a wrong rank reads 0.518 (its neighbour's twin) and
# 0.0192 (its own seed untrained).  The limit lies between (the rows are
# held at phase 3's tolerance)
MP_SEED_RTOL, MP_SEED_ATOL = 1e-3, 1e-4

T0 = time.time()


def log(msg):
    print(msg, flush=True)


def run_phase(name, budget_s, fn, *args):
    """Run one phase between two progress lines; fail it if it takes
    more than its share of the time a cold run may take."""
    t0 = time.time()
    log(f"phase {name} (budget {budget_s} s) starts at {t0 - T0:.1f} s")
    out = fn(*args)
    took = time.time() - t0
    log(f"phase {name} took {took:.1f} s")
    if took > budget_s:
        raise RuntimeError(f"phase {name} took {took:.1f} s, over its "
                           f"{budget_s} s budget")
    return out


def smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0] if out else "unknown"


def cuda_time_ms(fn, iters, warmup=20):
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_time_ms(fn, per_graph=50, replays=20):
    """Device time per call: ``per_graph`` calls captured in one CUDA
    graph, replayed ``replays`` times, timed by CUDA events.  No host
    dispatch between the kernels."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(per_graph):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * per_graph)


def rotation(make, set_bytes):
    """A call for a cold-cache graph: it rotates over ``COLD_BYTES`` /
    ``set_bytes`` independent buffer sets (``make()`` returns a call on a
    fresh set), so every set is touched again only after more than twice
    the L2's bytes have passed; and the calls per graph, a multiple of
    the sets, so that the rotation runs on unbroken across replays.
    Returns (call, per_graph)."""
    k = -(-COLD_BYTES // set_bytes)
    calls = [make() for _ in range(k)]
    turn = [0]

    def call():
        calls[turn[0] % k]()
        turn[0] += 1
    return call, k * -(-50 // k)


def graph_turns(*fns):
    """Device times per call in CUDA graphs, taken in turns (forward,
    then backward: A, B, B, A) ``TURNS`` times; each fn is a call or
    (call, calls per graph).  A list of ms per fn."""
    fns = [f if isinstance(f, tuple) else (f, 50) for f in fns]
    out = [[] for _ in fns]
    for _ in range(TURNS):
        for i in list(range(len(fns))) + list(reversed(range(len(fns)))):
            out[i].append(graph_time_ms(fns[i][0], per_graph=fns[i][1]))
    return out


def us_spread(ms):
    """Median and range of times in ms, printed in us."""
    return (f"{statistics.median(ms) * 1e3:.2f} us ({min(ms) * 1e3:.2f}-"
            f"{max(ms) * 1e3:.2f})")


def log_flat_occupancy(mod):
    o = mod.occupancy()
    log(f"  {mod.__name__.rsplit('.', 1)[-1]} kernel: {o['registers']} "
        f"registers per thread, {o['blocks_per_sm']} resident blocks of "
        f"{o['threads']} threads per SM, {o['local_bytes']} bytes of local "
        "memory per thread")


def flat_bound(n, bytes_per, ops_per):
    """The least time of a stream over n floats: (ms, "bytes" or
    "operations"), the larger of its bytes at the HBM rate and its
    operations at the float32 rate."""
    by_bytes = bytes_per * n / HBM_BPS * 1e3
    by_ops = ops_per * n / F32_FLOPS * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                           "operations")


def assert_bit_equal(pairs, what):
    """Holds each (kernel, plain) pair equal bit for bit; returns the
    largest absolute difference over all pairs (0.0 when they hold)."""
    import torch
    torch.cuda.synchronize()
    err = 0.0
    for got, want in pairs:
        diff = float((got - want).abs().max()) if got.numel() else 0.0
        assert torch.equal(got, want), (
            f"{what}: kernel != plain on {int((got != want).sum())} of "
            f"{got.numel()} floats, max abs difference {diff:.3g}")
        err = max(err, diff)
    return err


def after_pytorch(dev):
    """(foreign, after): ``foreign`` launches one PyTorch kernel (an add
    over ``FOREIGN_N`` floats of its own), and ``after(fn)`` is a call of
    ``foreign`` then ``fn``, so that in a CUDA graph every launch of
    ``fn`` follows a PyTorch kernel, as a flat update follows the
    backward pass on the main path."""
    import torch
    x = torch.zeros(FOREIGN_N, device=dev)
    foreign = lambda: x.add_(1.0)

    def after(fn):
        return lambda: (foreign(), fn())
    return foreign, after


# ------------------------------------------------------------------ #
# phase 1
# ------------------------------------------------------------------ #


def adam_net(dev, gen, n, count=0, off=0):
    """(opt_state, params, tgt, grads) over n floats on the card, each
    buffer ``off`` floats into its allocation; moments as after some
    steps."""
    import torch
    from cm3_tpu_torch.algs import common

    def mk(scale=1.0):
        x = torch.zeros(n + off, device=dev)
        x[off:] = scale * torch.randn(n, device=dev, generator=gen)
        return x[off:]
    st = common.AdamState(mu=mk(1e-3), nu=mk(1e-3).square_(), count=count)
    return st, mk(), mk(), mk(1e-3)


def hold_adam(dev, gen, spec, steps=5):
    """``adam_polyak_many`` over the networks of ``spec`` ((n, step
    count, lr, offset) each) in one launch per step, against the plain
    version per network on the same inputs, fresh gradients each step:
    bit for bit (rtol 0, atol 0)."""
    from cm3_tpu_torch.algs import common
    from cm3_tpu_torch.ops import fused_opt

    nets = [adam_net(dev, gen, n, count, off) for n, count, _, off in spec]
    ref = [(common.AdamState(st.mu.clone(), st.nu.clone(), st.count),
            p.clone(), t.clone()) for st, p, t, _ in nets]
    lrs = [lr for _, _, lr, _ in spec]
    for _ in range(steps):
        for _, _, _, g in nets:
            g.normal_(generator=gen).mul_(1e-3)
        fused_opt.adam_polyak_many([(st, p, t, g, lr) for (st, p, t, g), lr
                                    in zip(nets, lrs)], TAU)
        for (rst, rp, rt), (*_, g), lr in zip(ref, nets, lrs):
            fused_opt.adam_polyak_plain(rp, rt, rst.mu, rst.nu, g,
                                        *fused_opt.bias_corrections(rst.count),
                                        lr, TAU)
            rst.count += 1
    err = assert_bit_equal([(a, b) for (st, p, t, _), (rst, rp, rt) in
                            zip(nets, ref) for a, b in ((p, rp), (t, rt),
                                                        (st.mu, rst.mu),
                                                        (st.nu, rst.nu))],
                           f"adam_polyak {spec}")
    assert all(st.count == rst.count == count + steps for (st, *_), (rst, *_),
               (_, count, _, _) in zip(nets, ref, spec))
    return err


def adam_call(nets, pred=None):
    """One launch of the kernel over ``nets`` (from ``adam_net``) as
    ``adam_polyak_many`` makes it, each segment reading its step count
    from device memory and writing the advanced count to a tensor of its
    own (made once here, where the wrapper makes new ones at every call)
    under the bool device predicate ``pred`` (or none): the C entry
    alone, for timing."""
    import torch
    from cm3_tpu_torch.ops import _nvcc, fused_opt
    items = [(st, p, t, g, LR) for st, p, t, g in nets]
    counts = torch.zeros(len(nets), dtype=torch.int32,
                         device=nets[0][1].device).unbind()
    args = fused_opt.c_args(items, counts, pred, TAU)
    lib = _nvcc.library()
    _nvcc.check(lib.cm3_adam_polyak(
        *args, torch.cuda.current_stream().cuda_stream), "adam_polyak")
    # the closure holds every buffer whose pointer the launch passes
    return lambda: (items, counts, pred, lib.cm3_adam_polyak(
        *args, torch.cuda.current_stream().cuda_stream))


def after_ms(pairs, alone):
    """The device time a call adds after a PyTorch kernel: the median of
    (PyTorch kernel, call) pairs less the median of the PyTorch kernel
    alone, both in CUDA graphs."""
    return statistics.median(pairs) - statistics.median(alone)


def adam_times(dev, gen, name, sizes):
    """One launch over the networks of ``sizes`` at the main path's
    sizes: back to back; in CUDA graphs warm (in turns with the
    yardstick, ``Adam(fused=True, capturable=True).step`` +
    ``_foreach_lerp_`` over the same networks), each of the two also
    after a PyTorch kernel (``after_pytorch``), cold (rotating buffer
    sets) and at n = 0 (the launch floor); the plain version after a
    PyTorch kernel; the wrapper ``adam_polyak_many`` as the update calls
    it (its new count tensors made at every call), back to back and
    after a PyTorch kernel; the bound.  The returned times are those
    after a PyTorch kernel."""
    import torch
    from cm3_tpu_torch.ops import fused_opt

    nets = [adam_net(dev, gen, n) for n in sizes]
    kern = adam_call(nets)
    one = torch.ones((), dtype=torch.bool, device=dev)
    kern_pred = adam_call(nets, one)
    witems = [(st, p, t, g, LR) for st, p, t, g in
              (adam_net(dev, gen, n) for n in sizes)]
    wrapper = lambda: fused_opt.adam_polyak_many(witems, TAU)
    tiles = [fused_opt.bias_corrections(st.count) for st, *_ in nets]
    plain = lambda: [fused_opt.adam_polyak_plain(
        p, t, st.mu, st.nu, g, c[0], c[1], LR, TAU)
        for (st, p, t, g), c in zip(nets, tiles)]
    lp = [torch.nn.Parameter(p.clone()) for _, p, _, _ in nets]
    for x, (*_, g) in zip(lp, nets):
        x.grad = g.clone()
    lt = [t.clone() for _, _, t, _ in nets]
    opt = torch.optim.Adam(lp, lr=LR, betas=(0.9, 0.999), eps=1e-8,
                           fused=True, capturable=True)

    def library():
        opt.step()
        torch._foreach_lerp_(lt, [x.detach() for x in lp], TAU)

    cold, per_graph = rotation(
        lambda: adam_call([adam_net(dev, gen, n) for n in sizes]),
        BYTES_PER_ELEM * sum(sizes))
    floor = adam_call([adam_net(dev, gen, 0) for _ in sizes])
    foreign, after = after_pytorch(dev)
    b2b, w_b2b = cuda_time_ms(kern, 500), cuda_time_ms(wrapper, 500)
    warm, lib, alone, a_kern, a_lib, a_pred, a_wrap = graph_turns(
        kern, library, foreign, after(kern), after(library), after(kern_pred),
        after(wrapper))
    colds, floors = graph_turns((cold, per_graph), floor)
    a_plain, alone_p = graph_turns(after(plain), foreign)
    kern_ms, lib_ms = after_ms(a_kern, alone), after_ms(a_lib, alone)
    pred_ms, wrap_ms = after_ms(a_pred, alone), after_ms(a_wrap, alone)
    plain_ms = after_ms(a_plain, alone_p)
    bound, bound_by = flat_bound(sum(sizes), BYTES_PER_ELEM, OPS_PER_ELEM)
    med = statistics.median
    log(f"  adam_polyak {name} (n = {' + '.join(map(str, sizes))}, one "
        f"launch, (c1, c2) computed from the device's step count): back to "
        f"back {b2b * 1e3:.2f} us, through the wrapper {w_b2b * 1e3:.2f} "
        f"us; in CUDA graphs (median "
        f"and range of {2 * TURNS}, in turns): warm {us_spread(warm)}, "
        f"library Adam(fused, capturable)+_foreach_lerp_ {us_spread(lib)}; "
        f"after a PyTorch kernel ({us_spread(alone)} alone): kernel "
        f"{kern_ms * 1e3:.2f} us more (pair {us_spread(a_kern)}), with a "
        f"device predicate (1) {pred_ms * 1e3:.2f} us more (pair "
        f"{us_spread(a_pred)}), the wrapper {wrap_ms * 1e3:.2f} us more "
        f"(pair {us_spread(a_wrap)}), library "
        f"{lib_ms * 1e3:.2f} us more (pair {us_spread(a_lib)}), plain "
        f"{plain_ms * 1e3:.2f} us more; cold {us_spread(colds)}, floor "
        f"(n = 0) {us_spread(floors)}; bound {bound * 1e3:.3f} us "
        f"({bound_by}: {BYTES_PER_ELEM} B and {OPS_PER_ELEM} operations x "
        f"{sum(sizes)} at {HBM_BPS / 1e12} TB/s and {F32_FLOPS / 1e12} "
        f"TFLOP/s), share warm {bound / med(warm):.3f}, after a PyTorch "
        f"kernel {bound / kern_ms:.3f}, with the predicate "
        f"{bound / pred_ms:.3f}, cold {bound / med(colds):.3f}")
    return {"ms": kern_ms, "plain_ms": plain_ms, "library_ms": lib_ms,
            "bound_ms": bound, "bound_by": bound_by, "pred_ms": pred_ms,
            "wrapper_ms": wrap_ms, "wrapper_b2b_ms": w_b2b}


def phase_kernel(dev):
    import torch
    from cm3_tpu_torch.ops import fused_opt

    gen = torch.Generator(device=dev).manual_seed(SEED)
    err = max(hold_adam(dev, gen, [(n, 0, LR, 0)])
              for n in list(MAIN_SIZES.values()) + list(RAGGED))
    for off in (1, 2, 3):
        err = max(err, hold_adam(dev, gen, [(MAIN_SIZES["actor"], 0, LR,
                                             off)]),
                  hold_adam(dev, gen, [(8193, 7, LR, off)]))
    # two segments in one launch == two one-segment launches == plain
    spec = [(MAIN_SIZES["Q_global"], 3, LR, 0), (MAIN_SIZES["Q_credit"], 0,
                                                  1e-4, 0)]
    one = [adam_net(dev, gen, n, count) for n, count, _, _ in spec]
    two = [adam_net(dev, gen, n, count) for n, count, _, _ in spec]
    for (st, p, t, g), (st2, p2, t2, g2) in zip(one, two):
        for a, b in ((st.mu, st2.mu), (st.nu, st2.nu), (p, p2), (t, t2),
                     (g, g2)):
            b.copy_(a)
    for _ in range(5):
        fused_opt.adam_polyak_many([(st, p, t, g, lr) for (st, p, t, g),
                                    (_, _, lr, _) in zip(one, spec)], TAU)
        for (st, p, t, g), (_, _, lr, _) in zip(two, spec):
            fused_opt.adam_polyak(st, p, t, g, lr, TAU)
    err = max(err, assert_bit_equal(
        [(a, b) for x, y in zip(one, two) for a, b in
         zip((x[0].mu, x[0].nu, *x[1:3]), (y[0].mu, y[0].nu, *y[1:3]))],
        "two segments in one launch vs one launch each"))
    err = max(err, hold_adam(dev, gen, spec),
              hold_adam(dev, gen, [(8193, 0, LR, 0), (1, 5, 1e-4, 1),
                                   (1000, 17, 3e-3, 2), (3, 999, 1e-2, 3)]))
    log(f"  adam_polyak: kernel == plain bit for bit (rtol 0, atol 0) over 5 "
        f"steps at n in {tuple(MAIN_SIZES.values()) + RAGGED}, on views "
        "offset by 1-3 floats, for two segments in one launch (== two "
        "launches) and for four ragged segments")

    actor = adam_times(dev, gen, "actor", [MAIN_SIZES["actor"]])
    critics = adam_times(dev, gen, "critics",
                         [MAIN_SIZES["Q_global"], MAIN_SIZES["Q_credit"]])
    # the fused seed-batched update hands each [S, n] buffer to the
    # kernel as one segment of S x n floats
    for name, sizes in (("actor", [MAIN_SIZES["actor"]]),
                        ("critics", [MAIN_SIZES["Q_global"],
                                     MAIN_SIZES["Q_credit"]])):
        adam_times(dev, gen, f"{name} x {SEEDS} seeds",
                   [SEEDS * n for n in sizes])
    # one CM3 update's optimizer tail: two launches (the main path) against
    # three one-network launches, warm and cold
    def update(launches):
        """A CM3 update's optimizer tail on fresh networks of the main
        sizes: two launches (actor; both critics) or three."""
        nets = {k: adam_net(dev, gen, n) for k, n in MAIN_SIZES.items()}
        if launches == 2:
            calls = [adam_call([nets["actor"]]),
                     adam_call([nets["Q_global"], nets["Q_credit"]])]
        else:
            calls = [adam_call([net]) for net in nets.values()]
        return lambda: [call() for call in calls]

    update_bytes = BYTES_PER_ELEM * sum(MAIN_SIZES.values())
    w2, w3 = graph_turns(update(2), update(3))
    c2, c3 = graph_turns(rotation(lambda: update(2), update_bytes),
                         rotation(lambda: update(3), update_bytes))
    bound, bound_by = flat_bound(sum(MAIN_SIZES.values()), BYTES_PER_ELEM,
                                 OPS_PER_ELEM)
    log(f"  adam_polyak per CM3 update, in CUDA graphs in turns: two launches "
        f"(actor; both critics) warm {us_spread(w2)}, cold {us_spread(c2)}; "
        f"three one-network launches warm {us_spread(w3)}, cold "
        f"{us_spread(c3)}; bound {bound * 1e3:.3f} us ({bound_by}), share of "
        f"the two launches warm {bound / statistics.median(w2):.3f}, cold "
        f"{bound / statistics.median(c2):.3f}")
    log_flat_occupancy(fused_opt)
    mean = lambda k: (actor[k] + critics[k]) / 2
    return {"max_abs_err": err, "bound_by": bound_by,
            **{k: mean(k) for k in ("ms", "plain_ms", "library_ms",
                                    "bound_ms", "pred_ms", "wrapper_ms",
                                    "wrapper_b2b_ms")}}


# ------------------------------------------------------------------ #
# the slice
# ------------------------------------------------------------------ #


def build(device):
    """The one-seed training program at full width on the fused path
    (``cm3_tpu_torch.bench.train_program``): (driver, CM3 state, replay,
    rollout state)."""
    from cm3_tpu_torch import bench
    return bench.train_program(None, N_ENVS, True, device, seed=SEED)[:4]


def _finite(ts, buf, metrics):
    import torch
    from cm3_tpu_torch.core.tree import tree_leaves
    for name in ("actor", "actor_tgt", "qg", "qg_tgt", "qc", "qc_tgt"):
        assert torch.isfinite(getattr(ts, name).flat).all(), name
    for name in ("opt_actor", "opt_qg", "opt_qc"):
        o = getattr(ts, name)
        assert torch.isfinite(o.mu).all() and torch.isfinite(o.nu).all(), name
    for path, x in tree_leaves(buf.data):
        if x.is_floating_point():
            assert torch.isfinite(x).all(), path
    for k, v in metrics.items():
        assert torch.isfinite(v), k


def phase_slice(device):
    import torch
    from cm3_tpu_torch.core import prng
    from cm3_tpu_torch.ops import fused_opt

    driver, ts, buf, rs = build(device)
    draws = prng.GeneratorDraws(prng.generator(
        prng.for_purpose(prng.root_key(SEED), prng.ROLLOUT), device))
    for _ in range(2):
        ts, buf, rs, _ = driver._chunk(ts, buf, rs, EPSILON, draws, False,
                                       True)
    torch.cuda.synchronize()
    fused_opt.adam_polyak.launches = 0
    times, per_chunk = [], []
    for _ in range(TRAIN_CHUNKS):
        before = fused_opt.adam_polyak.launches
        t0 = time.perf_counter()
        ts, buf, rs, metrics = driver._chunk(ts, buf, rs, EPSILON, draws,
                                             True, False)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        per_chunk.append(fused_opt.adam_polyak.launches - before)
    launches = fused_opt.adam_polyak.launches
    assert per_chunk == [2 * UPDATES] * TRAIN_CHUNKS, (
        f"adam_polyak launches per training chunk: {per_chunk}")
    _finite(ts, buf, metrics)
    assert buf.size == min((2 + TRAIN_CHUNKS) * STEPS * N_ENVS, BUFFER)
    assert ts.step == UPDATES * TRAIN_CHUNKS
    episodes = int(rs.episodes)
    assert episodes > 0
    steady = statistics.median(times[1:])
    from cm3_tpu_torch.models import nets
    t0 = time.perf_counter()
    for _ in range(FLOAT32_SCOPE_ENTRIES):
        with nets.full_float32():
            pass
    scope_ms = (time.perf_counter() - t0) / FLOAT32_SCOPE_ENTRIES * 1e3
    log(f"  full-float32 scope of the nets: {scope_ms * 1e3:.2f} us per entry "
        f"on the host; {STEPS + UPDATES} entries per training chunk = "
        f"{(STEPS + UPDATES) * scope_ms:.4f} ms, "
        f"{(STEPS + UPDATES) * scope_ms / (steady * 1e3):.5f} of the median "
        "chunk")
    log(f"  {TRAIN_CHUNKS} training chunks: first {times[0] * 1e3:.1f} ms, "
        f"median of the rest {steady * 1e3:.2f} ms "
        f"(min {min(times[1:]) * 1e3:.2f}, max {max(times[1:]) * 1e3:.2f}); "
        f"{N_ENVS * STEPS / steady:.0f} env-steps/s; "
        f"{launches} adam_polyak launches ({launches // TRAIN_CHUNKS} per "
        f"chunk); {episodes} episodes; losses "
        + ", ".join(f"{k} {float(v):.4f}" for k, v in metrics.items()))
    return launches


# ------------------------------------------------------------------ #
# card vs CPU
# ------------------------------------------------------------------ #


def phase_parity(device):
    import numpy as np
    import torch
    from cm3_tpu_torch.core import prng
    from cm3_tpu_torch.core.tree import tree_leaves

    rng = np.random.default_rng(SEED + 1)
    fill = [rng.integers(0, 5, (N_ENVS, 2)) for _ in range(STEPS)]
    act = [rng.gumbel(size=(N_ENVS, 2, 5)).astype(np.float32)
           for _ in range(STEPS)]
    size = 2 * STEPS * N_ENVS
    idx = [rng.integers(0, size, BATCH) for _ in range(UPDATES)]
    upd = [rng.gumbel(size=(BATCH, 2, 5)).astype(np.float32)
           for _ in range(UPDATES)]
    out = {}
    for dev in (device, "cpu"):
        driver, ts, buf, rs = build(dev)
        draws = prng.FedDraws(fill + idx, act + upd, device=dev)
        ts, buf, rs, _ = driver._chunk(ts, buf, rs, EPSILON, draws, False,
                                       True)
        ts, buf, rs, m = driver._chunk(ts, buf, rs, EPSILON, draws, True,
                                       False)
        assert draws.remaining() == {"randint": 0, "gumbel": 0}
        out[dev] = (ts, buf, rs, m)
    (ts_c, buf_c, rs_c, m_c), (ts_h, buf_h, rs_h, m_h) = out[device], \
        out["cpu"]
    worst = {}
    for name in ("actor", "actor_tgt", "qg", "qg_tgt", "qc", "qc_tgt"):
        pairs = [(getattr(ts_c, name).flat, getattr(ts_h, name).flat)]
        if not name.endswith("_tgt"):
            o_c, o_h = getattr(ts_c, "opt_" + name), getattr(ts_h,
                                                              "opt_" + name)
            pairs += [(o_c.mu, o_h.mu), (o_c.nu, o_h.nu)]
        for got, want in pairs:
            torch.testing.assert_close(got.cpu(), want, rtol=PARITY_RTOL,
                                       atol=PARITY_ATOL)
        worst[name] = max(float((g.cpu() - w).abs().max()) for g, w in pairs)
    for (path, x), (_, y) in zip(tree_leaves(buf_c.data),
                                 tree_leaves(buf_h.data)):
        if x.is_floating_point():
            torch.testing.assert_close(x.cpu(), y, rtol=PARITY_RTOL,
                                       atol=PARITY_ATOL)
        else:
            assert torch.equal(x.cpu(), y), path
    for k in m_h:
        torch.testing.assert_close(m_c[k].cpu(), m_h[k], rtol=PARITY_RTOL,
                                   atol=PARITY_ATOL)
    assert int(rs_c.episodes) == int(rs_h.episodes)
    log("  card == CPU after a fill and a training chunk (rtol "
        f"{PARITY_RTOL}, atol {PARITY_ATOL}); max abs differences: "
        + ", ".join(f"{k} {v:.3g}" for k, v in worst.items()))
    for n_agents in (2, 1):
        seeded_parity(device, n_agents)


def seeded_parity(device, n_agents):
    """Three seeds in lockstep, one fill and one training chunk (optax
    path, the nets at full width) on the card and on the CPU from the
    same parameters with the same fed draws; the largest differences."""
    import numpy as np
    import torch
    from cm3_tpu_torch.algs.cm3 import CM3
    from cm3_tpu_torch.core import config, prng
    from cm3_tpu_torch.core.tree import tree_leaves
    from cm3_tpu_torch.envs.checkers import Checkers
    from cm3_tpu_torch.train.experiments import make_hooks
    from cm3_tpu_torch.train.offpolicy import OffPolicyDriver, init_rollout

    s, e, b, u = PAR_SEEDS, PAR_ENVS, PAR_BATCH, PAR_UPDATES
    rng = np.random.default_rng(SEED + n_agents)
    goals = lambda: [rng.integers(0, 2, (s, e))] if n_agents == 1 else []
    start = goals()
    fill, act = [], []
    for _ in range(STEPS):
        fill += [rng.integers(0, 5, (s, e, n_agents))] + goals()
        act.append(rng.gumbel(size=(s, e, n_agents, 5)).astype(np.float32))
    train = sum((goals() for _ in range(STEPS)), [])
    idx = [rng.integers(0, 2 * STEPS * e, (s, b)) for _ in range(u)]
    upd = [rng.gumbel(size=(s, b, n_agents, 5)).astype(np.float32)
           for _ in range(u)]
    eps = torch.tensor([0.1, 0.2, 0.3])
    out = {}
    for dev in (device, "cpu"):
        env = Checkers(config.checkers_env_config(n_agents, max_steps=7),
                       device=dev)
        alg = CM3("checkers", env.spec(),
                  config.AlgConfig(n_agents=n_agents, stage=n_agents),
                  config.checkers_nn_config(n_agents), device=dev,
                  n_seeds=s)
        cfg = config.TrainConfig(n_envs=e, batch_size=b, buffer_size=512,
                                 steps_per_train=STEPS,
                                 updates_per_chunk=u, episode_log=16)
        driver = OffPolicyDriver(make_hooks("checkers", env), alg, cfg)
        rs = init_rollout(driver.hooks, e, prng.FedDraws(start, device=dev),
                          16, n_seeds=s)
        ts = alg.init_state([prng.root_key(SEED + i) for i in range(s)])
        buf = driver._replay_init(driver.example_transition(rs))
        draws = prng.FedDraws(fill + train + idx, act + upd, device=dev)
        ts, buf, rs, _ = driver._chunk(ts, buf, rs, eps, draws, False, True)
        ts, buf, rs, m = driver._chunk(ts, buf, rs, eps, draws, True, False)
        assert draws.remaining() == {"randint": 0, "gumbel": 0}
        out[str(dev)] = (ts, buf, rs, m)
    (ts_c, buf_c, rs_c, m_c), (ts_h, buf_h, rs_h, m_h) = out[str(device)], \
        out["cpu"]
    names = ["actor", "actor_tgt", "qg", "qg_tgt"] + (
        ["qc", "qc_tgt"] if n_agents > 1 else [])
    pairs = [(getattr(ts_c, k).flat, getattr(ts_h, k).flat) for k in names]
    pairs += [(getattr(ts_c, "opt_" + k).mu, getattr(ts_h, "opt_" + k).mu)
              for k in names[::2]]
    pairs += [(x, y) for (_, x), (_, y) in zip(tree_leaves(buf_c.data),
                                               tree_leaves(buf_h.data))]
    pairs += [(getattr(rs_c, k), getattr(rs_h, k))
              for k in ("episodes", "eplog", "eplog_ep", "acc_ret_local")]
    pairs += [(m_c[k], m_h[k]) for k in m_h]
    worst = 0.0
    for got, want in pairs:
        torch.testing.assert_close(got.cpu(), want, rtol=PARITY_RTOL,
                                   atol=PARITY_ATOL)
        if got.numel():
            worst = max(worst, float((got.cpu().double()
                                      - want.double()).abs().max()))
    assert ts_c.actor.flat.shape[0] == s and int(rs_h.episodes.min()) > 0
    log(f"  {s} seeds in lockstep, stage {n_agents} ({n_agents} "
        f"agent{'s' if n_agents > 1 else ''}), optax: card == "
        f"CPU after a fill and a training chunk (rtol {PARITY_RTOL}, atol "
        f"{PARITY_ATOL}); max abs difference {worst:.3g}; losses "
        + ", ".join(f"{k} {m_c[k].tolist()}" for k in m_c))


# ------------------------------------------------------------------ #
# seed-batched training
# ------------------------------------------------------------------ #


def phase_seeded(dev):
    import numpy as np
    import torch
    from cm3_tpu_torch import bench
    from cm3_tpu_torch.algs.cm3 import CM3
    from cm3_tpu_torch.core import config
    from cm3_tpu_torch.envs.checkers import Checkers
    from cm3_tpu_torch.ops import fused_opt
    from cm3_tpu_torch.train.experiments import make_hooks
    from cm3_tpu_torch.train.multiseed import train_vmapped_seeds

    # the headline program and the one-seed program, blocks in turns
    multi = list(bench.train_program(SEEDS, N_ENVS, False, dev, seed=SEED))
    single = list(bench.train_program(None, N_ENVS, False, dev, seed=SEED))
    bench.train_blocks(multi, 0, 0)
    bench.train_blocks(single, 0, 0)
    rates = {id(multi): [], id(single): []}
    for b in range(BLOCKS):
        for prog in ((multi, single) if b % 2 == 0 else (single, multi)):
            rates[id(prog)] += bench.train_blocks(prog, BLOCK_CHUNKS, 1, 0)
    med = statistics.median
    m_rates, s_rates = rates[id(multi)], rates[id(single)]
    ts = multi[1]
    for name in ("actor", "qg", "qc"):
        assert torch.isfinite(getattr(ts, name).flat).all(), name
    assert ts.actor.flat.shape[0] == SEEDS
    assert ts.step == UPDATES * (3 + BLOCKS * BLOCK_CHUNKS)
    headline = {"train_env_steps_per_s": med(m_rates), "lo": min(m_rates),
                "hi": max(m_rates)}
    log(f"  {SEEDS} seeds x {N_ENVS} envs, optax, {BLOCKS} blocks of "
        f"{BLOCK_CHUNKS} chunks in turns with one seed: "
        + json.dumps(headline))
    log(f"  one seed x {N_ENVS} envs, the same program: median "
        f"{med(s_rates):.0f} env-steps/s (lo {min(s_rates):.0f}, hi "
        f"{max(s_rates):.0f}); the seeds' gain "
        f"{med(m_rates) / med(s_rates):.2f}x; chunk medians "
        f"{SEEDS * N_ENVS * STEPS / med(m_rates) * 1e3:.2f} ms and "
        f"{N_ENVS * STEPS / med(s_rates) * 1e3:.2f} ms")
    del multi, single

    # the fused path at 16 seeds: the kernel twice per update
    fused = list(bench.train_program(SEEDS, N_ENVS, True, dev, seed=SEED))
    bench.train_blocks(fused, 0, 0, warmup=1)
    per_chunk = []
    torch.cuda.synchronize()
    fused_opt.adam_polyak.launches = 0
    for _ in range(3):
        before = fused_opt.adam_polyak.launches
        rate = bench.train_blocks(fused, 1, 1, 0)[0]
        per_chunk.append(fused_opt.adam_polyak.launches - before)
    assert per_chunk == [2 * UPDATES] * 3, per_chunk
    log(f"  {SEEDS} seeds x {N_ENVS} envs, fused optimizer: "
        f"{per_chunk[0]} adam_polyak launches per chunk (segments of "
        f"{SEEDS} x {fused[1].actor.flat.shape[1]} and {SEEDS} x "
        f"{fused[1].qg.flat.shape[1]} + {SEEDS} x "
        f"{fused[1].qc.flat.shape[1]} floats); last chunk {rate:.0f} "
        "env-steps/s")
    del fused

    # stage 1 (one agent) through train_vmapped_seeds
    env = Checkers(config.checkers_env_config(1, max_steps=33), device=dev)
    alg = CM3("checkers", env.spec(), config.AlgConfig(n_agents=1, stage=1),
              config.checkers_nn_config(1), device=dev)
    cfg = config.TrainConfig(n_envs=N_ENVS, updates_per_chunk=UPDATES,
                             N_train=STAGE1_EPISODES, max_steps=33)
    t0 = time.time()
    ts, history = train_vmapped_seeds(make_hooks("checkers", env), alg, cfg,
                                      STAGE1_SEEDS, SEED)
    assert history, "no period row"
    for row in history:
        for k in ("r_eval_local", "r_eval_global", "r_train_local"):
            assert np.isfinite(row[k]).all(), (k, row[k])
        log(f"  stage 1, {STAGE1_SEEDS} seeds x {N_ENVS} envs: episode "
            f"{row['episode'].tolist()}, epsilon "
            f"{np.round(row['epsilon'], 4).tolist()}, r_eval_global "
            f"{np.round(row['r_eval_global'], 3).tolist()}, r_train_global "
            f"{np.round(row['r_train_global'], 3).tolist()}"
            + (f", loss_Q_global {np.round(row['loss_Q_global'], 4).tolist()}"
               if "loss_Q_global" in row else ""))
    log(f"  stage 1 run: {len(history)} period rows in "
        f"{time.time() - t0:.1f} s")
    return headline


# ------------------------------------------------------------------ #
# the curriculum through the runner
# ------------------------------------------------------------------ #


def _curriculum_masters():
    """master.json with the paper's checkers_s1 / checkers_s2 /
    checkers_s2_V settings (scripts/reproduce_paper.py:153-161,
    448-452) at their period of 100 episodes."""
    from cm3_tpu_torch.core import config
    m = config.load_json("master.json")
    m.update(experiment="checkers", n_envs=CURR_ENVS, N_eval=CURR_N_EVAL,
             period=100)
    s1 = dict(m, stage=1, dir_name="ck_s1", N_train=CURR_S1)
    s2 = dict(m, stage=2, dir_name="ck_s2", dir_restore="ck_s1",
              train_from_nothing=0, N_train=CURR_S2, fused_opt=1,
              actor_freeze_updates=CURR_FREEZE)
    s2v = dict(m, stage=2, dir_name="ck_s2V", dir_restore="ck_s1",
               train_from_nothing=0, N_train=CURR_V, use_Q_credit=0,
               use_V=1)
    return s1, s2, s2v


def _rows(wd, d):
    with open(os.path.join(wd, "log", d, "log_century.csv")) as f:
        return f.read().strip().splitlines()[1:]


def _hold_graft(st, s1):
    """The shared leaves of the grafted actor and Q_global equal stage
    1's bit for bit, Q_credit's equal Q_global's, targets equal mains."""
    import torch
    from cm3_tpu_torch.train import checkpoint
    n = 0
    for net, src in ((st.actor, s1.actor), (st.qg, s1.qg), (st.qc, st.qg)):
        views = checkpoint.named_views(src)
        for name, v in checkpoint.named_views(net).items():
            if "stage2" not in name.split("."):
                assert torch.equal(v, views[name]), name
                n += v.numel()
    for name in ("actor", "qg", "qc"):
        assert torch.equal(getattr(st, name).flat,
                           getattr(st, name + "_tgt").flat), name
    return n


def _timed_run(what, fn, episodes_from=0):
    t0 = time.time()
    out = fn()
    wall = time.time() - t0
    stats = out[1]
    done = (stats["episodes"] if isinstance(stats, dict)
            else int(stats[-1]["episode"].sum()))
    rate = (done - episodes_from) / wall
    log(f"  {what}: {done} episodes in {wall:.2f} s, {rate:.1f} episodes/s")
    return out, wall


def phase_curriculum(dev):
    import tempfile
    import numpy as np
    import torch
    from cm3_tpu_torch.core import prng
    from cm3_tpu_torch.ops import fused_opt, polyak
    from cm3_tpu_torch.train import checkpoint, runner
    from cm3_tpu_torch.train.logging import CSVLogger

    s1, s2, s2v = _curriculum_masters()
    with tempfile.TemporaryDirectory() as wd:
        # 1. stage 1 (optax) through the runner and through
        # OffPolicyDriver.run alone, the same program from the same seed,
        # in turns: runner, driver, driver, runner (the last run's files
        # are the ones stage 2 restores)
        def alone():
            driver, _, _, _, ts = runner.initial_state(s1, wd, dev)
            return driver.run(ts, prng.root_key(s1["seed"]),
                              n_episodes=CURR_S1)

        walls = {"runner": [], "driver": []}
        for who in ("runner", "driver", "driver", "runner"):
            (ts1, st1), wall = _timed_run(
                f"stage 1 through {'train_function' if who == 'runner' else 'OffPolicyDriver.run alone'}",
                (lambda: runner.train_function(s1, wd, verbose=False,
                                               device=dev))
                if who == "runner" else alone)
            walls[who].append(wall)
        rows1 = _rows(wd, "ck_s1")
        assert len(rows1) == len(st1["history"]) >= 1
        for f in ("log_century.csv", "log.csv", "metrics.jsonl"):
            assert os.path.isfile(os.path.join(wd, "log", "ck_s1", f)), f
        assert checkpoint.exists(os.path.join(wd, "saved", "ck_s1",
                                              "model_final"))
        periods = len(st1["history"])
        wall1, wall_d = sum(walls["runner"]) / 2, sum(walls["driver"]) / 2
        log(f"  stage 1: {int(ts1.step)} updates, {st1['episodes']} episodes, "
            f"{len(st1['history'])} period rows")
        log(f"  the runner's overhead: {wall1 - wall_d:.3f} s a run of "
            f"{periods} periods (means of 2 in turns: {wall1:.2f} against "
            f"{wall_d:.2f} s), {(wall1 - wall_d) / periods:.3f} s a period "
            "(build, logs, autosave)")

        # 2. stage 2 grafted from stage 1: the grafted state held first
        _, alg2, _, _, g = runner.initial_state(s2, wd, dev)
        shared = _hold_graft(g, ts1)
        log(f"  graft: {shared} shared floats equal stage 1's bit for bit, "
            "Q_credit's shared leaves equal Q_global's, targets equal "
            "mains (on the card)")
        torch.cuda.synchronize()
        fused_opt.adam_polyak.launches = 0
        polyak.polyak_update.launches = 0
        (ts2, st2), _ = _timed_run(
            "stage 2 (fused, the actor frozen for its first "
            f"{CURR_FREEZE} updates), train_function",
            lambda: runner.train_function(s2, wd, verbose=False,
                                          device=dev))
        b1, b3 = fused_opt.adam_polyak.launches, polyak.polyak_update.launches
        steps = int(ts2.step)
        frozen = min(CURR_FREEZE, steps)
        log(f"  stage 2: {steps} updates; adam_polyak {b1} launches, "
            f"polyak {b3} launches ({frozen} frozen updates; both under "
            "the device's freeze predicates at every update)")
        assert b1 == 2 * steps and b1 > 0, b1
        assert b3 == steps > frozen > 0, b3
        for name in ("actor", "qg", "qc"):
            assert torch.isfinite(getattr(ts2, name).flat).all(), name

        # the autosave and a period's CSV writes, timed alone
        path = os.path.join(wd, "autosave_timing")
        times = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            checkpoint.save(path, {"ts": ts2, "episodes": st2["episodes"]})
            times.append(time.perf_counter() - t0)
        size = os.path.getsize(os.path.join(path, checkpoint.FILE))
        row = dict(st2["history"][-1])
        eps = row.pop("_episodes", None)
        logger = CSVLogger(os.path.join(wd, "log", "timing"), 2)
        t0 = time.perf_counter()
        for _ in range(20):
            if eps is not None:
                logger.log_episodes(*eps)
            logger.log_period(row)
        csv_s = (time.perf_counter() - t0) / 20
        log(f"  stage-2 autosave: {size} bytes, "
            f"{statistics.median(times):.4f} s (median of 5; "
            f"{min(times):.4f}-{max(times):.4f}); a period's CSV and JSONL "
            f"writes ({0 if eps is None else len(eps[0])} episode rows): "
            f"{csv_s * 1e3:.3f} ms")

        # 3. the same stage 2 resumed from its autosave, to a larger budget
        auto = os.path.join(wd, "saved", "ck_s2", "model_autosave")
        start = checkpoint.restore(auto, {"ts": alg2.empty_state(),
                                          "episodes": 0})["episodes"]
        before = len(_rows(wd, "ck_s2"))
        (ts3, st3), _ = _timed_run(
            f"stage 2 resumed from its autosave at episode {start}",
            lambda: runner.train_function(
                dict(s2, auto_resume=1, require_resume=1,
                     N_train=CURR_RESUME), wd, verbose=False, device=dev),
            start)
        first = st3["history"][0]["episode"]
        assert first // 100 > start // 100 and st3["episodes"] >= CURR_RESUME
        assert len(_rows(wd, "ck_s2")) == before + len(st3["history"])
        log(f"  resume: started at episode {start} (the autosave's), first "
            f"period row at {first}, {int(ts3.step - ts2.step)} more updates")

        # 4. three seeds in lockstep, the stage-2 graft into every seed
        sv = dict(s2, dir_name="ck_s2_seeds", vmapped_seeds=1,
                  n_seeds=CURR_SEEDS, N_train=CURR_SEEDED)
        _, alg1, _, _ = runner.build(sv, device=dev)
        stack = runner.vmapped_resume(sv, wd, alg1, alg1.for_seeds(
            CURR_SEEDS), dev)[0]
        for i in range(CURR_SEEDS):
            _hold_graft(checkpoint.seed_state(alg1, stack, i), ts1)
        (ts4, hist4), _ = _timed_run(
            f"{CURR_SEEDS} seeds in lockstep (vmapped_seeds), stage 2 "
            "grafted into each", lambda: runner.train_multiseed(
                sv, wd, device=dev))
        assert (hist4[-1]["episode"] >= CURR_SEEDED).all() and ts4.step > 0
        assert not torch.equal(ts4.actor.flat[0], ts4.actor.flat[1])
        for i in range(CURR_SEEDS):
            assert checkpoint.exists(os.path.join(
                wd, "saved", f"ck_s2_seeds_{i + 1}", "model_final"))
            assert len(_rows(wd, f"ck_s2_seeds_{i + 1}")) == len(hist4)
        log(f"  seeds: all {CURR_SEEDS} grafted, rows "
            + ", ".join(str(r["episode"].tolist()) for r in hist4))

        # 5. the V ablation (checkers_s2_V), two periods
        (ts5, st5), _ = _timed_run(
            "checkers_s2_V (use_Q_credit 0, use_V 1)",
            lambda: runner.train_function(s2v, wd, verbose=False,
                                          device=dev))
        assert ts5.qc is None and ts5.v is not None
        assert len(st5["history"]) >= 2
        assert np.isfinite([r["loss_V"] for r in st5["history"]]).all()

        # 6. the CLI in a process of its own
        cfg = os.path.join(wd, "cli_master.json")
        with open(cfg, "w") as f:
            json.dump(dict(s1, dir_name="cli"), f)
        t0 = time.time()
        proc = subprocess.run(
            [sys.executable, "-m", "cm3_tpu_torch.train.runner", "--config",
             cfg, "--episodes", str(CURR_CLI), "--workdir", wd],
            cwd=os.path.dirname(os.path.abspath(__file__)),
            env=dict(os.environ, PYTHONDONTWRITEBYTECODE="1"),
            capture_output=True, text=True, timeout=300)
        wall6 = time.time() - t0
        assert proc.returncode == 0, proc.stderr[-2000:]
        rows6 = _rows(wd, "cli")
        assert rows6, "the CLI wrote no period row"
        log(f"  CLI: python -m cm3_tpu_torch.train.runner --episodes "
            f"{CURR_CLI} exited 0 in {wall6:.2f} s with {len(rows6)} period "
            f"rows; its last: {proc.stdout.strip().splitlines()[-1]}")
    return b3


# ------------------------------------------------------------------ #
# the baselines and QMIX
# ------------------------------------------------------------------ #


def other_parity(device, name, n_seeds=None):
    """One fill and one training chunk of the algorithm of
    ``OTHER_CONFIGS[name]`` (full widths, 2 agents) on the card and on
    the CPU from the same seeded state with the same fed draws; their
    states, replay, rollout and metrics held at phase 3's tolerance.
    Returns the largest difference."""
    import numpy as np
    import torch
    from cm3_tpu_torch.algs.baseline import Baseline
    from cm3_tpu_torch.algs.qmix import QMIX
    from cm3_tpu_torch.core import config, prng
    from cm3_tpu_torch.core.tree import tree_leaves
    from cm3_tpu_torch.envs.checkers import Checkers
    from cm3_tpu_torch.train.experiments import make_hooks
    from cm3_tpu_torch.train.offpolicy import OffPolicyDriver, init_rollout

    alg_name, opts = OTHER_CONFIGS[name]
    qmix = alg_name == "qmix"
    e, b, u = PAR_ENVS, PAR_BATCH, PAR_UPDATES
    lead = () if n_seeds is None else (n_seeds,)
    rng = np.random.default_rng(SEED + len(name))
    fill = [rng.integers(0, 5, lead + (e, 2)) for _ in range(STEPS)]
    act, unif = [], []
    for _ in range(STEPS):
        if qmix:
            act.append(rng.integers(0, 5, lead + (e, 2)))
            unif.append(rng.random(lead + (e, 2)).astype(np.float32))
        else:
            act.append(rng.gumbel(size=lead + (e, 2, 5)).astype(np.float32))
    idx = [rng.integers(0, 2 * STEPS * e, lead + (b,)) for _ in range(u)]
    upd = [] if qmix else [rng.gumbel(size=lead + (b, 2, 5)).astype(
        np.float32) for _ in range(u)]
    eps = (torch.tensor([0.1, 0.2, 0.3])[:n_seeds] if n_seeds else 0.3)
    out = {}
    for dev in (str(device), "cpu"):
        env = Checkers(config.checkers_env_config(2, max_steps=7),
                       device=dev)
        cls = QMIX if qmix else Baseline
        alg = cls("checkers", env.spec(),
                  config.AlgConfig(n_agents=2, stage=2, alg_name=alg_name,
                                   **opts),
                  config.checkers_nn_config(2), device=dev, n_seeds=n_seeds)
        cfg = config.TrainConfig(n_envs=e, batch_size=b, buffer_size=512,
                                 steps_per_train=STEPS, updates_per_chunk=u,
                                 episode_log=16)
        driver = OffPolicyDriver(make_hooks("checkers", env), alg, cfg)
        rs = init_rollout(driver.hooks, e, None, 16, n_seeds=n_seeds)
        ts = alg.init_state(prng.root_key(SEED) if n_seeds is None else
                            [prng.root_key(SEED + i) for i in range(n_seeds)])
        buf = driver._replay_init(driver.example_transition(rs))
        if qmix:
            draws = prng.FedDraws(fill + act + idx, device=dev,
                                  uniforms=unif)
        else:
            draws = prng.FedDraws(fill + idx, act + upd, device=dev)
        ts, buf, rs, _ = driver._chunk(ts, buf, rs, eps, draws, False, True)
        ts, buf, rs, m = driver._chunk(ts, buf, rs, eps, draws, True, False)
        assert not any(draws.remaining().values()), draws.remaining()
        out[dev] = (alg, ts, buf, rs, m)
    (alg, ts_c, buf_c, rs_c, m_c), (_, ts_h, buf_h, rs_h, m_h) = \
        out[str(device)], out["cpu"]
    pairs = []
    for k in alg.net_names():
        pairs += [(getattr(ts_c, k).flat, getattr(ts_h, k).flat),
                  (getattr(ts_c, k + "_tgt").flat,
                   getattr(ts_h, k + "_tgt").flat),
                  (getattr(ts_c, "opt_" + k).mu, getattr(ts_h, "opt_" + k).mu)]
    pairs += [(x, y) for (_, x), (_, y) in zip(tree_leaves(buf_c.data),
                                               tree_leaves(buf_h.data))]
    pairs += [(getattr(rs_c, k), getattr(rs_h, k))
              for k in ("episodes", "eplog", "acc_ret_local")]
    pairs += [(m_c[k], m_h[k]) for k in m_h]
    worst = 0.0
    for got, want in pairs:
        torch.testing.assert_close(got.cpu(), want, rtol=PARITY_RTOL,
                                   atol=PARITY_ATOL)
        if got.numel():
            worst = max(worst, float((got.cpu().double()
                                      - want.double()).abs().max()))
    assert ts_c.step == u and int(rs_h.episodes.min()) > 0
    want = (("loss_mixer",) if qmix else
            ("loss_V",) * alg.use_v + ("loss_Q",) * alg.use_q
            + ("policy_loss",))
    assert tuple(m_h) == want, (tuple(m_h), want)
    log(f"  {name}{'' if n_seeds is None else f', {n_seeds} seeds'}: card "
        f"== CPU after a fill and a training chunk (rtol {PARITY_RTOL}, "
        f"atol {PARITY_ATOL}); max abs difference {worst:.3g}; "
        + ", ".join(f"{k} {np.round(m_c[k].cpu().numpy(), 4).tolist()}"
                    for k in m_c))
    return worst


def _cell_masters():
    """master.json with the paper's checkers_qmix, checkers_qmix_ref,
    checkers_coma and checkers_iac settings
    (scripts/reproduce_paper.py:216-237: 16 envs, N_eval 10, stage 2
    from nothing) at a period of 100 episodes, and CM3's checkers_s2
    settings from nothing (the same program without the graft) to run
    in turns with them."""
    from cm3_tpu_torch.core import config
    m = config.load_json("master.json")
    m.update(experiment="checkers", stage=2, n_envs=CURR_ENVS,
             N_eval=CURR_N_EVAL, period=100, train_from_nothing=1,
             N_train=CELL_EPISODES)
    cells = {
        "checkers_qmix": dict(m, alg_name="qmix", dir_name="ck_qmix"),
        "checkers_qmix_ref": dict(m, alg_name="qmix", qmix_ref_bug=1,
                                  dir_name="ck_qmixb"),
        "checkers_coma": dict(m, alg_name="coma", dir_name="ck_coma"),
        "checkers_iac": dict(m, alg_name="iac", dir_name="ck_iac"),
    }
    return cells, dict(m, alg_name="cm3", dir_name="ck_s2")


def phase_baselines(dev):
    import tempfile
    import numpy as np
    import torch
    from cm3_tpu_torch.ops import fused_opt
    from cm3_tpu_torch.train import checkpoint, runner

    # 1. card against CPU: the six configurations, QMIX and COMA also
    # with three seeds in lockstep
    worst = {}
    for name in OTHER_CONFIGS:
        worst[name] = other_parity(dev, name)
    for name in ("qmix", "coma"):
        worst[name + "_seeds"] = other_parity(dev, name, PAR_SEEDS)

    cells, cm3 = _cell_masters()
    rates = {}
    with tempfile.TemporaryDirectory() as wd:
        # 2. the four paper cells through train_function, in turns with
        # CM3's stage 2: CM3, QMIX, QMIX-ref, CM3, COMA, IAC, CM3
        order = ["cm3", "checkers_qmix", "checkers_qmix_ref", "cm3",
                 "checkers_coma", "checkers_iac", "cm3"]
        for who in order:
            m = cm3 if who == "cm3" else cells[who]
            torch.cuda.synchronize()
            fused_opt.adam_polyak.launches = 0
            (ts, st), wall = _timed_run(
                f"{who} (alg_name {m['alg_name']}), train_function",
                lambda: runner.train_function(m, wd, verbose=False,
                                              device=dev))
            b1 = fused_opt.adam_polyak.launches
            assert b1 == 0, (who, b1)
            assert st["episodes"] >= CELL_EPISODES and ts.step > 0
            rows = st["history"]
            assert rows and all(np.isfinite(r["r_eval_local"]).all()
                                for r in rows)
            for k in CELL_METRICS.get(m["alg_name"], ()):
                assert np.isfinite([r[k] for r in rows]).all(), k
            rates.setdefault(who, []).append(st["episodes"] / wall)
            log(f"  {who}: {int(ts.step)} updates, adam_polyak {b1} launches, "
                f"last row episode {rows[-1]['episode']}, r_eval_global "
                f"{rows[-1]['r_eval_global']:.3f}")
        cm3_rate = statistics.mean(rates["cm3"])
        log("  episodes/s (one run each; CM3 stage 2 the mean of its "
            f"{len(rates['cm3'])} runs in turns, "
            + ", ".join(f"{r:.1f}" for r in rates["cm3"]) + "): "
            + json.dumps({k: round(v[0], 2) for k, v in rates.items()
                          if k != "cm3"} | {"cm3_stage2": round(cm3_rate,
                                                                2)}))

        # 3. checkers_coma with three seeds in lockstep
        sv = dict(cells["checkers_coma"], dir_name="ck_coma_seeds",
                  vmapped_seeds=1, n_seeds=PAR_SEEDS, N_train=CELL_SEEDED)
        fused_opt.adam_polyak.launches = 0
        (ts4, hist4), _ = _timed_run(
            f"checkers_coma, {PAR_SEEDS} seeds in lockstep (vmapped_seeds)",
            lambda: runner.train_multiseed(sv, wd, device=dev))
        assert fused_opt.adam_polyak.launches == 0
        assert (hist4[-1]["episode"] >= CELL_SEEDED).all() and ts4.step > 0
        assert not torch.equal(ts4.q.flat[0], ts4.q.flat[1])
        for i in range(PAR_SEEDS):
            assert checkpoint.exists(os.path.join(
                wd, "saved", f"ck_coma_seeds_{i + 1}", "model_final"))
        log(f"  coma seeds: rows " + ", ".join(
            str(r["episode"].tolist()) for r in hist4)
            + f"; loss_Q {np.round(hist4[-1]['loss_Q'], 4).tolist()}")

        # 4. QMIX resumed from its autosave to a larger budget
        q = cells["checkers_qmix"]
        auto = os.path.join(wd, "saved", q["dir_name"], "model_autosave")
        alg = runner.build(q, device=dev)[1]
        start = checkpoint.restore(auto, {"ts": alg.empty_state(),
                                          "episodes": 0})
        (ts5, st5), _ = _timed_run(
            f"checkers_qmix resumed from its autosave at episode "
            f"{start['episodes']}",
            lambda: runner.train_function(
                dict(q, auto_resume=1, require_resume=1,
                     N_train=CELL_RESUME), wd, verbose=False, device=dev),
            start["episodes"])
        period = q["period"]
        assert (st5["history"][0]["episode"] // period
                > start["episodes"] // period)
        assert ts5.opt_qmix.count > start["ts"].opt_qmix.count > 0
        assert st5["episodes"] >= CELL_RESUME

        # 5. the CLI with --alg qmix in a process of its own
        cfg = os.path.join(wd, "cli_master.json")
        with open(cfg, "w") as f:
            json.dump(dict(q, alg_name="cm3", dir_name="cli_qmix"), f)
        t0 = time.time()
        proc = subprocess.run(
            [sys.executable, "-m", "cm3_tpu_torch.train.runner", "--config",
             cfg, "--alg", "qmix", "--episodes", str(CURR_CLI),
             "--workdir", wd],
            cwd=os.path.dirname(os.path.abspath(__file__)),
            env=dict(os.environ, PYTHONDONTWRITEBYTECODE="1"),
            capture_output=True, text=True, timeout=300)
        assert proc.returncode == 0, proc.stderr[-2000:]
        rows = _rows(wd, "cli_qmix")
        assert rows, "the CLI wrote no period row"
        log(f"  CLI: python -m cm3_tpu_torch.train.runner --alg qmix "
            f"--episodes {CURR_CLI} exited 0 in {time.time() - t0:.2f} s "
            f"with {len(rows)} period rows; its last: "
            f"{proc.stdout.strip().splitlines()[-1]}")
    return worst


# ------------------------------------------------------------------ #
# particle through the runner
# ------------------------------------------------------------------ #


class _ParticleFeed:
    """Seeded numpy draws in the order a particle driver asks for them,
    kind by kind: per env step the actions (random, Gumbel noise, or
    QMIX's random action and uniform) then the reset's four draws for
    every instance; per update the replay indices and the a' noise."""

    def __init__(self, seed, lead, n=4, a=5, qmix=False):
        import numpy as np
        self.rng = np.random.default_rng(seed)
        self.lead, self.n, self.a, self.qmix = tuple(lead), n, a, qmix
        self.q = {"randint": [], "gumbel": [], "uniform": [], "normal": []}

    def reset(self, e):
        import numpy as np
        r, pts = self.rng, self.lead + (e, self.n, 2)
        f32 = lambda x: x.astype(np.float32)
        self.q["uniform"] += [f32(r.random(self.lead + (e,))),
                              f32(r.uniform(-1, 1, pts)),
                              f32(r.uniform(-1, 1, pts))]
        self.q["normal"].append(f32(r.normal(size=pts)))

    def step(self, e, random_actions):
        import numpy as np
        shape = self.lead + (e, self.n)
        if random_actions or self.qmix:
            self.q["randint"].append(self.rng.integers(0, self.a, shape))
        if self.qmix and not random_actions:
            self.q["uniform"].append(self.rng.random(shape).astype(
                np.float32))
        if not (random_actions or self.qmix):
            self.q["gumbel"].append(self.rng.gumbel(
                size=shape + (self.a,)).astype(np.float32))
        self.reset(e)

    def update(self, b, size=None, shards=1):
        """One update's draws: the replay indices below ``size``, or with
        the dual buffer (``size`` None) the two memories' indices as
        large integers that ``_ModDraws`` takes modulo each fill, per
        shard ([D, b/D]) with ``shards``."""
        import numpy as np
        if size is None:
            idx = (b,) if shards == 1 else (shards, b // shards)
            for _ in range(2):
                self.q["randint"].append(self.rng.integers(
                    0, 1 << 40, self.lead + idx))
        else:
            self.q["randint"].append(self.rng.integers(0, size,
                                                       self.lead + (b,)))
        if not self.qmix:
            self.q["gumbel"].append(self.rng.gumbel(
                size=self.lead + (b, self.n, self.a)).astype(np.float32))

    def fed(self, dev):
        return _mod_draws()(self.q["randint"], self.q["gumbel"],
                            device=dev, uniforms=self.q["uniform"],
                            normals=self.q["normal"])


class _RoadwayFeed(_ParticleFeed):
    """``_ParticleFeed`` for roadway (two cars): the reset draws the
    branch uniform, the lanes, the goal lanes and the depart noise."""

    def __init__(self, seed, lead, qmix=False):
        super().__init__(seed, lead, n=2, qmix=qmix)

    def reset(self, e):
        import numpy as np
        r, cars = self.rng, self.lead + (e, self.n)
        self.q["uniform"].append(r.random(self.lead + (e,)).astype(
            np.float32))
        self.q["randint"] += [r.integers(0, 4, cars), r.integers(0, 4, cars)]
        self.q["normal"].append(r.normal(size=cars).astype(np.float32))


def _mod_draws():
    """A ``FedDraws`` whose draws below a device bound are the fed
    integers modulo the bound: the dual buffer's fills, which are the
    same on the card and on the CPU while the two runs agree."""
    import torch
    from cm3_tpu_torch.core import prng

    class ModDraws(prng.FedDraws):
        def randint_below(self, shape, high):
            x = self._next("randint", shape, torch.int64).to(self.device)
            return torch.remainder(x, high[..., None])
    return ModDraws


def particle_parity(device, kind, n_seeds=None):
    """Four-agent particle (stage 2, antipodal; episodes of 7 steps) at
    full width on the card and on the CPU from the same seeded state
    with the same fed draws: for ``kind`` "cm3" (on-policy; the fused
    optimizer for one seed, optax for seeds) a fill chunk, a policy
    chunk and a burst of 24 updates; for "qmix" (off-policy) a fill
    chunk and a training chunk of 4 updates.  States, replay, rollout
    and metrics held at phase 3's tolerance.  Returns (largest
    difference, B1 launches on the card)."""
    import torch
    from cm3_tpu_torch.core import config, prng
    from cm3_tpu_torch.core.tree import tree_leaves
    from cm3_tpu_torch.ops import fused_opt
    from cm3_tpu_torch.train import runner
    from cm3_tpu_torch.train.offpolicy import init_rollout

    e, b, steps = PT_PAR_ENVS, PT_PAR_BATCH, STEPS
    lead = () if n_seeds is None else (n_seeds,)
    qmix = kind == "qmix"
    feed = _ParticleFeed(SEED + 11 + (n_seeds or 0), lead, qmix=qmix)
    feed.reset(e)
    for rand in (True, False):
        for _ in range(steps):
            feed.step(e, rand)
    for _ in range(PT_PAR_UPDATES if qmix else PT_PAR_EPOCHS):
        feed.update(b, 2 * steps * e)
    m = config.load_json("master.json")
    m.update(experiment="particle", particle_config="stage2_antipodal",
             stage=2, n_envs=e, batch_size=b, buffer_size=512, max_steps=7,
             prob_random=0.5, episode_log=16, alg_name=kind,
             fused_opt=int(kind == "cm3" and n_seeds is None),
             updates_per_chunk=PT_PAR_UPDATES)
    eps = torch.tensor([0.1, 0.2, 0.3])[:n_seeds] if n_seeds else 0.3
    out = {}
    for dev in (str(device), "cpu"):
        driver, alg, hooks, cfg = runner.build(m, device=dev)
        if n_seeds is not None:
            alg = alg.for_seeds(n_seeds)
            driver = type(driver)(hooks, alg, cfg)
        draws = feed.fed(dev)
        rs = init_rollout(hooks, e, draws, 16, n_seeds=n_seeds)
        ts = alg.init_state(prng.root_key(SEED) if n_seeds is None else
                            [prng.root_key(SEED + i) for i in range(n_seeds)])
        buf = driver._replay_init(driver.example_transition(rs))
        torch.cuda.synchronize()
        before = fused_opt.adam_polyak.launches
        if qmix:
            ts, buf, rs, _ = driver._chunk(ts, buf, rs, eps, draws, False,
                                           True)
            ts, buf, rs, met = driver._chunk(ts, buf, rs, eps, draws, True,
                                             False)
        else:
            buf, rs = driver._rollout_chunk(ts, buf, rs, eps, draws, True)
            buf, rs = driver._rollout_chunk(ts, buf, rs, eps, draws, False)
            ts, met = driver._train_burst(ts, buf, eps, draws)
        assert not any(draws.remaining().values()), draws.remaining()
        out[dev] = (alg, ts, buf, rs, met,
                    fused_opt.adam_polyak.launches - before)
    (alg, ts_c, buf_c, rs_c, m_c, b1), (_, ts_h, buf_h, rs_h, m_h, _) = \
        out[str(device)], out["cpu"]
    pairs = []
    for k in alg.net_names():
        pairs += [(getattr(ts_c, k).flat, getattr(ts_h, k).flat),
                  (getattr(ts_c, k + "_tgt").flat,
                   getattr(ts_h, k + "_tgt").flat),
                  (getattr(ts_c, "opt_" + k).mu, getattr(ts_h, "opt_" + k).mu),
                  (getattr(ts_c, "opt_" + k).nu, getattr(ts_h, "opt_" + k).nu)]
    pairs += [(x, y) for (_, x), (_, y) in zip(tree_leaves(buf_c.data),
                                               tree_leaves(buf_h.data))]
    pairs += [(getattr(rs_c.env_state, k), getattr(rs_h.env_state, k))
              for k in ("pos", "vel", "landmarks", "collisions")]
    pairs += [(getattr(rs_c, k), getattr(rs_h, k))
              for k in ("episodes", "eplog", "acc_ret_local")]
    pairs += [(m_c[k], m_h[k]) for k in m_h]
    worst = 0.0
    for got, want in pairs:
        torch.testing.assert_close(got.cpu(), want, rtol=PARITY_RTOL,
                                   atol=PARITY_ATOL)
        if got.numel():
            worst = max(worst, float((got.cpu().double()
                                      - want.double()).abs().max()))
    updates = PT_PAR_UPDATES if qmix else PT_PAR_EPOCHS
    assert ts_c.step == updates and int(rs_h.episodes.min()) > 0
    want_b1 = 2 * updates if alg.cfg.fused_opt else 0
    assert b1 == want_b1, (kind, n_seeds, b1, want_b1)
    log(f"  particle {kind}{'' if n_seeds is None else f', {n_seeds} seeds'}"
        f" ({'fused' if alg.cfg.fused_opt else 'optax'}): card == CPU after "
        + ("a fill and a training chunk" if qmix else
           "a fill chunk, a policy chunk and a burst") +
        f" of {updates} updates (rtol {PARITY_RTOL}, atol {PARITY_ATOL}); "
        f"max abs difference {worst:.3g}; adam_polyak {b1} launches; "
        + ", ".join(f"{k} {[round(x, 4) for x in m_c[k].reshape(-1).tolist()]}"
                    for k in m_c))
    return worst, b1


def _particle_masters():
    """master.json with the paper's particle cells
    (scripts/reproduce_paper.py:160-166, 453-475, 558-562: 16 envs,
    N_eval 10), at a period of 100 episodes."""
    from cm3_tpu_torch.core import config
    m = config.load_json("master.json")
    m.update(experiment="particle", n_envs=CURR_ENVS, N_eval=CURR_N_EVAL,
             period=100)
    s1 = dict(m, particle_config="stage1", stage=1, dir_name="pt_s1",
              N_train=PT_S1)
    s2 = dict(m, particle_config="stage2_antipodal", stage=2,
              dir_name="pt_s2", dir_restore="pt_s1", train_from_nothing=0,
              N_train=PT_S2)
    cells = {
        "particle_s2_V": dict(s2, dir_name="pt_s2V", use_Q_credit=0,
                              use_V=1, N_train=PT_CELL),
        "particle_coma": dict(s2, alg_name="coma", dir_name="pt_coma",
                              train_from_nothing=1, N_train=PT_CELL),
        "particle_iac": dict(s2, alg_name="iac", dir_name="pt_iac",
                             train_from_nothing=1, N_train=PT_CELL),
        "particle_qmix": dict(s2, alg_name="qmix", dir_name="pt_qmix",
                              train_from_nothing=1, N_train=PT_CELL),
    }
    fused = dict(s2, dir_name="pt_s2_fused", N_train=PT_FUSED, fused_opt=1,
                 actor_freeze_updates=PT_FREEZE)
    return s1, s2, fused, cells


def _onpolicy_times(stats):
    return (f"t_env {stats['t_env']:.2f} s, t_train {stats['t_train']:.2f} s"
            if "t_env" in stats else "off-policy")


def phase_particle_runner(dev):
    import tempfile
    import numpy as np
    import torch
    from cm3_tpu_torch.ops import fused_opt, polyak
    from cm3_tpu_torch.train import checkpoint, runner

    # 1. card against CPU at full width, one seed and three
    worst = {}
    for kind in ("cm3", "qmix"):
        for s in (None, PAR_SEEDS):
            worst[f"{kind}{'' if s is None else '_seeds'}"] = \
                particle_parity(dev, kind, s)[0]

    # 2. B1 at particle sizes: bit for bit, then its time per launch
    gen = torch.Generator(device=dev).manual_seed(SEED + 12)
    err = max(hold_adam(dev, gen, [(PT_SIZES["actor"], 0, 1e-4, 0)]),
              hold_adam(dev, gen, [(PT_SIZES["Q_global"], 0, LR, 0),
                                   (PT_SIZES["Q_credit"], 0, LR, 0)]))
    log("  adam_polyak at particle sizes: kernel == plain bit for bit over 5 "
        f"steps (max abs difference {err})")
    times = {name: adam_times(dev, gen, f"particle {name}", sizes)
             for name, sizes in (("actor", [PT_SIZES["actor"]]),
                                 ("critics", [PT_SIZES["Q_global"],
                                              PT_SIZES["Q_credit"]]))}

    s1, s2, fused, cells = _particle_masters()
    rates = {}
    with tempfile.TemporaryDirectory() as wd:
        def run(name, m, **kw):
            torch.cuda.synchronize()
            fused_opt.adam_polyak.launches = 0
            polyak.polyak_update.launches = 0
            (ts, st), wall = _timed_run(
                f"{name} ({m.get('alg_name', 'cm3')}), train_function",
                lambda: runner.train_function(m, wd, verbose=False,
                                              device=dev, **kw))
            rates[name] = st["episodes"] / wall
            rows = st["history"]
            assert rows and all(np.isfinite(r["r_eval_local"]).all()
                                for r in rows)
            log(f"    {int(ts.step)} updates, {_onpolicy_times(st)}; last row: "
                f"episode {rows[-1]['episode']}, r_eval_global "
                f"{rows[-1]['r_eval_global']:.3f}, eval_reach_rate "
                f"{rows[-1]['eval_reach_rate']:.3f}; adam_polyak "
                f"{fused_opt.adam_polyak.launches}, polyak "
                f"{polyak.polyak_update.launches} launches")
            return ts, st

        # 3. particle_s1 from nothing, then its graft into stage 2 held
        ts1, _ = run("particle_s1", s1)
        assert fused_opt.adam_polyak.launches == 0
        _, _, _, _, g = runner.initial_state(s2, wd, dev)
        shared = _hold_graft(g, ts1)
        log(f"  graft: {shared} shared floats equal stage 1's bit for bit "
            "(stage 1: one agent; stage 2: four), Q_credit's shared leaves "
            "equal Q_global's, targets equal mains (on the card)")

        # 4. particle_s2 (the paper's cell: optax), the fused stage 2 with
        # the actor frozen, and the V ablation
        ts2, st2 = run("particle_s2", s2)
        assert fused_opt.adam_polyak.launches == 0
        tsf, _ = run(f"particle_s2, fused, actor frozen {PT_FREEZE} updates",
                     fused)
        b1, b3 = fused_opt.adam_polyak.launches, polyak.polyak_update.launches
        steps = int(tsf.step)
        frozen = min(PT_FREEZE, steps)
        assert b1 == 2 * steps and b1 > 0, (b1, steps)
        assert b3 == steps > frozen > 0, b3
        log(f"  fused stage 2: {steps} updates ({frozen} frozen), "
            f"adam_polyak {b1} launches = 2 x {steps}, polyak {b3} = "
            f"{steps} (the freeze predicates at every update)")

        # 5. the V ablation, COMA, IAC (on-policy) and QMIX (off-policy)
        for name, m in cells.items():
            ts, st = run(name, m)
            assert fused_opt.adam_polyak.launches == 0, name
            if name == "particle_s2_V":
                assert ts.qc is None and ts.v is not None
            if name == "particle_qmix":
                assert "loss_mixer" in st["history"][-1]
            else:
                assert "t_env" in st and "policy_loss" not in \
                    st["history"][-1]

        # 6. three seeds in lockstep with the graft into every seed
        sv = dict(s2, dir_name="pt_s2_seeds", vmapped_seeds=1,
                  n_seeds=PAR_SEEDS, N_train=PT_SEEDED)
        _, alg1, _, _ = runner.build(sv, device=dev)
        stack = runner.vmapped_resume(sv, wd, alg1, alg1.for_seeds(
            PAR_SEEDS), dev)[0]
        for i in range(PAR_SEEDS):
            _hold_graft(checkpoint.seed_state(alg1, stack, i), ts1)
        (ts4, hist4), wall4 = _timed_run(
            f"particle_s2, {PAR_SEEDS} seeds in lockstep (vmapped_seeds), "
            "grafted into each", lambda: runner.train_multiseed(
                sv, wd, device=dev))
        rates["particle_s2_seeds"] = float(hist4[-1]["episode"].sum()) / wall4
        assert (hist4[-1]["episode"] >= PT_SEEDED).all() and ts4.step > 0
        assert not torch.equal(ts4.actor.flat[0], ts4.actor.flat[1])
        log(f"  seeds: rows " + ", ".join(str(r["episode"].tolist())
                                          for r in hist4))

        # 7. particle_s2 resumed from its autosave: the state restored,
        # the episode count restarted (JAX's on-policy runner)
        auto = os.path.join(wd, "saved", "pt_s2", "model_autosave")
        start = checkpoint.restore(auto, {"ts": runner.build(
            s2, device=dev)[1].empty_state(), "episodes": 0})
        ts5, st5 = run("particle_s2 resumed", dict(
            s2, auto_resume=1, require_resume=1, N_train=PT_RESUME))
        assert ts5.step > start["ts"].step > 0
        assert st5["history"][0]["episode"] // 100 == 1
        log(f"  resume: the autosave's state at step {int(start['ts'].step)} "
            f"(episode {start['episodes']}), the count restarted: first row "
            f"at {st5['history'][0]['episode']}, step {int(ts5.step)} after")

        # 8. the CLI in a process of its own
        cfg = os.path.join(wd, "cli_master.json")
        with open(cfg, "w") as f:
            json.dump(dict(s1, experiment="checkers", dir_name="cli_pt"), f)
        t0 = time.time()
        proc = subprocess.run(
            [sys.executable, "-m", "cm3_tpu_torch.train.runner", "--config",
             cfg, "--experiment", "particle", "--episodes", str(CURR_CLI),
             "--workdir", wd],
            cwd=os.path.dirname(os.path.abspath(__file__)),
            env=dict(os.environ, PYTHONDONTWRITEBYTECODE="1"),
            capture_output=True, text=True, timeout=300)
        assert proc.returncode == 0, proc.stderr[-2000:]
        rows = _rows(wd, "cli_pt")
        assert rows, "the CLI wrote no period row"
        log(f"  CLI: python -m cm3_tpu_torch.train.runner --experiment "
            f"particle --episodes {CURR_CLI} exited 0 in "
            f"{time.time() - t0:.2f} s with {len(rows)} period rows; its "
            f"last: {proc.stdout.strip().splitlines()[-1]}")
    log("  particle episodes/s: " + json.dumps(
        {k: round(v, 2) for k, v in rates.items()}))
    log("  adam_polyak at particle sizes, after a PyTorch kernel: actor "
        f"{times['actor']['ms'] * 1e3:.2f} us, both critics "
        f"{times['critics']['ms'] * 1e3:.2f} us per launch")
    return {"b1": b1, "b3": b3, "times": times, "worst": worst}


def _dual_pairs(alg, ts_c, ts_h, buf_c, buf_h, rs_c, rs_h, m_c, m_h,
                env_fields):
    """(card, CPU) pairs of a dual-buffer run: every network, target and
    Adam moment, both memories' rows below their capacity (the spare row
    takes dropped rows in any order) and their cursors, the slab's
    columns, the rollout, the env state and the metrics."""
    from cm3_tpu_torch.core.tree import tree_leaves
    pairs = []
    for k in alg.net_names():
        pairs += [(getattr(ts_c, k).flat, getattr(ts_h, k).flat),
                  (getattr(ts_c, k + "_tgt").flat,
                   getattr(ts_h, k + "_tgt").flat),
                  (getattr(ts_c, "opt_" + k).mu, getattr(ts_h, "opt_" + k).mu),
                  (getattr(ts_c, "opt_" + k).nu, getattr(ts_h, "opt_" + k).nu)]
    for ring_c, ring_h in ((buf_c.bad, buf_h.bad), (buf_c.good, buf_h.good)):
        cap, lead = ring_h.capacity, ring_h.insert.dim()
        pairs += [(ring_c.size, ring_h.size), (ring_c.insert, ring_h.insert)]
        pairs += [(x.narrow(lead, 0, cap), y.narrow(lead, 0, cap))
                  for (_, x), (_, y) in zip(tree_leaves(ring_c.data),
                                            tree_leaves(ring_h.data))]
    t = rs_h.stage_t.dim()
    pairs += [(x.narrow(t, 0, x.shape[t] - 1), y.narrow(t, 0, y.shape[t] - 1))
              for (_, x), (_, y) in zip(tree_leaves(rs_c.stage),
                                        tree_leaves(rs_h.stage))]
    pairs += [(getattr(rs_c.env_state, k), getattr(rs_h.env_state, k))
              for k in env_fields]
    pairs += [(getattr(rs_c, k), getattr(rs_h, k))
              for k in ("episodes", "eplog", "acc_ret_local", "stage_t")]
    pairs += [(m_c[k], m_h[k]) for k in m_h]
    return pairs


def dual_parity(device, kind, n_seeds=None, shards=1):
    """The dual buffer on the card and on the CPU from the same seeded
    state with the same fed draws, at full width: for ``kind`` "roadway"
    CM3 off-policy on two cars (a short road at top speed, a slab of 3
    transitions: episodes end inside chunks and lose their tails; fused
    for one seed, with B1's launches counted, optax for seeds), a fill
    and a training chunk of 4 updates; for "particle" CM3 on-policy
    (``stage2_cross`` from uniform starts), a fill chunk, a policy chunk
    and a burst of 24 updates; the replay in ``shards`` shards.  Held at
    phase 3's tolerance.  Returns (largest difference, B1 launches,
    (n_bad, n_good) on the card)."""
    import dataclasses
    import numpy as np
    import torch
    from cm3_tpu_torch.algs.cm3 import CM3
    from cm3_tpu_torch.core import config, prng
    from cm3_tpu_torch.envs.particle import Particle
    from cm3_tpu_torch.envs.roadway import Roadway
    from cm3_tpu_torch.ops import fused_opt
    from cm3_tpu_torch.train.experiments import make_hooks
    from cm3_tpu_torch.train.offpolicy import OffPolicyDriver, init_rollout
    from cm3_tpu_torch.train.onpolicy import OnPolicyDriver

    e, b, steps = RD_PAR_ENVS, RD_PAR_BATCH, STEPS
    lead = () if n_seeds is None else (n_seeds,)
    road = kind == "roadway"
    feed = (_RoadwayFeed if road else _ParticleFeed)(
        SEED + 13 + (n_seeds or 0), lead)
    feed.reset(e)
    for rand in (True, False):
        for _ in range(steps):
            feed.step(e, rand)
    for _ in range(RD_PAR_UPDATES if road else PT_PAR_EPOCHS):
        feed.update(b, shards=shards)
    m = config.load_json("master.json")
    eps = torch.tensor([0.1, 0.2, 0.3])[:n_seeds] if n_seeds else 0.3
    out = {}
    for dev in (str(device), "cpu"):
        if road:
            env = Roadway(dataclasses.replace(
                config.roadway_env_config(2, 0.5),
                init_position=(150.0, 150.0), speed=(50.0, 50.0)),
                device=dev)
            cfg = config.TrainConfig(
                n_envs=e, batch_size=b, buffer_size=512, dual_buffer=True,
                max_steps=RD_SLAB, steps_per_train=steps, episode_log=16,
                updates_per_chunk=RD_PAR_UPDATES, threshold=12.0,
                replay_shards=shards)
        else:
            env = Particle(config.particle_env_config(
                "stage2_cross", prob_random=1.0, max_steps=7), device=dev)
            cfg = config.TrainConfig(
                n_envs=e, batch_size=b, buffer_size=512, dual_buffer=True,
                max_steps=7, steps_per_train=steps, episode_log=16,
                epochs=PT_PAR_EPOCHS, replay_shards=shards)
        n = env.spec()["n_agents"]
        alg = CM3(kind, env.spec(), config.AlgConfig(
            n_agents=n, stage=2, fused_opt=road and n_seeds is None),
            config.NNConfig(**m["nn"]), device=dev, n_seeds=n_seeds)
        driver = (OffPolicyDriver if road else OnPolicyDriver)(
            make_hooks(kind, env, threshold=cfg.threshold), alg, cfg)
        draws = feed.fed(dev)
        rs = init_rollout(driver.hooks, e, draws, 16, n_seeds=n_seeds)
        ts = alg.init_state(prng.root_key(SEED) if n_seeds is None else
                            [prng.root_key(SEED + i) for i in range(n_seeds)])
        buf, rs = driver.init_replay(rs)
        torch.cuda.synchronize()
        before = fused_opt.adam_polyak.launches
        if road:
            ts, buf, rs, _ = driver._chunk(ts, buf, rs, eps, draws, False,
                                           True)
            ts, buf, rs, met = driver._chunk(ts, buf, rs, eps, draws, True,
                                             False)
        else:
            buf, rs = driver._rollout_chunk(ts, buf, rs, eps, draws, True)
            buf, rs = driver._rollout_chunk(ts, buf, rs, eps, draws, False)
            ts, met = driver._train_burst(ts, buf, eps, draws)
        assert not any(draws.remaining().values()), draws.remaining()
        out[dev] = (alg, ts, buf, rs, met,
                    fused_opt.adam_polyak.launches - before)
    (alg, ts_c, buf_c, rs_c, m_c, b1), (_, ts_h, buf_h, rs_h, m_h, _) = \
        out[str(device)], out["cpu"]
    fields = (("x", "vel", "sublane", "removed") if road else
              ("pos", "vel", "collisions"))
    worst = 0.0
    for got, want in _dual_pairs(alg, ts_c, ts_h, buf_c, buf_h, rs_c, rs_h,
                                 m_c, m_h, fields):
        torch.testing.assert_close(got.cpu(), want, rtol=PARITY_RTOL,
                                   atol=PARITY_ATOL)
        if got.numel() and got.is_floating_point():
            worst = max(worst, float((got.cpu().double()
                                      - want.double()).abs().max()))
    updates = RD_PAR_UPDATES if road else PT_PAR_EPOCHS
    routed = (int(buf_c.bad.size.sum()), int(buf_c.good.size.sum()))
    assert ts_c.step == updates and min(routed) > 0, routed
    want_b1 = 2 * updates if alg.cfg.fused_opt else 0
    assert b1 == want_b1, (kind, n_seeds, b1, want_b1)
    log(f"  {kind} dual{'' if n_seeds is None else f', {n_seeds} seeds'}"
        f"{'' if shards == 1 else f', {shards} shards'} "
        f"({'fused' if alg.cfg.fused_opt else 'optax'}): card == CPU after "
        + ("a fill and a training chunk" if road else
           "a fill chunk, a policy chunk and a burst") +
        f" of {updates} updates (rtol {PARITY_RTOL}, atol {PARITY_ATOL}); "
        f"max abs difference {worst:.3g}; n_bad {routed[0]}, n_good "
        f"{routed[1]} (per seed {buf_c.bad.size.tolist()} / "
        f"{buf_c.good.size.tolist()}); adam_polyak {b1} launches")
    return worst, b1, routed


def _roadway_masters():
    """master.json with the paper's roadway cells
    (scripts/reproduce_paper.py:166-214, 558-562: 16 envs, N_eval 10) at
    a period of 100 episodes, budgets ``RD_*``."""
    from cm3_tpu_torch.core import config
    m = config.load_json("master.json")
    m.update(experiment="roadway", n_envs=CURR_ENVS, N_eval=CURR_N_EVAL,
             period=100)
    s1 = dict(m, stage=1, dir_name="rd_s1", N_train=RD_S1)
    s2 = dict(m, stage=2, dir_name="rd_s2", dir_restore="rd_s1",
              train_from_nothing=0, dual_buffer=1, N_train=RD_S2)
    cells = {
        "roadway_s2_stable": dict(s2, dir_name="rd_s2c", grad_clip=10.0,
                                  N_train=RD_CELL),
        "roadway_qmix": dict(m, stage=2, alg_name="qmix",
                             dir_name="rd_qmix", N_train=RD_CELL),
        f"roadway_s2, fused, actor frozen {RD_FREEZE} updates": dict(
            s2, dir_name="rd_s2_fused", fused_opt=1,
            actor_freeze_updates=RD_FREEZE, N_train=RD_CELL),
        "particle_s2_dual (from nothing)": dict(
            m, experiment="particle", particle_config="stage2_antipodal",
            stage=2, dir_name="pt_s2d", dual_buffer=1, N_train=RD_CELL),
    }
    seeds = dict(s2, dir_name="rd_s2_seeds", vmapped_seeds=1,
                 n_seeds=PAR_SEEDS, N_train=RD_SEEDED)
    return s1, s2, cells, seeds


def phase_roadway_runner(dev):
    import tempfile
    import numpy as np
    import torch
    from cm3_tpu_torch.core import prng
    from cm3_tpu_torch.ops import fused_opt, polyak
    from cm3_tpu_torch.train import runner

    # 1. card against CPU with the dual buffer
    worst = {"roadway": dual_parity(dev, "roadway")[0],
             "roadway_seeds": dual_parity(dev, "roadway", PAR_SEEDS)[0],
             "particle": dual_parity(dev, "particle")[0]}

    # 2. B1 at roadway sizes: bit for bit, then its time per launch
    s1, s2, cells, seeds = _roadway_masters()
    alg = runner.build(s2, device=dev)[1]
    st = alg.empty_state()
    sizes = {k: getattr(st, k).flat.numel() for k in ("actor", "qg", "qc")}
    gen = torch.Generator(device=dev).manual_seed(SEED + 14)
    err = max(hold_adam(dev, gen, [(sizes["actor"], 0, 1e-4, 0)]),
              hold_adam(dev, gen, [(sizes["qg"], 0, LR, 0),
                                   (sizes["qc"], 0, LR, 0)]))
    log(f"  adam_polyak at roadway sizes (actor {sizes['actor']}, Q_global "
        f"{sizes['qg']}, Q_credit {sizes['qc']} floats): kernel == plain "
        f"bit for bit over 5 steps (max abs difference {err})")
    tgt, main = (torch.randn(sizes["actor"], device=dev, generator=gen)
                 for _ in range(2))
    want = polyak.polyak_update_plain(tgt.clone(), main, TAU)
    polyak.polyak_update(tgt, main, TAU)
    log("  polyak at the roadway actor's size: kernel == plain bit for bit "
        f"(max abs difference {assert_bit_equal([(tgt, want)], 'polyak')})")
    times = {name: adam_times(dev, gen, f"roadway {name}", n)
             for name, n in (("actor", [sizes["actor"]]),
                             ("critics", [sizes["qg"], sizes["qc"]]))}

    rates, routed = {}, {}
    with tempfile.TemporaryDirectory() as wd:
        def run(name, m):
            torch.cuda.synchronize()
            fused_opt.adam_polyak.launches = 0
            polyak.polyak_update.launches = 0
            (ts, st), wall = _timed_run(
                f"{name} ({m.get('alg_name', 'cm3')}), train_function",
                lambda: runner.train_function(m, wd, verbose=False,
                                              device=dev))
            rates[name] = st["episodes"] / wall
            row = st["history"][-1]
            assert np.isfinite(row["r_eval_local"]).all()
            extra = (f", n_bad {row['n_bad']}, n_good {row['n_good']}"
                     if "n_bad" in row else "")
            if "n_bad" in row:
                routed[name] = (row["n_bad"], row["n_good"])
            traffic = (f", eval_avg_speed {row['eval_avg_speed']:.3f}, "
                       f"eval_count_success {row['eval_count_success']:.2f}"
                       if "eval_avg_speed" in row else "")
            log(f"    {int(ts.step)} updates; last row: episode "
                f"{row['episode']}, r_eval_global "
                f"{row['r_eval_global']:.3f}{traffic}{extra}; adam_polyak "
                f"{fused_opt.adam_polyak.launches}, polyak "
                f"{polyak.polyak_update.launches} launches")
            return ts, st

        # 3. roadway_s1 through the CLI in a process of its own
        cfg = os.path.join(wd, "rd_master.json")
        with open(cfg, "w") as f:
            json.dump(dict(s1, experiment="checkers"), f)
        t0 = time.time()
        proc = subprocess.run(
            [sys.executable, "-m", "cm3_tpu_torch.train.runner", "--config",
             cfg, "--experiment", "roadway", "--stage", "1", "--episodes",
             str(RD_S1), "--workdir", wd],
            cwd=os.path.dirname(os.path.abspath(__file__)),
            env=dict(os.environ, PYTHONDONTWRITEBYTECODE="1"),
            capture_output=True, text=True, timeout=300)
        wall = time.time() - t0
        assert proc.returncode == 0, proc.stderr[-2000:]
        rows = _rows(wd, "rd_s1")
        assert rows, "the CLI wrote no period row"
        # at least RD_S1 episodes: a lower bound of the rate
        rates["roadway_s1 (CLI process)"] = RD_S1 / wall
        log(f"  roadway_s1: python -m cm3_tpu_torch.train.runner "
            f"--experiment roadway --stage 1 --episodes {RD_S1} exited 0 in "
            f"{wall:.2f} s (the process's start included), >= "
            f"{RD_S1 / wall:.1f} episodes/s, {len(rows)} period rows; its "
            f"last: {proc.stdout.strip().splitlines()[-1]}")

        # 4. its graft into stage 2 held on the card, then roadway_s2
        ts1 = runner._restore_stage1_state(s2, wd, prng.root_key(
            s2.get("seed", 12341)), dev)
        shared = _hold_graft(runner.initial_state(s2, wd, dev)[4], ts1)
        log(f"  graft: {shared} shared floats equal stage 1's bit for bit "
            "(one car into two), Q_credit's shared leaves equal Q_global's, "
            "targets equal mains (on the card)")
        run("roadway_s2 (grafted, dual buffer)", s2)
        assert fused_opt.adam_polyak.launches == 0

        # 5. the stable cell, QMIX, the fused stage 2, particle dual
        b1 = b3 = 0
        for name, m in cells.items():
            ts, st = run(name, m)
            if m.get("fused_opt"):
                b1 = fused_opt.adam_polyak.launches
                b3 = polyak.polyak_update.launches
                steps = int(ts.step)
                frozen = min(RD_FREEZE, steps)
                assert b1 == 2 * steps and b1 > 0, (b1, steps)
                assert b3 == steps > frozen > 0, b3
                log(f"  fused roadway_s2: {steps} updates ({frozen} frozen), "
                    f"adam_polyak {b1} launches = 2 x {steps}, polyak {b3} "
                    f"= {steps} (the freeze predicates at every update)")
            else:
                assert fused_opt.adam_polyak.launches == 0, name

        # 6. three seeds in lockstep with the dual buffer, grafted
        (ts4, hist4), wall4 = _timed_run(
            f"roadway_s2, {PAR_SEEDS} seeds in lockstep (vmapped_seeds, "
            "dual buffer), grafted into each",
            lambda: runner.train_multiseed(seeds, wd, device=dev))
        rates["roadway_s2_seeds"] = float(hist4[-1]["episode"].sum()) / wall4
        assert (hist4[-1]["episode"] >= RD_SEEDED).all() and ts4.step > 0
        assert not torch.equal(ts4.actor.flat[0], ts4.actor.flat[1])
    log("  roadway episodes/s: " + json.dumps(
        {k: round(v, 2) for k, v in rates.items()}))
    log("  n_bad / n_good at the end: " + json.dumps(routed))
    log("  adam_polyak at roadway sizes, after a PyTorch kernel: actor "
        f"{times['actor']['ms'] * 1e3:.2f} us, both critics "
        f"{times['critics']['ms'] * 1e3:.2f} us per launch")
    return {"b1": b1, "b3": b3, "times": times, "worst": worst}


# ------------------------------------------------------------------ #
# the CUDA C++ build
# ------------------------------------------------------------------ #


# ------------------------------------------------------------------ #
# the single-env cells through the runner (the K-chunk schedule)
# ------------------------------------------------------------------ #


def _e1_masters():
    """master.json with the paper's checkers_s2_e1 and checkers_qmix_e1
    settings (scripts/reproduce_paper.py:536-552: n_envs 1, one update
    per 10 env steps, K = 32 chunks per host sync, N_eval 10), the
    period, the fill and the budgets cut (``E1_*``), and the short stage
    1 (16 envs, a period of 100) that checkers_s2_e1 grafts."""
    from cm3_tpu_torch.core import config
    m = config.load_json("master.json")
    m.update(experiment="checkers", N_eval=10, period=100)
    s1 = dict(m, stage=1, n_envs=16, dir_name="ck_s1", N_train=E1_S1)
    e1 = dict(m, stage=2, n_envs=1, chunks_per_sync=E1_K, period=E1_PERIOD,
              pretrain_episodes=E1_FILL)
    s2 = dict(e1, dir_name="ck_s2e1", dir_restore="ck_s1",
              train_from_nothing=0, N_train=E1_CELL)
    qm = dict(e1, alg_name="qmix", dir_name="ck_qme1", train_from_nothing=1,
              N_train=E1_CELL)
    return s1, s2, qm


def _e1_program(master, dev, **over):
    """(driver, alg, state, replay, rollout, draws) of ``master`` (with
    the TrainConfig fields ``over``) on ``dev``, the state from SEED (the
    same weights on every device)."""
    import dataclasses
    from cm3_tpu_torch.core import prng
    from cm3_tpu_torch.train import runner
    from cm3_tpu_torch.train.offpolicy import init_rollout
    driver, alg, _, cfg = runner.build(master, device=dev)
    driver.cfg = dataclasses.replace(cfg, **over)
    draws = prng.GeneratorDraws(prng.generator(
        prng.for_purpose(prng.root_key(SEED), prng.ROLLOUT), dev))
    rs = init_rollout(driver.hooks, driver.n_envs, draws)
    buf, rs = driver.init_replay(rs)
    return driver, alg, alg.init_state(prng.root_key(SEED)), buf, rs, draws


def _sync_free(dev, name, master):
    """One K-chunk dispatch that crosses the fill -> train boundary under
    ``torch.cuda.set_sync_debug_mode("error")``, after a dispatch of two
    chunks that warms every kernel and workspace (a fill chunk computes
    what a training chunk does): the chunks it trained."""
    import dataclasses
    import torch
    driver, _, ts, buf, rs, draws = _e1_program(master, dev)
    ts, buf, rs, _ = driver._chunks_scanned(ts, buf, rs, draws, 2)
    episodes = int(rs.episodes)
    driver.cfg = dataclasses.replace(driver.cfg,
                                     pretrain_episodes=episodes + 2)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        ts, buf, rs, m = driver._chunks_scanned(ts, buf, rs, draws, E1_K)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    trained = int(m["trained_chunks"])
    assert 0 < trained < E1_K, (name, trained)
    log(f"  {name}: one K = {E1_K} dispatch across the fill -> train "
        f"boundary (episodes {episodes} -> {int(rs.episodes)}, {trained} "
        "chunks trained) with no host sync (set_sync_debug_mode error)")
    return trained


def _e1_parity(device, master, k_chunks=6):
    """Card against CPU after one K-chunk dispatch that crosses the fill
    -> train boundary (the first episode, 33 steps, ends in the fourth
    chunk: pretrain_episodes 1), from the same state with the same fed
    draws: (max abs difference, chunks trained)."""
    import numpy as np
    import torch
    from cm3_tpu_torch.core import prng
    rng = np.random.default_rng(SEED + 13)
    b = master["batch_size"]
    rand, gumbel = [], []
    for c in range(k_chunks):
        for _ in range(STEPS):
            gumbel.append(rng.gumbel(size=(1, 2, 5)).astype(np.float32))
            rand.append(rng.integers(0, 5, (1, 2)))
        rand.append(rng.integers(0, STEPS * (c + 1), b))
        gumbel.append(rng.gumbel(size=(b, 2, 5)).astype(np.float32))
    out = {}
    for dev in (device, "cpu"):
        driver, alg, ts, buf, rs, _ = _e1_program(master, dev,
                                                  pretrain_episodes=1)
        draws = prng.FedDraws(rand, gumbel, device=dev)
        out[dev] = driver._chunks_scanned(ts, buf, rs, draws, k_chunks)
        assert not any(draws.remaining().values())
    (ts_c, _, rs_c, m_c), (ts_h, _, rs_h, m_h) = out[device], out["cpu"]
    worst = 0.0
    for name in alg.net_names():
        o_c, o_h = getattr(ts_c, "opt_" + name), getattr(ts_h, "opt_" + name)
        for got, want in ((getattr(ts_c, name).flat, getattr(ts_h, name).flat),
                          (getattr(ts_c, name + "_tgt").flat,
                           getattr(ts_h, name + "_tgt").flat),
                          (o_c.mu, o_h.mu), (o_c.nu, o_h.nu)):
            torch.testing.assert_close(got.cpu(), want, rtol=PARITY_RTOL,
                                       atol=PARITY_ATOL)
            worst = max(worst, float((got.cpu() - want).abs().max()))
        assert int(o_c.count) == int(o_h.count)
    for k in m_h:
        torch.testing.assert_close(m_c[k].cpu(), m_h[k], rtol=PARITY_RTOL,
                                   atol=PARITY_ATOL)
    trained = int(m_h["trained_chunks"])
    assert int(rs_c.episodes) == int(rs_h.episodes) >= 1
    assert int(ts_c.step) == int(ts_h.step) == trained > 0
    assert trained < k_chunks
    return worst, trained


def _hold_gated_kernels(dev):
    """B1 and B3 under the device predicate 0, 1 and none against their
    plain versions at the Checkers sizes, bit for bit (rtol 0, atol 0),
    for 3 steps: the actor's launch and both critics' in one."""
    import torch
    from cm3_tpu_torch.algs import common
    from cm3_tpu_torch.ops import fused_opt, polyak
    gen = torch.Generator(device=dev).manual_seed(SEED + 13)
    err = 0.0
    for apply in (None, 0, 1):
        pred = (None if apply is None else
                torch.full((), apply, dtype=torch.bool, device=dev))
        for sizes in ([MAIN_SIZES["actor"]],
                      [MAIN_SIZES["Q_global"], MAIN_SIZES["Q_credit"]]):
            nets = [adam_net(dev, gen, n, count=3) for n in sizes]
            ref = [(common.AdamState(st.mu.clone(), st.nu.clone(), st.count),
                    p.clone(), t.clone()) for st, p, t, _ in nets]
            for _ in range(3):
                for *_, g in nets:
                    g.normal_(generator=gen).mul_(1e-3)
                fused_opt.adam_polyak_many(
                    [(st, p, t, g, LR) for st, p, t, g in nets], TAU,
                    apply=pred)
                for (rst, rp, rt), (*_, g) in zip(ref, nets):
                    tile = common.advance(rst, pred)
                    fused_opt.adam_polyak_plain(rp, rt, rst.mu, rst.nu, g,
                                                tile[0], tile[1], LR, TAU,
                                                apply=pred)
            err = max(err, assert_bit_equal(
                [(a, b) for (st, p, t, _), (rst, rp, rt) in zip(nets, ref)
                 for a, b in ((p, rp), (t, rt), (st.mu, rst.mu),
                              (st.nu, rst.nu), (st.count, rst.count))],
                f"adam_polyak {sizes}, predicate {apply}"))
            assert all(int(st.count) == 3 + 3 * (1 if apply is None else
                                                 apply) for st, *_ in nets)
        t = torch.randn(MAIN_SIZES["actor"], device=dev, generator=gen)
        m = torch.randn(MAIN_SIZES["actor"], device=dev, generator=gen)
        want = polyak.polyak_update_plain(t.clone(), m, TAU, pred)
        polyak.polyak_update(t, m, TAU, pred)
        err = max(err, assert_bit_equal([(t, want)],
                                         f"polyak, predicate {apply}"))
    log("  adam_polyak (actor; both critics in one launch) and polyak at the "
        "Checkers sizes under the device predicate 0, 1 and none: kernel == "
        "plain bit for bit (rtol 0, atol 0) over 3 steps, the counts "
        "advanced by the predicate")
    return err


def phase_e1(dev):
    import tempfile
    import numpy as np
    import torch
    from cm3_tpu_torch.ops import fused_opt, polyak
    from cm3_tpu_torch.train import runner

    err = _hold_gated_kernels(dev)
    s1, s2, qm = _e1_masters()
    worst, trained = _e1_parity(dev, s2)
    log(f"  checkers_s2_e1: card == CPU after one K = 6 dispatch across the "
        f"fill -> train boundary ({trained} chunks trained; rtol "
        f"{PARITY_RTOL}, atol {PARITY_ATOL}); max abs difference {worst:.3g}")
    fused = dict(s2, fused_opt=1, actor_freeze_updates=E1_FREEZE)
    for name, m in (("checkers_s2_e1, optax", s2),
                    (f"checkers_s2_e1, fused, actor frozen {E1_FREEZE}",
                     fused), ("checkers_qmix_e1", qm)):
        _sync_free(dev, name, m)

    with tempfile.TemporaryDirectory() as wd:
        _timed_run(f"stage 1 for the graft ({s1['n_envs']} envs)",
                   lambda: runner.train_function(s1, wd, verbose=False,
                                                 device=dev))
        (ts, st), wall = _timed_run(
            f"checkers_s2_e1 (n_envs 1, K = {E1_K}, grafted)",
            lambda: runner.train_function(s2, wd, verbose=False, device=dev))
        rate = st["episodes"] / wall
        row = st["history"][-1]
        assert st["episodes"] >= E1_CELL and int(ts.step) > 0
        assert np.isfinite([row["r_eval_global"]]).all()
        log(f"    {int(ts.step)} updates, {st['dispatches']} host syncs "
            f"of the episode count ({st['dispatches'] / st['episodes']:.3f}"
            f" an episode); last row: episode {row['episode']}, "
            f"trained_chunks {row['trained_chunks']:.0f}, epsilon "
            f"{row['epsilon']:.4f}, r_eval_global "
            f"{row['r_eval_global']:.3f}")

        # K = 1 against K = 32 in turns, training from the first chunk
        turns = {1: [], E1_K: []}
        for k in (1, E1_K, E1_K, 1):
            m = dict(s2, chunks_per_sync=k, N_train=E1_TURN,
                     pretrain_episodes=E1_TURN_FILL,
                     dir_name=f"ck_s2e1_k{k}_{len(turns[k])}")
            (ts, st), wall = _timed_run(
                f"checkers_s2_e1 at K = {k}",
                lambda: runner.train_function(m, wd, verbose=False,
                                              device=dev))
            turns[k].append((st["episodes"] / wall,
                             st["dispatches"] / st["episodes"]))
        log(f"  K = 1 vs K = {E1_K} in turns: episodes/s "
            + ", ".join(f"K = {k}: {[round(r, 2) for r, _ in v]}"
                        for k, v in turns.items())
            + "; host syncs an episode "
            + ", ".join(f"K = {k}: {[round(s, 3) for _, s in v]}"
                        for k, v in turns.items()))

        # the fused path with the actor frozen across dispatches: B1 twice
        # and B3 once per computed update (gated or not)
        torch.cuda.synchronize()
        fused_opt.adam_polyak.launches = 0
        polyak.polyak_update.launches = 0
        m = dict(fused, dir_name="ck_s2e1_fused", N_train=E1_FREEZE_RUN,
                 pretrain_episodes=E1_TURN_FILL)
        (ts, st), _ = _timed_run(
            f"checkers_s2_e1, fused, actor frozen {E1_FREEZE} updates",
            lambda: runner.train_function(m, wd, verbose=False, device=dev))
        b1, b3 = fused_opt.adam_polyak.launches, polyak.polyak_update.launches
        computed = st["dispatches"] * E1_K
        assert b1 == 2 * computed and b3 == computed, (b1, b3, computed)
        assert int(ts.step) > E1_FREEZE
        assert int(ts.opt_actor.count) == int(ts.step) - E1_FREEZE
        log(f"    {computed} updates computed in {st['dispatches']} "
            f"dispatches, {int(ts.step)} applied ({E1_FREEZE} with the actor "
            f"frozen): adam_polyak {b1} launches = 2 x {computed}, polyak "
            f"{b3} = {computed}")

        # checkers_qmix_e1 through the CLI in a process of its own
        cfg = os.path.join(wd, "cli_master.json")
        with open(cfg, "w") as f:
            json.dump(qm, f)
        t0 = time.time()
        proc = subprocess.run(
            [sys.executable, "-m", "cm3_tpu_torch.train.runner", "--config",
             cfg, "--workdir", wd],
            cwd=os.path.dirname(os.path.abspath(__file__)),
            env=dict(os.environ, PYTHONDONTWRITEBYTECODE="1"),
            capture_output=True, text=True, timeout=300)
        wall = time.time() - t0
        assert proc.returncode == 0, proc.stderr[-2000:]
        rows = _rows(wd, qm["dir_name"])
        assert rows, "the CLI wrote no period row"
        done = int(rows[-1].split(",")[0])
        log(f"  checkers_qmix_e1 (n_envs 1, K = {E1_K}, from nothing) through "
            f"python -m cm3_tpu_torch.train.runner: exit 0 in {wall:.2f} s "
            f"(its start included), >= {done} episodes, >= "
            f"{done / wall:.1f} episodes/s, {len(rows)} period rows")
    return {"err": err, "b1": b1, "b3": b3, "rate": rate, "turns": turns}


def phase_build():
    from cm3_tpu_torch.ops import _nvcc

    info = _nvcc.library().build_info
    log(f"  nvcc {info['nvcc']} ({info['nvcc_version']})")
    log(f"  library {info['library']}: "
        + ("built" if info["built"] else "found by its hash"))
    if info["built"]:
        log(f"  command: {info['command']}")
        log(f"  build took {info['seconds']:.2f} s")
        for line in info["ptxas"].splitlines():
            if "registers" in line or "Compiling entry" in line:
                log(f"  ptxas: {line.strip()}")


# ------------------------------------------------------------------ #
# the fused Checkers rollout
# ------------------------------------------------------------------ #


def _smi_max_sm_clock_hz():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60, check=True).stdout.split()
    return float(out[0]) * 1e6


def log_occupancy(mod, n_agents):
    """The built rollout kernel's registers and resident blocks per SM,
    Philox and fed variants (``cudaFuncGetAttributes``,
    ``cudaOccupancyMaxActiveBlocksPerMultiprocessor``)."""
    for fed in (False, True):
        o = mod.occupancy(n_agents, fed)
        log(f"  {mod.__name__.rsplit('.', 1)[-1]} kernel, N = {n_agents}, "
            f"{'fed' if fed else 'Philox'}: {o['registers']} registers per "
            f"thread, {o['blocks_per_sm']} resident blocks of "
            f"{o['threads']} threads per SM, {o['local_bytes']} bytes of "
            "local memory per thread")


def hold_rollout(got, want, what, rtol=0.0, atol=ROLLOUT_ATOL):
    """Hold the kernel's (reward sums, episodes) against the plain
    version's (on the card or the CPU): episodes exactly, reward sums to
    ``rtol``/``atol``.  Returns the largest reward difference."""
    import torch
    torch.cuda.synchronize()
    (k_rew, k_ep), (p_rew, p_ep) = ((r.cpu(), e.cpu()) for r, e in (got,
                                                                     want))
    assert torch.equal(k_ep, p_ep), (
        f"{what}: episodes differ on {int((k_ep != p_ep).sum())} instances")
    torch.testing.assert_close(k_rew, p_rew, rtol=rtol, atol=atol)
    err = float((k_rew - p_rew).abs().max())
    log(f"  {what}: kernel == plain: episodes equal, reward sums max abs "
        f"difference {err:.3g} (rtol {rtol}, atol {atol}), "
        f"{int((k_rew != p_rew).sum())} of {k_rew.numel()} differ; "
        f"bit-equal: {torch.equal(k_rew, p_rew)}")
    return err


def phase_rollout(dev):
    import torch
    from cm3_tpu_torch import bench
    from cm3_tpu_torch.core.config import CheckersEnvConfig
    from cm3_tpu_torch.envs import checkers_packed as cp
    from cm3_tpu_torch.ops import checkers_rollout as cr

    spec = cp.make_spec(CheckersEnvConfig(
        n_agents=2, agents_r=(0, 2), agents_c=(8, 8), max_steps=50),
        (True, False))
    gen = torch.Generator(device=dev).manual_seed(SEED)

    # fed actions at a ragged batch: kernel == plain on the card
    acts = torch.randint(0, 5, (FED_T, 2, FED_B), device=dev,
                         dtype=torch.int32, generator=gen)
    fed_err = hold_rollout(cr.rollout_actions(spec, acts),
                           cr.rollout_actions_plain(spec, acts),
                           f"fed B={FED_B} T={FED_T}")

    # Philox draws: kernel == plain on the card == plain on the CPU
    k_rew, k_ep = cr.rollout_prng(spec, PRNG_B, PRNG_T, SEED + 7, device=dev)
    p_rew, p_ep = cr.rollout_prng_plain(spec, PRNG_B, PRNG_T, SEED + 7, dev)
    h_rew, h_ep = cr.rollout_prng(spec, PRNG_B, PRNG_T, SEED + 7,
                                  device="cpu")
    torch.cuda.synchronize()
    for name, (a, b) in {"card plain": (p_rew, p_ep),
                         "CPU plain": (h_rew, h_ep)}.items():
        assert torch.equal(k_rew.cpu(), a.cpu()), f"PRNG rewards vs {name}"
        assert torch.equal(k_ep.cpu(), b.cpu()), f"PRNG episodes vs {name}"
    assert int(k_ep.min()) >= PRNG_T // spec.max_steps
    log(f"  Philox B={PRNG_B} T={PRNG_T}: kernel == plain on the card == "
        f"plain on the CPU, exactly; mean reward sum "
        f"{float(k_rew.mean()):.4f}, mean episodes "
        f"{float(k_ep.float().mean()):.3f}")

    # bench.py's figure at full size: the main path of this kernel
    cr.rollout_prng.launches = 0
    figure = bench.bench_checkers_fused(FUSED_B, FUSED_T, FUSED_REPS)
    launches = cr.rollout_prng.launches
    assert launches == 1 + FUSED_REPS, (
        f"rollout_prng launched {launches} times in the bench, not "
        f"{1 + FUSED_REPS}")

    # the bench's call timed, then held against the plain version at the
    # same size and seed
    out = {}
    call = lambda: out.update(k=cr.rollout_prng(spec, FUSED_B, FUSED_T, 99,
                                                device=dev))
    call_ms = cuda_time_ms(call, 3, warmup=1)
    rew, ep = out["k"]
    assert rew.shape == (FUSED_B,) and bool(torch.isfinite(rew).all())
    assert int(ep.min()) >= FUSED_T // spec.max_steps
    plain = lambda: out.update(p=cr.rollout_prng_plain(spec, FUSED_B,
                                                       FUSED_T, 99, dev))
    plain_ms = cuda_time_ms(plain, 1, warmup=0)
    full_err = hold_rollout(out["k"], out["p"],
                            f"Philox B={FUSED_B} T={FUSED_T} seed 99")
    # the plain version per step over a short run, held against the kernel
    short = lambda: out.update(p=cr.rollout_prng_plain(spec, FUSED_B,
                                                       PLAIN_T, 3, dev))
    plain_step_ms = cuda_time_ms(short, 1, warmup=1) / PLAIN_T
    short_err = hold_rollout(
        cr.rollout_prng(spec, FUSED_B, PLAIN_T, 3, device=dev), out["p"],
        f"Philox B={FUSED_B} T={PLAIN_T} seed 3")

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    clock = _smi_max_sm_clock_hz()
    bound_ms = (ROLLOUT_OPS_PER_STEP * FUSED_B * FUSED_T
                / (sms * WARP_INSTS_PER_CLOCK * 32 * clock) * 1e3)
    log(f"  bench_checkers_fused (B={FUSED_B}, T={FUSED_T}, reps "
        f"{FUSED_REPS}): {figure:.6g} env-steps/s; {launches} launches "
        f"(warm-up + reps)")
    log(f"  kernel {call_ms:.3f} ms per call "
        f"({FUSED_B * FUSED_T / call_ms * 1e3:.6g} env-steps/s) against a "
        f"bound of {bound_ms:.3f} ms (operations: {ROLLOUT_OPS_PER_STEP} "
        f"per step x B x T / ({sms} SMs x {WARP_INSTS_PER_CLOCK} "
        f"warp-instructions x 32 at {clock / 1e6:.0f} MHz)), "
        f"{bound_ms / call_ms:.3f} of it")
    log(f"  plain {plain_ms:.1f} ms per call ({plain_ms / call_ms:.0f}x the "
        f"kernel); per step of {FUSED_B} instances: kernel "
        f"{call_ms / FUSED_T * 1e3:.3f} us, plain "
        f"{plain_ms / FUSED_T * 1e3:.1f} us (T={FUSED_T}), "
        f"{plain_step_ms * 1e3:.1f} us (T={PLAIN_T}); library: no single "
        "PyTorch call computes it")
    log_occupancy(cr, 2)
    grid = bench.bench_checkers_throughput()
    log(f"  bench_checkers_throughput (grid engine, B=8192, T=256, reps 5): "
        f"{grid:.6g} env-steps/s")
    return {"launches": launches, "max_abs_err": max(fed_err, full_err,
                                                     short_err),
            "ms": call_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "operations", "library_ms": None}


# ------------------------------------------------------------------ #
# Polyak
# ------------------------------------------------------------------ #


def phase_polyak(dev):
    import torch
    from cm3_tpu_torch.ops import polyak

    gen = torch.Generator(device=dev).manual_seed(SEED)

    def view(n, off=0):
        x = torch.zeros(n + off, device=dev)
        x[off:] = torch.randn(n, device=dev, generator=gen)
        return x[off:]

    cases = [(n, (0, 0)) for n in POLYAK_SIZES] + [
        (n, offs) for n in (8193, max(POLYAK_SIZES))
        for offs in ((1, 1), (2, 0), (0, 3))]
    err = 0.0
    for n, (t_off, m_off) in cases:
        for tau in POLYAK_TAUS:
            t, m = view(n, t_off), view(n, m_off)
            want = polyak.polyak_update_plain(t.clone(), m, tau)
            polyak.polyak_update(t, m, tau)
            err = max(err, assert_bit_equal(
                [(t, want)], f"polyak n={n} offsets {(t_off, m_off)} tau "
                f"{tau}"))
    log(f"  polyak: kernel == plain bit for bit (rtol 0, atol 0) at n in "
        f"{POLYAK_SIZES} x tau in {POLYAK_TAUS}, and on views offset by 1-3 "
        "floats")

    # a soft update of the slice's three networks, as a user calls it
    _, ts, _, _ = build(dev)
    pairs = [(getattr(ts, k + "_tgt").flat, getattr(ts, k).flat)
             for k in ("actor", "qg", "qc")]
    for tgt, main in pairs:
        tgt.add_(torch.randn(tgt.numel(), device=dev, generator=gen))
    wants = [polyak.polyak_update_plain(t.clone(), m, TAU) for t, m in pairs]
    polyak.polyak_update.launches = 0
    for tgt, main in pairs:
        polyak.polyak_update(tgt, main, TAU)
    launches = polyak.polyak_update.launches
    assert launches == 3, f"polyak_update launched {launches} times, not 3"
    err = max(err, assert_bit_equal(
        [(t, w) for (t, _), w in zip(pairs, wants)],
        "polyak soft update of the three networks"))

    n = MAIN_SIZES["actor"]
    t, m = view(n), view(n)
    kern = lambda: polyak.polyak_update(t, m, TAU)
    one = torch.ones((), dtype=torch.bool, device=dev)
    kern_pred = lambda: polyak.polyak_update(t, m, TAU, one)
    plain = lambda: polyak.polyak_update_plain(t, m, TAU)
    lib = lambda: t.lerp_(m, TAU)

    def cold(op):
        def make():
            t, m = view(n), view(n)
            return lambda: op(t, m)
        return rotation(make, POLYAK_BYTES_PER_ELEM * n)
    e = view(0)
    floor = lambda: polyak.polyak_update(e, e, TAU)
    foreign, after = after_pytorch(dev)
    b2b = cuda_time_ms(kern, 500)
    alone, a_kern, a_lerp, a_pred = graph_turns(
        foreign, after(kern), after(lib), after(kern_pred))
    warm, lerp = graph_turns(kern, lib)
    colds, lerp_colds = graph_turns(
        cold(lambda t, m: polyak.polyak_update(t, m, TAU)),
        cold(lambda t, m: t.lerp_(m, TAU)))
    floors, a_plain, alone_p = graph_turns(floor, after(plain), foreign)
    kern_ms, lerp_ms = after_ms(a_kern, alone), after_ms(a_lerp, alone)
    pred_ms = after_ms(a_pred, alone)
    plain_ms = after_ms(a_plain, alone_p)
    bound, bound_by = flat_bound(n, POLYAK_BYTES_PER_ELEM,
                                 POLYAK_OPS_PER_ELEM)
    med = statistics.median
    log(f"  polyak n={n}: {launches} launches for the three networks; back "
        f"to back {b2b * 1e3:.2f} us/launch; in CUDA graphs (median and range "
        f"of {2 * TURNS}, in turns with lerp_): after a PyTorch kernel "
        f"({us_spread(alone)} alone) kernel {kern_ms * 1e3:.2f} us more "
        f"(pair {us_spread(a_kern)}), with a device predicate (1) "
        f"{pred_ms * 1e3:.2f} us more (pair {us_spread(a_pred)}), lerp_ "
        f"{lerp_ms * 1e3:.2f} us more (pair {us_spread(a_lerp)}); warm {us_spread(warm)}, lerp_ "
        f"{us_spread(lerp)}; cold {us_spread(colds)}, lerp_ "
        f"{us_spread(lerp_colds)}; floor (n = 0) {us_spread(floors)}; plain "
        f"after a PyTorch kernel {plain_ms * 1e3:.2f} us more; bound "
        f"{bound * 1e3:.3f} us ({bound_by}), share after a PyTorch kernel "
        f"{bound / kern_ms:.3f}, warm {bound / med(warm):.3f}, cold "
        f"{bound / med(colds):.3f}")
    log_flat_occupancy(polyak)
    return {"launches": launches, "max_abs_err": err, "ms": kern_ms,
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": bound_by,
            "library_ms": lerp_ms, "pred_ms": pred_ms}


# ------------------------------------------------------------------ #
# the fused particle and roadway rollouts
# ------------------------------------------------------------------ #


def particle_counter(cfg, dev):
    """An ``observe`` for ``particle_rollout.rollout_prng_plain`` that
    counts the pairs whose contact force is not exactly 0 (``pen`` as
    ``soa_step`` computes it, on the positions before the move), and per
    pair the instances and the warps (``WARP`` consecutive instances) in
    which a lane takes the kernel's contact branch (``d2 < far_d2``).
    Returns it, the counts and a description of the branch's shares."""
    import torch
    from cm3_tpu_torch.envs import particle_soa as ps
    from cm3_tpu_torch.ops import particle_rollout as pr

    k = torch.full((), cfg.contact_margin, dtype=torch.float32, device=dev)
    far = float(pr.far_d2(cfg))
    pairs = [(i, j) for i in range(cfg.n_agents)
             for j in range(i + 1, cfg.n_agents)]
    zero = lambda: torch.zeros((), dtype=torch.int64, device=dev)
    counts = {"near_pair": zero()}
    branch = {p: [zero(), zero()] for p in pairs}   # instances, warps
    seen = [0, 0]                                    # instance-, warp-steps

    def observe(s):
        b = s.px[0].shape[0]
        seen[0] += b
        seen[1] += -(-b // WARP)
        for i, j in pairs:
            dx, dy = s.px[i] - s.px[j], s.py[i] - s.py[j]
            d2 = dx * dx + dy * dy
            dist = ps.sqrt(d2)
            pen = ps.logaddexp0(-(dist - 2 * cfg.agent_size) / k) \
                * cfg.contact_margin
            counts["near_pair"] += (pen != 0).sum()
            taken = d2 < far
            branch[i, j][0] += taken.sum()
            pad = torch.nn.functional.pad(taken, (0, -b % WARP))
            branch[i, j][1] += pad.view(-1, WARP).any(1).sum()

    def describe():
        return ("contact branch (d2 < far_d2 = " + repr(far) + ") taken, "
                "per pair, by a share of instance-steps / of warp-steps: "
                + "; ".join(f"{i}{j} {int(n) / seen[0]:.6g} / "
                            f"{int(w) / seen[1]:.6g}"
                            for (i, j), (n, w) in branch.items()))
    return observe, counts, describe


def roadway_counter(cfg, dev):
    """An ``observe`` for ``roadway_rollout.rollout_prng_plain`` that
    counts the live cars, the pairs of live cars, the TTC candidates
    (the other car live, ahead, slower and in lateral reach), the drawn
    actions the filter rejects and the goal rewards read."""
    import torch
    from cm3_tpu_torch.envs import roadway_soa as rs

    n = cfg.n_agents
    counts = {k: torch.zeros((), dtype=torch.int64, device=dev)
              for k in ("live_car", "live_pair", "ttc_candidate",
                        "rejected_draw", "goal_reward")}

    def observe(s, drawn, taken, s2):
        live = [s.rem[i] == 0 for i in range(n)]
        for i in range(n):
            counts["live_car"] += live[i].sum()
            counts["rejected_draw"] += (live[i] & (taken[i] != drawn[i])).sum()
            # a live car has not collided before: coll is this step's crash
            counts["goal_reward"] += (live[i] & (s2.x[i] >= cfg.goal_pos[i])
                                      & (s2.coll[i] == 0)).sum()
            for j in range(n):
                if j == i:
                    continue
                lateral = (rs._y(cfg, s.sub[j]) - rs._y(cfg, s.sub[i])).abs()
                counts["ttc_candidate"] += (
                    live[i] & live[j] & (s.x[j] - s.x[i] > 0)
                    & (s.vel[j] < s.vel[i]) & (lateral < cfg.car_width)).sum()
                if j > i:
                    counts["live_pair"] += (live[i] & live[j]).sum()
    return observe, counts, None


def phase_soa_rollout(dev, name, mod, cfg, bench_fn, work, counter,
                      fed_cfgs=()):
    import torch

    n = cfg.n_agents
    gen = torch.Generator(device=dev).manual_seed(SEED)
    eps = lambda ep: (int(ep.min()), int(ep.max()))

    # fed actions at a ragged batch over several episodes, on the card,
    # from the bench's start and from any other start given
    fed_err = 0.0
    for what, c in [("", cfg)] + list(fed_cfgs):
        acts = torch.randint(0, 5, (SOA_FED_T, n, SOA_FED_B), device=dev,
                             dtype=torch.int32, generator=gen)
        k = mod.rollout_actions(c, acts)
        fed_err = max(fed_err, hold_rollout(
            k, mod.rollout_actions_plain(c, acts),
            f"fed B={SOA_FED_B} T={SOA_FED_T}{what}"))
        assert eps(k[1])[0] >= 2, "fewer than two episodes"

    # Philox draws: kernel == plain on the card; plain on the CPU
    k = mod.rollout_prng(cfg, SOA_PRNG_B, SOA_PRNG_T, SEED + 7, device=dev)
    prng_err = hold_rollout(
        k, mod.rollout_prng_plain(cfg, SOA_PRNG_B, SOA_PRNG_T, SEED + 7, dev),
        f"Philox B={SOA_PRNG_B} T={SOA_PRNG_T} card plain")
    cpu_err = hold_rollout(
        k, mod.rollout_prng(cfg, SOA_PRNG_B, SOA_PRNG_T, SEED + 7,
                            device="cpu"),
        f"Philox B={SOA_PRNG_B} T={SOA_PRNG_T} CPU plain", *SOA_CPU_TOL)
    log(f"  Philox: mean reward sum {float(k[0].mean()):.4f}, episodes "
        f"{eps(k[1])} (min, max)")

    # bench.py's figure at full size: the main path of this kernel
    mod.rollout_prng.launches = 0
    figure = bench_fn(SOA_B, SOA_T, SOA_REPS)
    launches = mod.rollout_prng.launches
    assert launches == 1 + SOA_REPS, (
        f"{name}: rollout_prng launched {launches} times in the bench, not "
        f"{1 + SOA_REPS}")

    # one bench-size call timed, then held against the plain version at
    # the same size and seed
    out = {}
    call = lambda: out.update(k=mod.rollout_prng(cfg, SOA_B, SOA_T, 99,
                                                 device=dev))
    call_ms = cuda_time_ms(call, 3, warmup=1)
    rew, ep = out["k"]
    assert rew.shape == (SOA_B,) and bool(torch.isfinite(rew).all())
    assert ep.shape == (SOA_B,) and int(ep.min()) >= 1
    plain = lambda: out.update(p=mod.rollout_prng_plain(cfg, SOA_B, SOA_T,
                                                        99, dev))
    plain_ms = cuda_time_ms(plain, 1, warmup=0)
    full_err = hold_rollout(out["k"], out["p"],
                            f"Philox B={SOA_B} T={SOA_T} seed 99")

    # the work the data decide, counted by the plain version on the same
    # inputs (its outputs held against the kernel's too); the resets are
    # the kernel's episodes
    observe, counted, describe = counter(cfg, dev)
    hold_rollout(out["k"], mod.rollout_prng_plain(cfg, SOA_B, SOA_T, 99, dev,
                                                  observe=observe),
                 f"Philox B={SOA_B} T={SOA_T} seed 99, counted")
    counts = {k: int(v) for k, v in counted.items()}
    counts.update(step=SOA_B * SOA_T, reset=int(ep.sum()))
    ops = sum(work[k][0] * counts[k] for k in work)
    mufu = sum(work[k][1] * counts[k] for k in work)

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    clock = _smi_max_sm_clock_hz()
    issue_ms = ops / (sms * WARP_INSTS_PER_CLOCK * 32 * clock) * 1e3
    mufu_ms = mufu / (sms * MUFU_LANES_PER_CLOCK * clock) * 1e3
    bound_ms = max(issue_ms, mufu_ms)
    steps = counts["step"]
    log(f"  {bench_fn.__name__} (B={SOA_B}, T={SOA_T}, reps {SOA_REPS}): "
        f"{figure:.6g} env-steps/s; {launches} launches (warm-up + reps)")
    log("  work per step of one instance (occurrences x operations, MUFU): "
        + "; ".join(f"{k} {counts[k] / steps:.6g} x {work[k][0]}, "
                    f"{work[k][1]}" for k in work)
        + f"; in all {ops / steps:.6g} operations, {mufu / steps:.6g} MUFU")
    if describe is not None:
        log("  " + describe())
    log(f"  kernel {call_ms:.3f} ms per call ({steps / call_ms * 1e3:.6g} "
        f"env-steps/s) against a bound of {bound_ms:.3f} ms, by "
        f"{'issue' if issue_ms >= mufu_ms else 'MUFU'} (issue: operations "
        f"/ ({sms} SMs x {WARP_INSTS_PER_CLOCK} warp-instructions x 32 at "
        f"{clock / 1e6:.0f} MHz) = {issue_ms:.3f} ms; MUFU: / ({sms} SMs x "
        f"{MUFU_LANES_PER_CLOCK} lanes) = {mufu_ms:.3f} ms), "
        f"{bound_ms / call_ms:.3f} of it")
    log(f"  plain {plain_ms:.1f} ms per call ({plain_ms / call_ms:.0f}x the "
        f"kernel; {plain_ms / SOA_T * 1e3:.1f} us per step of {SOA_B} "
        "instances); library: no single PyTorch call computes it")
    log_occupancy(mod, n)
    return {"launches": launches,
            "max_abs_err": max(fed_err, prng_err, cpu_err, full_err),
            "ms": call_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "operations", "library_ms": None}


def phase_particle(dev):
    from cm3_tpu_torch import bench
    from cm3_tpu_torch.core.config import ParticleEnvConfig
    from cm3_tpu_torch.ops import particle_rollout

    cfg = ParticleEnvConfig(prob_random=0.0, initial_std=0.0)
    near = ParticleEnvConfig(**PARTICLE_NEAR)
    return phase_soa_rollout(dev, "particle", particle_rollout, cfg,
                             bench.bench_particle_fused, PARTICLE_WORK,
                             particle_counter,
                             [(", start within contact range", near)])


def phase_roadway(dev):
    from cm3_tpu_torch import bench
    from cm3_tpu_torch.core.config import RoadwayEnvConfig
    from cm3_tpu_torch.ops import roadway_rollout

    cfg = RoadwayEnvConfig(depart_stdev=0.0)
    return phase_soa_rollout(dev, "roadway", roadway_rollout, cfg,
                             bench.bench_roadway_fused, ROADWAY_WORK,
                             roadway_counter)


# ------------------------------------------------------------------ #
# the tools
# ------------------------------------------------------------------ #


def _crc_table32c():
    """CRC32C's (Castagnoli's) table, built here: the event files'
    framing is checked against this copy, not the writer's."""
    tbl = []
    for n in range(256):
        c = n
        for _ in range(8):
            c = (c >> 1) ^ (0x82F63B78 if c & 1 else 0)
        tbl.append(c)
    return tbl


_CRC32C = _crc_table32c()


def _masked(data):
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC32C[(crc ^ b) & 0xFF] ^ (crc >> 8)
    crc ^= 0xFFFFFFFF
    return ((crc >> 15) | (crc << 17)) + 0xA282EAD8 & 0xFFFFFFFF


def _proto_fields(buf):
    """(field number, wire type, value) of a protobuf message: varints
    as ints, fixed64 / fixed32 as bytes, length-delimited as bytes."""
    i, out = 0, []
    while i < len(buf):
        key, i = _varint_at(buf, i)
        field, wire = key >> 3, key & 7
        if wire == 0:
            v, i = _varint_at(buf, i)
        elif wire == 1:
            v, i = buf[i:i + 8], i + 8
        elif wire == 5:
            v, i = buf[i:i + 4], i + 4
        elif wire == 2:
            n, i = _varint_at(buf, i)
            v, i = buf[i:i + n], i + n
        else:
            raise ValueError(f"wire type {wire}")
        out.append((field, wire, v))
    return out


def _varint_at(buf, i):
    shift = v = 0
    while True:
        b = buf[i]
        i += 1
        v |= (b & 0x7F) << shift
        shift += 7
        if not b & 0x80:
            return v, i


def read_events(log_dir):
    """The one TensorBoard event file in ``log_dir``, decoded without
    TensorBoard: each TFRecord's length and data CRCs checked, each
    Event's (step, [(tag, kind, scalar value or histogram num)]); the
    first record is the file version.  Returns (records, events)."""
    import struct
    files = [f for f in os.listdir(log_dir)
             if f.startswith("events.out.tfevents.")]
    assert len(files) == 1, files
    with open(os.path.join(log_dir, files[0]), "rb") as f:
        data = f.read()
    i, events, version = 0, [], None
    while i < len(data):
        hdr = data[i:i + 8]
        (n,) = struct.unpack("<Q", hdr)
        assert struct.unpack("<I", data[i + 8:i + 12])[0] == _masked(hdr)
        body = data[i + 12:i + 12 + n]
        assert struct.unpack("<I", data[i + 12 + n:i + 16 + n])[0] == \
            _masked(body), "a record's data CRC fails"
        i += 16 + n
        step, values = 0, []
        for field, _, v in _proto_fields(body):
            if field == 2:
                step = v
            elif field == 3:
                version = bytes(v)
            elif field == 5:
                for _, _, val in _proto_fields(v):
                    tag, kind, x = None, None, None
                    for fv, _, vv in _proto_fields(val):
                        if fv == 1:
                            tag = bytes(vv).decode()
                        elif fv == 2:
                            kind, x = "scalar", struct.unpack("<f", vv)[0]
                        elif fv == 5:
                            kind = "histo"
                            x = [struct.unpack("<d", hv)[0] for hf, _, hv
                                 in _proto_fields(vv) if hf == 3][0]
                    values.append((tag, kind, x))
        events.append((step, values))
    assert version == b"brain.Event:2" and not events[0][1]
    return len(events), events[1:]


def _tools_masters():
    """master.json with the paper's checkers_s2 settings at full width
    (16 envs, N_eval 10, a period of 100 episodes, fused, the actor
    frozen for its first 20 updates), summaries on, grafted from a
    stage-1 checkpoint of fresh parameters."""
    s1, s2, _ = _curriculum_masters()
    s1 = dict(s1, dir_name="tl_s1")
    s2 = dict(s2, dir_name="tl_s2", dir_restore="tl_s1", N_train=TL_EPISODES,
              summarize=1)
    return s1, s2


def _event_tags(events):
    """The tags of each period (the events of one step), in order."""
    steps = sorted({s for s, _ in events})
    return [[t for s, vals in events if s == step for t, _, _ in vals]
            for step in steps]


def _hold_tools_run(wd, d, ts, grads):
    """The run's event file: CRCs, and every histogram's count equal to
    its leaf's size (the state's, the gradients').  Returns (records,
    the tags of each period, the periods' steps)."""
    from cm3_tpu_torch import convert
    n_records, events = read_events(os.path.join(wd, "log", d))
    sizes = {"vars/" + k: v.size for k, v in convert.jax_leaves(ts)}
    sizes.update({"grads/" + k: v.size
                  for k, v in convert.jax_grad_leaves(ts, grads)})
    for _, vals in events:
        for tag, kind, x in vals:
            if kind == "histo":
                assert x == sizes[tag], (tag, x, sizes.get(tag))
    return n_records, _event_tags(events), sorted({s for s, _ in events})


def phase_tools(dev):
    import tempfile
    import xml.etree.ElementTree as ET
    import http.client
    import numpy as np
    import torch
    from cm3_tpu_torch.core import config, prng
    from cm3_tpu_torch.ops import fused_opt, polyak
    from cm3_tpu_torch.train import checkpoint, runner, tboard
    from cm3_tpu_torch.utils import live_viewer

    s1, s2 = _tools_masters()
    out = {}
    # the two stage-2 runs compared below: deterministic convolutions
    cudnn = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
        True, False
    try:
        with tempfile.TemporaryDirectory() as wd:
            _, alg1, _, _ = runner.build(s1, device=dev)
            checkpoint.save(os.path.join(wd, "saved", "tl_s1",
                                         "model_final"),
                            alg1.init_state(prng.root_key(s1["seed"])))
            # 1. checkers_s2 with summaries, then the same without, B1
            # and B3 counted in each
            runs = {}
            for on in (1, 0):
                m = dict(s2, summarize=on,
                         dir_name="tl_s2" if on else "tl_s2_off")
                torch.cuda.synchronize()
                fused_opt.adam_polyak.launches = 0
                polyak.polyak_update.launches = 0
                (ts, st), wall = _timed_run(
                    f"checkers_s2 (fused, frozen {CURR_FREEZE}), summarize "
                    f"{on}", lambda: runner.train_function(
                        m, wd, verbose=False, device=dev))
                torch.cuda.synchronize()
                runs[on] = (ts, st, fused_opt.adam_polyak.launches,
                            polyak.polyak_update.launches, wall)
            (ts_on, st_on, b1_on, b3_on, w_on) = runs[1]
            (ts_off, st_off, b1_off, b3_off, w_off) = runs[0]
            snaps = sum("_grads" in r for r in st_on["history"])
            log(f"  summaries: {snaps} gradient snapshots; adam_polyak "
                f"{b1_on} launches against {b1_off} without (+{b1_on - b1_off}"
                f"), polyak {b3_on} against {b3_off} (+{b3_on - b3_off}); "
                f"{w_on:.2f} s against {w_off:.2f} s")
            assert snaps == len(st_on["history"]) >= 1
            assert b1_on - b1_off == 2 * snaps and b3_on - b3_off == snaps
            assert int(ts_on.step) == int(ts_off.step) > CURR_FREEZE
            # summaries change no training: phase 3's tolerance
            alg2 = runner.build(s2, device=dev)[1]
            for name in alg2.net_names():
                for sfx in ("", "_tgt"):
                    torch.testing.assert_close(
                        getattr(ts_on, name + sfx).flat,
                        getattr(ts_off, name + sfx).flat, rtol=1e-4,
                        atol=1e-5)
                torch.testing.assert_close(
                    getattr(ts_on, "opt_" + name).mu,
                    getattr(ts_off, "opt_" + name).mu, rtol=1e-4, atol=1e-5)
            rows_on, rows_off = _rows(wd, "tl_s2"), _rows(wd, "tl_s2_off")
            assert len(rows_on) == len(rows_off) == len(st_on["history"])
            for a, b in zip(rows_on, rows_off):
                np.testing.assert_allclose(
                    np.array(a.split(","), float)[:-1],
                    np.array(b.split(","), float)[:-1], rtol=1e-4, atol=1e-5)
            # the event file, decoded here
            n_rec, tags, steps = _hold_tools_run(
                wd, "tl_s2", ts_on, st_on["history"][-1]["_grads"])
            assert steps == [r["episode"] for r in st_on["history"]]
            assert all(any(t.startswith("grads/") for t in tt) for tt in tags)
            # the same run's tags on the CPU (one update a chunk: the
            # tags do not depend on it), its first period
            cpu = dict(s2, N_train=s2["period"], updates_per_chunk=1,
                       dir_name="tl_s2_cpu")
            t0 = time.time()
            runner.train_function(cpu, wd, verbose=False, device="cpu")
            _, cpu_events = read_events(os.path.join(wd, "log",
                                                     "tl_s2_cpu"))
            cpu_tags = _event_tags(cpu_events)
            assert cpu_tags[0] == tags[0], "the card's tags are not the CPU's"
            log(f"  event file: {n_rec} records, CRCs hold, {len(tags[0])} "
                f"events a period at {steps} ({sum(t.startswith('vars/') for t in tags[0])} "
                f"vars, {sum(t.startswith('grads/') for t in tags[0])} grads "
                f"histograms), each histogram's count its leaf's size; the "
                f"tags equal the CPU run's ({time.time() - t0:.2f} s)")

            # a period's host cost of the summaries: the snapshot (its
            # device work included) and the writer, one seed
            row = dict(st_on["history"][-1])
            grads = row["_grads"]
            drv = runner.build(s2, device=dev)[0]
            snap_s = []
            for i in range(5):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                drv._grad_snapshot(ts_on, st_on["buffer"], 0.05,
                                   drv.snapshot_source(7, i, dev))
                torch.cuda.synchronize()
                snap_s.append(time.perf_counter() - t0)
            tb = tboard.SummaryWriter(os.path.join(wd, "timing"))
            write_s = []
            for _ in range(3):
                t0 = time.perf_counter()
                runner.write_summaries(tb, row, ts_on, grads)
                write_s.append(time.perf_counter() - t0)
            tb.close()
            nbytes = os.path.getsize(os.path.join(
                wd, "timing", os.listdir(os.path.join(wd, "timing"))[0]))
            out["snapshot_s"] = statistics.median(snap_s)
            out["write_s"] = statistics.median(write_s)
            log(f"  a period's summaries, one seed: the snapshot "
                f"{out['snapshot_s'] * 1e3:.2f} ms (median of 5, synced), "
                f"the writer {out['write_s']:.3f} s (median of 3; "
                f"{nbytes // 3} bytes a period)")

            # 2. three seeds in lockstep with summaries
            sv = dict(s2, dir_name="tl_seeds", vmapped_seeds=1, n_seeds=3,
                      N_train=TL_SEEDED)
            (ts_v, hist_v), _ = _timed_run(
                "3 seeds in lockstep, summarize 1",
                lambda: runner.train_multiseed(sv, wd, device=dev))
            for i in range(3):
                n_rec, ev = read_events(os.path.join(wd, "log",
                                                     f"tl_seeds_{i + 1}"))
                tags_i = _event_tags(ev)
                assert tags_i and all(any(t.startswith("grads/")
                                          for t in tt) for tt in tags_i)
            tb3 = [tboard.SummaryWriter(os.path.join(wd, "timing3", str(i)))
                   for i in range(3)]
            row3 = hist_v[-1]
            t0 = time.perf_counter()
            for i in range(3):
                r_i = {k: (np.asarray(v)[i] if np.ndim(v) >= 1
                           and np.shape(v)[0] == 3 else v)
                       for k, v in row3.items() if not k.startswith("_")}
                runner.write_summaries(tb3[i], r_i, ts_v, row3["_grads"],
                                       seed=i)
            out["write3_s"] = time.perf_counter() - t0
            for w in tb3:
                w.close()
            log(f"  lockstep: 3 event files decode, CRCs hold, grads/ at "
                f"every row; a period's writers for 3 seeds "
                f"{out['write3_s']:.3f} s")

            # 3. --render-only in a process of its own, from run 1's
            # model_final; particle and roadway from fresh states
            cfg = os.path.join(wd, "tools_master.json")
            with open(cfg, "w") as f:
                json.dump(s2, f)
            t0 = time.time()
            proc = subprocess.run(
                [sys.executable, "-m", "cm3_tpu_torch.train.runner",
                 "--config", cfg, "--workdir", wd, "--render-only",
                 "--render-episodes", "2"],
                cwd=os.path.dirname(os.path.abspath(__file__)),
                env=dict(os.environ, PYTHONDONTWRITEBYTECODE="1"),
                capture_output=True, text=True, timeout=120)
            assert proc.returncode == 0, proc.stderr[-2000:]
            paths = proc.stdout.strip().splitlines()[-2:]
            for p in paths:
                assert any(e.tag.endswith("animate")
                           for e in ET.parse(p).getroot().iter()), p
            others = []
            for exp, extra in (("particle", dict(
                    particle_config="stage2_antipodal")), ("roadway", {})):
                mm = dict(s2, experiment=exp, dir_name="tl_" + exp,
                          fused_opt=0, actor_freeze_updates=0, **extra)
                _, alg_x, _, _ = runner.build(mm, device=dev)
                others += runner.render_episodes(
                    mm, alg_x.init_state(prng.root_key(3)), wd, 1,
                    device=dev)
            for p in others:
                assert any(e.tag.endswith("animate")
                           for e in ET.parse(p).getroot().iter()), p
            log(f"  render: --render-only exited 0 in {time.time() - t0:.2f}"
                f" s (with particle and roadway) with "
                f"{[os.path.relpath(p, wd) for p in paths + others]}")

            # 4. the live viewer over the render root
            root = os.path.join(wd, "render")
            os.symlink(os.path.join(wd, "tools_master.json"),
                       os.path.join(root, "leak.svg"))
            srv, port = live_viewer.serve_background(root, 0)
            try:
                def get(path):
                    c = http.client.HTTPConnection("127.0.0.1", port,
                                                   timeout=10)
                    c.request("GET", path)
                    r = c.getresponse()
                    return r.status, r.read()
                listed = sorted(e["path"] for e in json.loads(
                    get("/list")[1]))
                want = sorted(os.path.relpath(p, root)
                              for p in paths + others)
                assert listed == want, (listed, want)
                assert get("/" + want[0])[0] == 200
                for bad in ("/../tools_master.json", "/tl_s2/../../x.svg",
                            "/leak.svg"):
                    assert get(bad)[0] == 404, bad
            finally:
                srv.shutdown()
                srv.server_close()
            log(f"  live viewer: /list names the {len(listed)} SVGs; '..' "
                "and a symlink out of the root get 404")

        # 5. roadway with occlusion: the card against the CPU over a
        # filtered 42-step episode, and the traffic surfaces
        import dataclasses
        from cm3_tpu_torch.envs.roadway import Roadway
        rng = np.random.default_rng(0)
        e = 256
        lanes, goals = rng.integers(0, 4, (e, 2)), rng.integers(0, 4, (e, 2))
        noise = rng.normal(size=(e, 2)).astype(np.float32)
        acts = rng.integers(0, 5, (42, e, 2))
        traj = {}
        for d in (dev, torch.device("cpu")):
            env = Roadway(dataclasses.replace(
                config.roadway_env_config(2, 0.5), occlusion=True), device=d)
            st, ts = env.reset(dict(lanes=torch.tensor(lanes),
                                    goal_lanes=torch.tensor(goals)),
                               torch.tensor(noise))
            traj[d.type] = []
            for a in acts:
                a = env.check_actions(st, torch.tensor(a))
                st, ts = env.step(st, a)
                traj[d.type].append((ts.obs["self_t"], env.avg_speeds(st),
                                     env.count_remaining(st),
                                     env.global_tensor(st, a)))
        shadowed, err = 0, 0.0
        for c, h in zip(traj["cuda"], traj["cpu"]):
            assert torch.equal(c[0][..., 0].cpu() == -1.0,
                               h[0][..., 0] == -1.0)
            shadowed += int((h[0][..., 0] == -1.0).sum())
            for x, y in zip(c, h):
                err = max(err, float((x.cpu().float() - y.float()).abs()
                                     .max()))
        assert shadowed > 0 and err <= 1e-5, (shadowed, err)
        log(f"  occlusion: {shadowed} shadowed cells over 42 filtered steps "
            f"of {e} roadway instances, the card's grids and traffic "
            f"surfaces within {err:.3g} of the CPU's (shadows exactly)")
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
            cudnn
    return out


# ------------------------------------------------------------------ #


# ------------------------------------------------------------------ #
# shard-local replay and the MPE suite
# ------------------------------------------------------------------ #


def sharded_parity(device):
    """The full-width Checkers stage-2 program (phase 2's, fused) with
    ``SH_SHARDS`` replay shards on the card and on the CPU from the same
    state with the same fed draws (each update's indices per shard,
    below its fill): a fill and a training chunk, held at phase 3's
    tolerance.  Returns (largest difference, B1 launches on the card)."""
    import dataclasses
    import numpy as np
    import torch
    from cm3_tpu_torch import bench
    from cm3_tpu_torch.core import prng
    from cm3_tpu_torch.core.tree import tree_leaves
    from cm3_tpu_torch.ops import fused_opt
    from cm3_tpu_torch.train.offpolicy import OffPolicyDriver

    d = SH_SHARDS
    rng = np.random.default_rng(SEED + 15)
    fill = [rng.integers(0, 5, (N_ENVS, 2)) for _ in range(STEPS)]
    act = [rng.gumbel(size=(N_ENVS, 2, 5)).astype(np.float32)
           for _ in range(STEPS)]
    per_shard = 2 * STEPS * N_ENVS // d
    idx = [rng.integers(0, per_shard, (d, BATCH // d))
           for _ in range(UPDATES)]
    upd = [rng.gumbel(size=(BATCH, 2, 5)).astype(np.float32)
           for _ in range(UPDATES)]
    out = {}
    for dev in (device, "cpu"):
        base, ts, _, rs, _ = bench.train_program(None, N_ENVS, True, dev,
                                                 seed=SEED)
        driver = OffPolicyDriver(base.hooks, base.alg, dataclasses.replace(
            base.cfg, replay_shards=d))
        buf = driver._replay_init(driver.example_transition(rs))
        draws = prng.FedDraws(fill + idx, act + upd, device=dev)
        before = fused_opt.adam_polyak.launches
        ts, buf, rs, _ = driver._chunk(ts, buf, rs, EPSILON, draws, False,
                                       True)
        ts, buf, rs, m = driver._chunk(ts, buf, rs, EPSILON, draws, True,
                                       False)
        assert draws.remaining() == {"randint": 0, "gumbel": 0}
        out[dev] = (ts, buf, rs, m, fused_opt.adam_polyak.launches - before)
    (ts_c, buf_c, rs_c, m_c, b1), (ts_h, buf_h, rs_h, m_h, _) = \
        out[device], out["cpu"]
    assert b1 == 2 * UPDATES, b1
    assert buf_h.size.tolist() == [per_shard] * d, buf_h.size
    assert torch.equal(buf_c.size.cpu(), buf_h.size)
    assert torch.equal(buf_c.insert.cpu(), buf_h.insert)
    pairs = []
    for name in ("actor", "actor_tgt", "qg", "qg_tgt", "qc", "qc_tgt"):
        pairs.append((getattr(ts_c, name).flat, getattr(ts_h, name).flat))
        if not name.endswith("_tgt"):
            o_c, o_h = (getattr(t, "opt_" + name) for t in (ts_c, ts_h))
            pairs += [(o_c.mu, o_h.mu), (o_c.nu, o_h.nu)]
    pairs += [(x.narrow(1, 0, per_shard), y.narrow(1, 0, per_shard))
              for (_, x), (_, y) in zip(tree_leaves(buf_c.data),
                                        tree_leaves(buf_h.data))]
    pairs += [(m_c[k], m_h[k]) for k in m_h]
    worst = 0.0
    for got, want in pairs:
        torch.testing.assert_close(got.cpu(), want, rtol=PARITY_RTOL,
                                   atol=PARITY_ATOL)
        if got.is_floating_point():
            worst = max(worst, float((got.cpu() - want).abs().max()))
    assert int(rs_c.episodes) == int(rs_h.episodes)
    log(f"  Checkers stage 2, {d} replay shards of {BUFFER // d} rows "
        f"(fused, full width, {N_ENVS} envs): card == CPU after a fill and "
        f"a training chunk of {UPDATES} updates ({BATCH // d} rows from "
        f"each shard; rtol {PARITY_RTOL}, atol {PARITY_ATOL}); max abs "
        f"difference {worst:.3g}; shard fills {buf_c.size.tolist()}; "
        f"adam_polyak {b1} launches")
    return worst, b1


def _shard_masters():
    """The paper's checkers_s2 (phase 9's: 16 envs, N_eval 10, a period
    of 100 episodes, fused, the actor frozen for 20 updates) grafted from
    a stage-1 checkpoint of fresh parameters, and roadway_s2 (grafted,
    dual buffer) likewise, each run with ``replay_shards``."""
    s1, s2, _ = _curriculum_masters()
    s1 = dict(s1, dir_name="sh_s1")
    s2 = dict(s2, dir_name="sh_s2", dir_restore="sh_s1", N_train=SH_EPISODES)
    r1, r2, _, _ = _roadway_masters()
    r1 = dict(r1, dir_name="sh_rd_s1")
    r2 = dict(r2, dir_name="sh_rd_s2", dir_restore="sh_rd_s1",
              N_train=SH_EPISODES, replay_shards=SH_DUAL_SHARDS)
    return s1, s2, r1, r2


def mpe_scenario(dev, name, i):
    """One MPE scenario at ``MPE_B`` instances for ``MPE_STEPS`` steps on
    each path (index: moves and comm symbols; multi-head: soft force
    vectors and comm vectors), from one reset drawn on the card: the
    steps timed alone (env-steps/s), then again with each step of the
    first ``MPE_CHECK`` instances repeated on the CPU from the card's
    state before it (the same draws), held at ``MPE_RTOL``/``MPE_ATOL``:
    positions, velocities, comm state, steps and done always; the
    observations and rewards of the instances whose collision flags
    agree (a flag that differs must lie within ``MPE_COLL_TOL`` of its
    threshold, |d - (s_i + s_j)|).  Returns {path: (env-steps/s, flags
    that differ, largest difference)}."""
    import torch
    from cm3_tpu_torch.core import prng
    from cm3_tpu_torch.envs import mpe

    env_c = mpe.MPEEnv(name, max_steps=MPE_STEPS, device=dev)
    env_h = mpe.MPEEnv(name, max_steps=MPE_STEPS, device="cpu")
    sc, w = env_h.scenario, env_h.scenario.world
    n = w.n_agents
    draws = prng.GeneratorDraws(prng.generator(
        prng.fold_in(prng.root_key(SEED), 150 + i), dev))
    reset = env_c.draw_reset((MPE_B,), draws)
    out = {}
    for path in ("index", "multihead"):
        if path == "index":
            acts = [(draws.randint((MPE_B, n), 5),
                     draws.randint((MPE_B, n), max(w.dim_c, 1)))
                    for _ in range(MPE_STEPS)]
            step = lambda env, s, a: env.step(s, *a)
        else:
            acts = [(draws.uniform((MPE_B, n, 5)),
                     draws.uniform((MPE_B, n, w.dim_c)) if w.dim_c
                     else None) for _ in range(MPE_STEPS)]
            step = lambda env, s, a: env.step_multihead(s, *a)
        s, _ = env_c.reset(reset)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for a in acts:
            s, _ = step(env_c, s, a)
        torch.cuda.synchronize()
        rate = MPE_B * MPE_STEPS / (time.perf_counter() - t0)
        assert bool(s.steps.eq(MPE_STEPS).all())

        head = lambda x: None if x is None else x[:MPE_CHECK].cpu()
        cut = lambda st: mpe.MPEState(**{f: head(getattr(st, f)) for f in (
            "pos", "vel", "c", "goal", "steps")})
        s, o = env_c.reset(reset)
        s_h, o_h = env_h.reset({k: head(v) for k, v in reset.items()})
        for x, y in zip((s.pos, o[0], o[1]), (s_h.pos, o_h[0], o_h[1])):
            torch.testing.assert_close(head(x), y, rtol=MPE_RTOL,
                                       atol=MPE_ATOL)
        flips = worst = 0
        dmin = mpe._consts(w, torch.device("cpu"))["dist_min"]
        for a in acts:
            prev = cut(s)
            s, (obs, rew, done) = step(env_c, s, a)
            s_h, (obs_h, rew_h, done_h) = step(
                env_h, prev, tuple(head(x) for x in a))
            got = cut(s)
            flip = sc._collide_mat(got) != sc._collide_mat(s_h)
            if flip.any():
                _, d = mpe._pair_deltas(s_h.pos)
                near = (d - dmin).abs()[flip]
                assert bool((near < MPE_COLL_TOL).all()), (
                    name, path, float(near.max()))
                flips += int(flip.sum())
            same = ~flip.flatten(-2).any(-1)
            pairs = [(got.pos, s_h.pos), (got.vel, s_h.vel),
                     (got.c, s_h.c), (head(obs)[same], obs_h[same]),
                     (head(rew)[same], rew_h[same])]
            for x, y in pairs:
                torch.testing.assert_close(x, y, rtol=MPE_RTOL,
                                           atol=MPE_ATOL)
                worst = max(worst, float((x - y).abs().max()))
            assert torch.equal(got.steps, s_h.steps)
            assert torch.equal(head(done), done_h)
        out[path] = (rate, flips, worst)
    return out


def phase_shards_mpe(dev):
    import tempfile
    import numpy as np
    import torch
    from cm3_tpu_torch.core import prng
    from cm3_tpu_torch.envs import mpe
    from cm3_tpu_torch.ops import fused_opt, polyak
    from cm3_tpu_torch.train import checkpoint, runner

    # 1. card against CPU: the plain ring in 4 shards, the dual buffer in 2
    worst = {"checkers_shards": sharded_parity(dev)[0]}
    for s in (None, PAR_SEEDS):
        worst[f"roadway_dual_shards{'' if s is None else '_seeds'}"] = \
            dual_parity(dev, "roadway", s, shards=SH_DUAL_SHARDS)[0]

    s1, s2, r1, r2 = _shard_masters()
    rates, counts = {}, {}
    with tempfile.TemporaryDirectory() as wd:
        for m in (s1, r1):
            _, alg1, _, _ = runner.build(m, device=dev)
            checkpoint.save(os.path.join(wd, "saved", m["dir_name"],
                                         "model_final"),
                            alg1.init_state(prng.root_key(m["seed"])))
        # 2. checkers_s2 with 4 shards and with 1, in turns; B1 and B3
        # counted in the sharded run (its main path)
        for d in (SH_SHARDS, 1):
            m = dict(s2, replay_shards=d, dir_name=f"sh_s2_d{d}")
            torch.cuda.synchronize()
            fused_opt.adam_polyak.launches = 0
            polyak.polyak_update.launches = 0
            (ts, st), wall = _timed_run(
                f"checkers_s2 (fused, frozen {CURR_FREEZE}), replay_shards "
                f"{d}", lambda: runner.train_function(m, wd, verbose=False,
                                                      device=dev))
            torch.cuda.synchronize()
            rates[f"checkers_s2_D{d}"] = st["episodes"] / wall
            steps = int(ts.step)
            counts[d] = (fused_opt.adam_polyak.launches,
                         polyak.polyak_update.launches)
            assert counts[d] == (2 * steps, steps), (counts[d], steps)
            assert steps > CURR_FREEZE
            assert np.isfinite(st["history"][-1]["r_eval_local"]).all()
            if d > 1:
                assert tuple(st["buffer"].size.shape) == (d,)
                log(f"    shard fills {st['buffer'].size.tolist()}; "
                    f"{steps} updates; adam_polyak {counts[d][0]} launches "
                    f"= 2 x {steps}, polyak {counts[d][1]} = {steps}")
        # 3. one K = 32 dispatch with the shards and no host sync
        k = dict(s2, n_envs=SH_SHARDS, replay_shards=SH_SHARDS,
                 chunks_per_sync=E1_K)
        _sync_free(dev, f"checkers_s2, {SH_SHARDS} envs in {SH_SHARDS} "
                   "shards", k)
        # 4. roadway_s2 with the dual buffer in 2 shards
        torch.cuda.synchronize()
        (ts, st), wall = _timed_run(
            f"roadway_s2 (grafted, dual buffer), replay_shards "
            f"{SH_DUAL_SHARDS}", lambda: runner.train_function(
                r2, wd, verbose=False, device=dev))
        row = st["history"][-1]
        buf = st["buffer"]
        assert (row["n_bad"], row["n_good"]) == (int(buf.bad.size.sum()),
                                                 int(buf.good.size.sum()))
        rates["roadway_s2_D2"] = st["episodes"] / wall
        log(f"    n_bad {row['n_bad']}, n_good {row['n_good']} (shards: "
            f"bad {buf.bad.size.tolist()}, good {buf.good.size.tolist()})")

    # 5. the nine MPE scenarios at 65,536 instances
    mpe_out = {}
    for i, name in enumerate(sorted(mpe.SCENARIOS)):
        mpe_out[name] = mpe_scenario(dev, name, i)
        log(f"  MPE {name}: " + "; ".join(
            f"{p} {r:.4g} env-steps/s, card == CPU on {MPE_CHECK} "
            f"instances one step at a time (max abs difference {e:.3g}; "
            f"{f} collision flags differ, each within {MPE_COLL_TOL} of "
            "its threshold)"
            for p, (r, f, e) in mpe_out[name].items()))
    log("  episodes/s: " + json.dumps({k: round(v, 2)
                                       for k, v in rates.items()}))
    log("  card == CPU, max abs differences: " + json.dumps(
        {k: float(f"{v:.3g}") for k, v in worst.items()}))
    b1, b3 = counts[SH_SHARDS]
    return {"b1": b1, "b3": b3,
            "err": max(worst.values()),
            "mpe_steps_per_s": {k: {p: round(v[0]) for p, v in o.items()}
                                for k, o in mpe_out.items()}}


# ------------------------------------------------------------------ #
# multi-process runs
# ------------------------------------------------------------------ #


def _free_port():
    import socket
    sock = socket.socket()
    sock.bind(("localhost", 0))
    port = sock.getsockname()[1]
    sock.close()
    return port


def _mp_program(dev, shards, mesh=None):
    """Phase 2's program with the replay in ``shards`` shards (one ring
    at 1): (driver, state, replay, rollout state, draw source) of the
    whole run, or on a data ``mesh`` this rank's block of it (the draw
    source stays the run's: the driver takes its block of each draw)."""
    import dataclasses
    from cm3_tpu_torch import bench
    from cm3_tpu_torch.parallel import mesh as meshlib
    from cm3_tpu_torch.train.offpolicy import OffPolicyDriver
    driver, ts, _, rs, draws = bench.train_program(None, N_ENVS, True, dev,
                                                   seed=SEED)
    driver = OffPolicyDriver(driver.hooks, driver.alg, dataclasses.replace(
        driver.cfg, replay_shards=shards))
    buf, rs = driver.init_replay(rs)
    if mesh is not None:
        ts, buf, rs = meshlib.shard_driver_state(mesh, ts, buf, rs, N_ENVS,
                                                 shards)
    return [driver, ts, buf, rs, draws]


def _mp_chunk(prog, train):
    driver, ts, buf, rs, draws = prog
    prog[1:4] = driver._chunk(ts, buf, rs, EPSILON, draws, train,
                              not train)[:3]
    return prog


def _mp_state(ts, names):
    out = {}
    for name in names:
        out[name] = getattr(ts, name).flat.cpu()
        out[name + "_tgt"] = getattr(ts, name + "_tgt").flat.cpu()
        out[name + ".mu"] = getattr(ts, "opt_" + name).mu.cpu()
        out[name + ".nu"] = getattr(ts, "opt_" + name).nu.cpu()
    return out


def _mp_data(dev, mesh, shards=MP_SHARDS):
    """2 fill chunks, then MP_HOLD training chunks with B1's launches and
    the collectives counted, the state after them (host copies), then
    MP_TIMED timed training chunks: a dict of them, the chunks' ms and
    the bytes one update all-reduces."""
    import torch
    from cm3_tpu_torch.ops import fused_opt
    from cm3_tpu_torch.parallel import mesh as meshlib
    prog = _mp_program(dev, shards, mesh)
    for _ in range(2):
        _mp_chunk(prog, False)
    torch.cuda.synchronize()
    fused_opt.adam_polyak.launches = 0
    meshlib.COUNTS.clear()
    for _ in range(MP_HOLD):
        _mp_chunk(prog, True)
    torch.cuda.synchronize()
    driver, ts = prog[:2]
    out = {"launches": fused_opt.adam_polyak.launches,
           "counts": dict(meshlib.COUNTS),
           "state": _mp_state(ts, driver.alg.net_names()),
           "episodes": int(prog[3].episodes), "ms": [],
           "allreduce_bytes": 4 * sum(
               getattr(ts, k).flat.numel() for k in driver.alg.net_names())}
    for _ in range(MP_TIMED):
        t0 = time.perf_counter()
        _mp_chunk(prog, True)
        torch.cuda.synchronize()
        out["ms"].append((time.perf_counter() - t0) * 1e3)
    return out


def _mp_stage1(dev):
    """(hooks, algorithm, TrainConfig) of stage 1 (one agent, optax) as
    phase 16 trains its seeds."""
    from cm3_tpu_torch.algs.cm3 import CM3
    from cm3_tpu_torch.core import config
    from cm3_tpu_torch.envs.checkers import Checkers
    from cm3_tpu_torch.train.experiments import make_hooks
    env = Checkers(config.checkers_env_config(1, max_steps=33), device=dev)
    alg = CM3("checkers", env.spec(), config.AlgConfig(n_agents=1, stage=1),
              config.checkers_nn_config(1), device=dev)
    cfg = config.TrainConfig(n_envs=MP_SEED_ENVS, updates_per_chunk=UPDATES,
                             pretrain_episodes=MP_SEED_PERIOD,
                             period=MP_SEED_PERIOD,
                             N_train=2 * MP_SEED_PERIOD, max_steps=33)
    return make_hooks("checkers", env), alg, cfg


def _mp_train_seeds(dev, n_seeds, **kw):
    """``train_vmapped_seeds`` of ``_mp_stage1``'s program under
    deterministic cuDNN: (the networks, [S, n] each, on the host; the
    period rows without their durations)."""
    import torch
    from cm3_tpu_torch.train.multiseed import train_vmapped_seeds
    hooks, alg, cfg = _mp_stage1(dev)
    torch.backends.cudnn.deterministic = True
    try:
        ts, rows = train_vmapped_seeds(hooks, alg, cfg, n_seeds, SEED, **kw)
    finally:
        torch.backends.cudnn.deterministic = False
    return ({n: getattr(ts, n).flat.cpu() for n in alg.net_names()},
            [{k: v for k, v in r.items() if k != "duration_s"}
             for r in rows])


def _mp_seeds(dev, mesh):
    """Stage 1 with MP_SEEDS seeds (over the seed ``mesh``): this rank's
    seeds' networks and the period rows."""
    return _mp_train_seeds(dev, MP_SEEDS, mesh=mesh)


class _TwinDraws:
    """The draws of a stack of two equal seeds: each [2, ...] draw is
    ``source``'s [1, ...] draw twice, so both seeds take the draws that a
    one-seed stack takes from a source of the same key."""

    def __init__(self, source):
        self.source = source

    def _twice(self, fn, shape, *args):
        import torch
        x = fn((1,) + tuple(shape[1:]), *args)
        return torch.cat([x, x])

    def randint(self, shape, high):
        return self._twice(self.source.randint, shape, high)

    def randint_below(self, shape, high):
        return self._twice(self.source.randint_below, shape, high[:1])

    def gumbel(self, shape):
        return self._twice(self.source.gumbel, shape)

    def uniform(self, shape, low=0.0, high=1.0):
        return self._twice(self.source.uniform, shape, low, high)

    def normal(self, shape):
        return self._twice(self.source.normal, shape)


def _mp_seed_witness(dev):
    """Seed 0 of ``_mp_seeds``' program with no mesh, from one state and
    one stream of draws, trained as a stack of one seed and as both
    seeds of a stack of two equal ones: (the one-seed stack's networks,
    the two-seed stack's)."""
    import numpy as np
    from cm3_tpu_torch.core import prng
    alg = _mp_stage1(dev)[1]
    key = prng.root_key(SEED)
    out = []
    for s, wrap in ((1, lambda d: d), (2, _TwinDraws)):
        draws = [wrap(prng.GeneratorDraws(prng.generator(prng.for_purpose(
            prng.fold_in(key, MP_SEEDS), purpose), dev)))
            for purpose in (prng.ROLLOUT, prng.EVAL)]
        out.append(_mp_train_seeds(
            dev, s, draws=draws[0], eval_draws=draws[1],
            resume=(alg.for_seeds(s).init_state([key] * s),
                    np.zeros(s, np.int64)))[0])
    return out


def mp_rank(spec_path, rank):
    """One of phase 16's two ranks on the card (gloo), in a process of
    its own: the data axis in 2 shards, then seeds over the ranks; its
    results written beside the spec."""
    import torch
    from cm3_tpu_torch.parallel import dist
    from cm3_tpu_torch.parallel import mesh as meshlib
    with open(spec_path) as f:
        spec = json.load(f)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    dist.initialize(f"localhost:{spec['port']}", 2, rank, device="cuda:0",
                    backend="gloo")
    data = _mp_data(dev, meshlib.make_mesh(2))
    seeds = _mp_seeds(dev, meshlib.make_mesh(2, axis="seed"))
    torch.save({"data": data, "seeds": seeds},
               os.path.join(spec["dir"], f"rank{rank}.pt"))
    torch.distributed.destroy_process_group()
    return 0


def _mp_close(got, want, what, rtol=PARITY_RTOL, atol=PARITY_ATOL):
    """Two trees of tensors, arrays and numbers: integers exactly, floats
    at phase 3's tolerance unless told; -> the largest float
    difference."""
    import numpy as np
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), what
        return max([_mp_close(got[k], want[k], f"{what}/{k}", rtol, atol)
                    for k in want] or [0.0])
    if isinstance(want, (list, tuple)):
        assert len(got) == len(want), what
        return max([_mp_close(g, w, f"{what}[{i}]", rtol, atol)
                    for i, (g, w) in enumerate(zip(got, want))] or [0.0])
    g, w = np.asarray(got), np.asarray(want)
    if not np.issubdtype(w.dtype, np.floating):
        np.testing.assert_array_equal(g, w, err_msg=what)
        return 0.0
    np.testing.assert_allclose(g, w, rtol=rtol, atol=atol, err_msg=what)
    return float(np.abs(g - w).max()) if g.size else 0.0


def _mp_within(a, b, rtol, atol):
    """Whether two dicts of float tensors agree at a tolerance, and the
    largest difference."""
    import numpy as np
    return (all(np.allclose(a[k].numpy(), b[k].numpy(), rtol=rtol,
                            atol=atol) for k in b),
            max(float((a[k] - b[k]).abs().max()) for k in b))


def _mp_bits(a, b, what):
    """Two dicts of tensors the same bytes."""
    import torch
    for k in a:
        assert torch.equal(a[k], b[k]), f"{what}: {k}"


def phase_multiprocess(dev):
    import tempfile
    import torch
    import torch.distributed as tdist
    from cm3_tpu_torch.parallel import mesh as meshlib

    held = 2 * UPDATES * MP_HOLD
    # two ranks sharing the card over gloo with CUDA tensors
    with tempfile.TemporaryDirectory() as tmp:
        spec = os.path.join(tmp, "spec.json")
        with open(spec, "w") as f:
            json.dump({"port": _free_port(), "dir": tmp}, f)
        t0 = time.time()
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--mp-rank", spec,
             str(r)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True, env=dict(os.environ, PYTHONDONTWRITEBYTECODE="1"))
            for r in range(2)]
        outs = []
        try:
            for p in procs:
                outs.append(p.communicate(timeout=MP_RANK_TIMEOUT)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for r, (p, out) in enumerate(zip(procs, outs)):
            assert p.returncode == 0, f"rank {r} failed:\n{out[-3000:]}"
        wall = time.time() - t0
        ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                            weights_only=False) for r in range(2)]
    d0, d1 = (r["data"] for r in ranks)
    _mp_bits(d0["state"], d1["state"], "the ranks' states")
    for d in (d0, d1):
        assert d["launches"] == held, d["launches"]
        assert d["counts"]["grad"] == held, d["counts"]
    single = _mp_data(dev, None)
    assert single["launches"] == held and single["counts"] == {}
    assert d0["episodes"] == single["episodes"]
    worst = _mp_close(d0["state"], single["state"], "2 ranks")
    (s0, rows0), (s1, rows1) = (r["seeds"] for r in ranks)
    assert _mp_close(rows1, rows0, "rows") == 0.0 and len(rows0) == 2
    seeds_single, rows = _mp_seeds(dev, None)
    row_worst = _mp_close(rows0, rows, "seed rows")
    seed_worst = max(
        _mp_close(st, {k: v[r:r + 1] for k, v in seeds_single.items()},
                  f"seed {r}", MP_SEED_RTOL, MP_SEED_ATOL)
        for r, st in enumerate((s0, s1)))
    # the witness of that drift, with no mesh: a one-seed stack against a
    # two-seed stack of the same seed, state and draws; and what a wrong
    # rank reads (its neighbour's twin; its own seed untrained), which
    # the tolerance must refuse
    one, two = _mp_seed_witness(dev)
    halves = all(torch.equal(v[0], v[1]) for v in two.values())
    witness = _mp_close(one, {k: v[:1] for k, v in two.items()},
                        "one seed against two", MP_SEED_RTOL, MP_SEED_ATOL)
    from cm3_tpu_torch.core import prng
    alg1 = _mp_stage1(dev)[1].for_seeds(1)
    untrained = alg1.init_state([prng.root_key(SEED)])
    wrong = {
        "neighbour's twin": _mp_within(
            s0, {k: v[1:2] for k, v in seeds_single.items()},
            MP_SEED_RTOL, MP_SEED_ATOL),
        "untrained": _mp_within(
            s0, {n: getattr(untrained, n).flat.cpu()
                 for n in alg1.net_names()}, MP_SEED_RTOL, MP_SEED_ATOL)}
    for what, (ok, _) in wrong.items():
        assert not ok, f"rank 0's seed passes against {what}"
    med = statistics.median
    log(f"  two ranks on the card (gloo, CUDA tensors; {N_ENVS // 2} envs "
        f"and B = {BATCH // 2} a rank, {MP_SHARDS} shards): {wall:.1f} s "
        f"with the processes' start; the ranks' states the same bytes; "
        f"== the single-process run after 2 fill and {MP_HOLD} training "
        f"chunks (rtol {PARITY_RTOL}, atol {PARITY_ATOL}; max abs "
        f"difference {worst:.3g}); adam_polyak {d0['launches']} launches a "
        f"rank (2 an update); collectives a rank {d0['counts']}; "
        f"{d0['allreduce_bytes']} bytes all-reduced an update; a rank's "
        f"training chunk {med(d0['ms']):.2f} / {med(d1['ms']):.2f} ms "
        f"(median of {MP_TIMED}), the single-process chunk "
        f"{med(single['ms']):.2f} ms")
    log(f"  seeds over the two ranks (stage 1, optax, {MP_SEEDS} seeds x "
        f"{MP_SEED_ENVS} envs, {len(rows0)} period rows): rows the same on "
        f"both ranks and == the single-process {MP_SEEDS}-seed run's (phase "
        f"3's tolerance, max abs difference {row_worst:.3g}), each rank's "
        f"seed == its twin (rtol {MP_SEED_RTOL}, atol {MP_SEED_ATOL}; max "
        f"abs difference {seed_worst:.3g}); episodes "
        f"{rows0[-1]['episode'].tolist()}; no mesh, a one-seed stack "
        f"against a two-seed stack of the same seed: max abs difference "
        f"{witness:.3g} (the stack's two seeds the same bytes: {halves}); "
        f"refused as wrong: "
        + ", ".join(f"{k} (max abs difference {d:.3g})"
                    for k, (_, d) in wrong.items()))

    # world size 1 over NCCL in this process
    tdist.init_process_group("nccl", init_method="tcp://localhost:"
                             f"{_free_port()}", world_size=1, rank=0)
    try:
        mesh = meshlib.make_mesh(1)
        torch.backends.cudnn.deterministic = True
        try:
            plain, meshed = _mp_data(dev, None, 1), _mp_data(dev, mesh, 1)
        finally:
            torch.backends.cudnn.deterministic = False
        _mp_bits(meshed["state"], plain["state"], "world size 1")
        assert meshed["launches"] == plain["launches"] == held
        assert meshed["counts"]["grad"] == held, meshed["counts"]
        progs = {"mesh": _mp_program(dev, 1, mesh),
                 "no mesh": _mp_program(dev, 1)}
        for prog in progs.values():
            for train in (False, False, True):
                _mp_chunk(prog, train)
        turns = {k: [] for k in progs}
        for i in range(MP_TURNS):
            for k in (("mesh", "no mesh") if i % 2 == 0
                      else ("no mesh", "mesh")):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                _mp_chunk(progs[k], True)
                torch.cuda.synchronize()
                turns[k].append((time.perf_counter() - t0) * 1e3)
    finally:
        tdist.destroy_process_group()
    log(f"  world size 1 over NCCL, one ring: == no mesh bit for bit "
        f"(deterministic cuDNN) after 2 fill and {MP_HOLD} training chunks; "
        f"adam_polyak {meshed['launches']} launches; collectives "
        f"{meshed['counts']}; training chunk in turns ({MP_TURNS} each): "
        + ", ".join(f"{k} median {med(v):.2f} ms (min {min(v):.2f}, max "
                    f"{max(v):.2f})" for k, v in turns.items()))
    return {"b1": d0["launches"]}


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    try:
        import cm3_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script ({e})",
              file=sys.stderr)
        return 1
    if sys.argv[1:2] == ["--mp-rank"]:
        return mp_rank(sys.argv[2], int(sys.argv[3]))
    # the Checkers nets are convolutional; learning runs pin float32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = smi_line()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    phases = [
        ("0 build", 30, phase_build),
        ("1 kernel vs plain", 45, phase_kernel, dev),
        ("2 the slice", 10, phase_slice, dev),
        ("3 card vs CPU", 10, phase_parity, dev),
        ("4 fused Checkers rollout", 73, phase_rollout, dev),
        ("5 polyak", 10, phase_polyak, dev),
        ("6 fused particle rollout", 80, phase_particle, dev),
        ("7 fused roadway rollout", 48, phase_roadway, dev),
        ("8 seed-batched training", 37, phase_seeded, dev),
        ("9 the curriculum through the runner", 120, phase_curriculum, dev),
        ("10 the baselines and QMIX", 112, phase_baselines, dev),
        ("11 particle through the runner", 93, phase_particle_runner, dev),
        ("12 roadway and the dual buffer through the runner", 67,
         phase_roadway_runner, dev),
        ("13 the single-env cells through the runner", 251, phase_e1, dev),
        ("14 the tools", 73, phase_tools, dev),
        ("15 shard-local replay and MPE", 61, phase_shards_mpe, dev),
        ("16 multi-process runs", 60, phase_multiprocess, dev),
    ]
    out = {name.split()[0]: run_phase(name, budget, fn, *args)
           for name, budget, fn, *args in phases}
    (kern, launches, rollout, soft, particle, roadway, frozen, pt, rd, e1,
     sh, mp) = (out[k] for k in ("1", "2", "4", "5", "6", "7", "9", "11",
                                 "12", "13", "15", "16"))
    log(f"all phases done at {time.time() - T0:.1f} s")

    keys = ("launches", "max_abs_err", "ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms")
    log(json.dumps({"kernels": [
        dict(name="adam_polyak", route="cuda",
             source="cm3_tpu_torch/csrc/flat_update.cu",
             replaces="cm3_tpu/ops/fused_opt.py:100", launches=launches,
             particle_onpolicy_launches=pt["b1"], roadway_launches=rd["b1"],
             kchunk_launches=e1["b1"], shards_launches=sh["b1"],
             multiprocess_launches=mp["b1"],
             pred_ms=kern["pred_ms"], wrapper_ms=kern["wrapper_ms"],
             wrapper_b2b_ms=kern["wrapper_b2b_ms"],
             **{k: max(kern[k], e1["err"]) if k == "max_abs_err" else kern[k]
                for k in keys[1:]}),
        dict(name="checkers_rollout", route="cuda",
             source="cm3_tpu_torch/csrc/checkers_rollout.cu",
             replaces="cm3_tpu/ops/checkers_rollout.py:75",
             **{k: rollout[k] for k in keys}),
        dict(name="polyak", route="cuda",
             source="cm3_tpu_torch/csrc/flat_update.cu",
             replaces="cm3_tpu/ops/polyak.py:58", launches=frozen,
             particle_onpolicy_launches=pt["b3"], roadway_launches=rd["b3"],
             kchunk_launches=e1["b3"], shards_launches=sh["b3"],
             pred_ms=soft["pred_ms"],
             **{k: max(soft[k], e1["err"]) if k == "max_abs_err" else soft[k]
                for k in keys[1:]}),
        dict(name="particle_rollout", route="cuda",
             source="cm3_tpu_torch/csrc/particle_rollout.cu",
             replaces="cm3_tpu/ops/particle_rollout.py:64",
             **{k: particle[k] for k in keys}),
        dict(name="roadway_rollout", route="cuda",
             source="cm3_tpu_torch/csrc/roadway_rollout.cu",
             replaces="cm3_tpu/ops/roadway_rollout.py:83",
             **{k: roadway[k] for k in keys}),
    ]}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
