"""Data-parallel training of the port over processes, one device each,
launched by ``torchrun``:

    # two gloo ranks on the CPU
    torchrun --nproc-per-node 2 scripts/torch_data_parallel.py --device cpu
    # NCCL, one rank per GPU of the host
    torchrun --nproc-per-node 8 scripts/torch_data_parallel.py

Checkers stage 2 CM3 at ``checkers_stage2.json``'s widths, the
``--n-envs`` instances split over the ranks and the replay in one shard
a rank, through ``OffPolicyDriver.run(..., mesh=)``: ``dist.initialize``
reads torchrun's ``MASTER_ADDR`` / ``MASTER_PORT`` / ``WORLD_SIZE`` /
``RANK`` / ``LOCAL_RANK``, every rank draws the run's draws and trains on
its block, each backward's gradient is averaged over the ranks, and the
primary process prints each period row and, last, one JSON line with the
greedy evaluation (the same on every rank)."""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--device", default="cuda", help="cuda or cpu")
    p.add_argument("--n-envs", type=int, default=16)
    p.add_argument("--episodes", type=int, default=120)
    p.add_argument("--period", type=int, default=40)
    p.add_argument("--max-steps", type=int, default=20)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    import torch
    from cm3_tpu_torch.algs.cm3 import CM3
    from cm3_tpu_torch.core import config, prng
    from cm3_tpu_torch.envs.checkers import Checkers
    from cm3_tpu_torch.parallel import dist
    from cm3_tpu_torch.parallel import mesh as meshlib
    from cm3_tpu_torch.train.experiments import make_hooks
    from cm3_tpu_torch.train.offpolicy import OffPolicyDriver

    dist.initialize(device=args.device)
    mesh = meshlib.make_mesh()
    dev = dist.device()
    env = Checkers(config.checkers_env_config(2, max_steps=args.max_steps),
                   device=dev)
    alg = CM3("checkers", env.spec(), config.AlgConfig(n_agents=2, stage=2),
              config.checkers_nn_config(2), device=dev)
    cfg = config.TrainConfig(
        n_envs=args.n_envs, batch_size=2 * args.n_envs,
        buffer_size=16 * args.n_envs, steps_per_train=5,
        updates_per_chunk=2, max_steps=args.max_steps,
        pretrain_episodes=args.n_envs, period=args.period, N_eval=10,
        replay_shards=mesh.size)
    driver = OffPolicyDriver(make_hooks("checkers", env), alg, cfg)

    def log(row):
        print(json.dumps({k: (v.tolist() if hasattr(v, "tolist") else v)
                          for k, v in row.items() if not k.startswith("_")}),
              flush=True)

    ts, stats = driver.run(alg.init_state(prng.root_key(args.seed)),
                           key=args.seed, n_episodes=args.episodes,
                           log_fn=log, mesh=mesh)
    r_local, r_global, _ = driver.evaluate(ts, prng.GeneratorDraws(
        prng.generator(prng.for_purpose(prng.root_key(args.seed),
                                        prng.EVAL), dev)), 16)
    if dist.is_primary():
        print(json.dumps({"ranks": mesh.size, "episodes": stats["episodes"],
                          "updates": int(ts.step),
                          "r_eval_local": r_local.tolist(),
                          "r_eval_global": float(r_global)}), flush=True)
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
