"""One gloo rank of the port's multi-process tests (started by
``torch_dist_cases.launch``): joins the group on localhost, runs every
case of the spec on its mesh and writes its results beside the spec.
DEVICE is "cpu", or a card the ranks share ("cuda:0": gloo over CUDA
tensors, since NCCL refuses two ranks on one GPU).

    python tests/torch_dist_worker.py SPEC PORT RANK WORLD DEVICE
"""

import os
import pickle
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
# the checkout's root for the port, and this directory for the cases (by
# their own name: another package named ``tests`` may be installed)
sys.path[:0] = [os.path.dirname(HERE), HERE]


def main():
    spec, port, rank, world, device = sys.argv[1:6]
    import torch
    torch.set_num_threads(1)
    # the nets' float32, as the single-process runs on the card keep it
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    from cm3_tpu_torch.parallel import dist
    import torch_dist_cases as cases
    dist.initialize(f"localhost:{port}", int(world), int(rank),
                    device=device, backend="gloo")
    with open(spec, "rb") as f:
        todo = pickle.load(f)
    cases.run_cases(todo, os.path.dirname(spec), int(rank), int(world))
    torch.distributed.destroy_process_group()
    print(f"RANK{rank} OK", flush=True)


if __name__ == "__main__":
    main()
