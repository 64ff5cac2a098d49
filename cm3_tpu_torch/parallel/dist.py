"""Multi-process bootstrap and per-process keys (``cm3_tpu.parallel.dist``)
on ``torch.distributed``.

The JAX package runs one controller per host over a global mesh
(``jax.distributed``).  The port runs one process per device, PyTorch's
idiom, which ``torchrun`` launches: ``initialize`` joins the processes
into one group (NCCL on GPUs, gloo on the CPU), each process drives
its own device, and ``parallel/mesh.py`` names the axis its tensors
split along.  Only the primary process (rank 0) writes logs and
checkpoints, as JAX's host 0 does.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

from cm3_tpu_torch.core import prng

_DEVICE: Optional[torch.device] = None


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, device="cuda",
               backend: Optional[str] = None) -> None:
    """Join this process to the run's process group; a no-op for one
    process (``dist.py:26-40``).  Without arguments it reads
    ``torchrun``'s ``MASTER_ADDR`` / ``MASTER_PORT`` / ``WORLD_SIZE`` /
    ``RANK`` where JAX reads ``JAX_COORDINATOR_ADDRESS``; the
    coordinator is "host:port".  The process's device is ``device``:
    "cuda" means ``cuda:{LOCAL_RANK}``, "cpu" the CPU, and a device with
    an index is taken as given (two processes on one card).  The backend
    is NCCL for a CUDA device and gloo for the CPU unless ``backend``
    names one (gloo over CUDA tensors, for processes sharing a card,
    which NCCL refuses)."""
    global _DEVICE
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    _DEVICE = dev
    world = (num_processes if num_processes is not None
             else int(os.environ.get("WORLD_SIZE", 1)))
    if world <= 1 or dist.is_initialized():
        return
    if coordinator_address is None:
        coordinator_address = (f"{os.environ['MASTER_ADDR']}:"
                               f"{os.environ['MASTER_PORT']}")
    rank = (process_id if process_id is not None
            else int(os.environ["RANK"]))
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend or ("nccl" if dev.type == "cuda" else "gloo"),
        init_method=f"tcp://{coordinator_address}", world_size=world,
        rank=rank)


def device() -> torch.device:
    """This process's device: the one ``initialize`` took, else
    ``cuda``'s current device where there is one, else the CPU."""
    if _DEVICE is not None:
        return _DEVICE
    if torch.cuda.is_available():
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def host_key(seed: int) -> int:
    """The root key folded by the process index: each process owns a
    deterministic stream; what all processes must agree on (the global
    draws, the parameters) uses the unfolded key (``dist.py:43-46``)."""
    return prng.for_host(prng.root_key(seed), process_index())


def is_primary() -> bool:
    return process_index() == 0


def global_device_count() -> int:
    """Devices over all processes: one a process."""
    return dist.get_world_size() if dist.is_initialized() else 1


def local_device_count() -> int:
    """Devices this process drives: one."""
    return 1
