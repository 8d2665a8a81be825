"""Process groups (counterpart of vitax/parallel/distributed.py).

vitax spans hosts with `jax.distributed.initialize` and drives every device
of a host from one process. The port runs one process per card, as
`torchrun --nproc_per_node N` starts them, joined by `torch.distributed`:
NCCL between cards, gloo for CPU callers (the tests). `init_distributed()`
reads torchrun's environment and is a no-op without it, as vitax's is
without a coordinator, so a one-process run is unchanged; a process group
that the caller already started is left as it is.

`all_reduce` is the one collective of the training and eval paths (with
`torch.distributed.broadcast`, the collectives gloo also takes on CUDA
tensors); it counts its calls in `all_reduce.launches`, as the kernel
wrappers count theirs.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist


def local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", 0))


def local_device() -> torch.device:
    """The card of this process: cuda:LOCAL_RANK (cuda:0 without torchrun)."""
    return torch.device("cuda", local_rank())


def initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    return dist.get_world_size() if initialized() else 1


def rank() -> int:
    return dist.get_rank() if initialized() else 0


def init_distributed(device: Optional[torch.device | str] = None) -> bool:
    """Join the process group torchrun describes (MASTER_ADDR, MASTER_PORT,
    WORLD_SIZE, RANK; LOCAL_RANK names the card): NCCL when `device` is a
    card (cuda:LOCAL_RANK by default), gloo when it is the CPU. Returns
    whether a process group is up: True when the caller started one (left
    as it is), False without torchrun's environment (nothing to do)."""
    if initialized():
        return True
    if "WORLD_SIZE" not in os.environ or "MASTER_ADDR" not in os.environ:
        return False
    device = torch.device(device) if device is not None else local_device()
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                            init_method="env://")
    return True


def process_info() -> dict:
    return {
        "process_index": rank(),
        "process_count": world_size(),
        "local_rank": local_rank(),
        "backend": dist.get_backend() if initialized() else None,
        "local_device_count": torch.cuda.device_count(),
    }


def all_reduce(t: torch.Tensor, group=None) -> torch.Tensor:
    """Sum `t` in place over the ranks of `group` (every rank of it calls
    this with a tensor of the same shape and dtype) and return it."""
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    all_reduce.launches += 1
    return t


all_reduce.launches = 0
