"""Multi-process bring-up and holdout-level parallelism — counterpart of
`embiggen_tpu/parallel/distributed.py` (`initialize_distributed`,
`holdout_belongs_to_this_worker`), with torch.distributed's world in place
of JAX's processes."""
from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> bool:
    """Initialize torch.distributed's default group; a no-op when no
    coordinator is configured. Returns True when the world has several
    processes.

    The coordinator is `coordinator_address` or EMBIGGEN_TPU_COORDINATOR (a
    host:port, or a tcp://, file:// or env:// address); the world size and rank are
    the arguments, else WORLD_SIZE and RANK (as torchrun sets them). The
    backend is NCCL when CUDA is available, else gloo; under NCCL the rank
    binds to cuda:LOCAL_RANK."""
    address = coordinator_address or os.environ.get("EMBIGGEN_TPU_COORDINATOR")
    if address is None:
        return False
    if "://" not in address:
        address = f"tcp://{address}"
    world = int(num_processes if num_processes is not None else os.environ.get("WORLD_SIZE", 1))
    rank = int(process_id if process_id is not None else os.environ.get("RANK", 0))
    backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank % torch.cuda.device_count())))
    dist.init_process_group(backend, init_method=address, world_size=world, rank=rank)
    return world > 1


def holdout_belongs_to_this_worker(
    holdout_number: int,
    number_of_workers: Optional[int] = None,
    worker_id: Optional[int] = None,
) -> bool:
    """Whether this worker evaluates holdout `holdout_number`: holdout h
    goes to worker h mod the number of workers. Worker identity comes from
    the arguments, else from EMBIGGEN_TPU_WORKER_{COUNT,ID}, else from an
    initialized torch.distributed group (world size and rank); otherwise
    there is one worker."""
    if number_of_workers is None:
        number_of_workers = int(os.environ.get("EMBIGGEN_TPU_WORKER_COUNT", 0))
    if worker_id is None:
        worker_id = int(os.environ.get("EMBIGGEN_TPU_WORKER_ID", 0))
    if not number_of_workers:
        if dist.is_available() and dist.is_initialized():
            number_of_workers = dist.get_world_size()
            worker_id = dist.get_rank()
        else:
            number_of_workers, worker_id = 1, 0
    if number_of_workers <= 1:
        return True
    return holdout_number % number_of_workers == worker_id % number_of_workers
