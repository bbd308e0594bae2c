"""Round-robin assignment of independent holdouts to workers — counterpart
of `embiggen_tpu/parallel/distributed.py::holdout_belongs_to_this_worker`,
with torch.distributed's world in place of JAX's processes."""
from __future__ import annotations

import os
from typing import Optional

import torch.distributed as dist


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
