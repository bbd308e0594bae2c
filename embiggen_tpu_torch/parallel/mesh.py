"""The port's device mesh — counterpart of `embiggen_tpu/parallel/mesh.py`
(`make_mesh`, `resolve_mesh`) for PyTorch's one-process-per-rank idiom.

JAX runs one program over several devices in one process; here every rank
is a process (`torchrun`, or `torch.multiprocessing`) with one device, and a
`Mesh` is a 1-D `torch.distributed` process group seen from one rank: the
group, this rank's index and the group's size, the rank's device and the
axis name. NCCL carries CUDA tensors, gloo CPU tensors; a CUDA tensor on a
gloo group raises, and nothing is staged through the host. A collective
that fails raises.

The collective helpers below are the only places the port calls
`torch.distributed`; each checks that the tensor's device suits the group's
backend.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D mesh of `size` ranks over `group` (None: the default group),
    seen from rank `rank`, whose tensors live on `device`."""

    group: Optional[object]
    rank: int
    size: int
    device: torch.device
    axis_name: str = "data"

    @property
    def backend(self) -> str:
        return str(dist.get_backend(self.group))

    def check(self, t: torch.Tensor) -> None:
        """Raise unless `t` may take part in this mesh's collectives: a CUDA
        tensor needs NCCL, a CPU tensor gloo."""
        backend = self.backend
        if t.device.type == "cuda" and backend != "nccl":
            raise ValueError(f"a CUDA tensor cannot go through the {backend} "
                             "backend; use NCCL for CUDA tensors.")
        if t.device.type == "cpu" and backend == "nccl":
            raise ValueError("a CPU tensor cannot go through NCCL; use gloo for "
                             "CPU tensors.")


def _rank_device(backend: str) -> torch.device:
    if backend != "nccl":
        return torch.device("cpu")
    local = int(os.environ.get("LOCAL_RANK", dist.get_rank() % torch.cuda.device_count()))
    return torch.device("cuda", local)


_SUBGROUPS: Dict[int, object] = {}


def make_mesh(axis_name: str = "data", size: Optional[int] = None,
              device: Optional[torch.device] = None) -> Mesh:
    """A mesh over the first `size` ranks of the initialized default group
    (all of them by default). Every rank must call it (a smaller mesh makes
    a subgroup, which is collective); a rank outside the first `size`
    raises. `device` defaults to cuda:LOCAL_RANK under NCCL, else the CPU."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("make_mesh needs an initialized torch.distributed group "
                           "(see parallel.distributed.initialize_distributed).")
    world = dist.get_world_size()
    size = world if size is None else int(size)
    if not 1 <= size <= world:
        raise ValueError(f"a mesh of {size} ranks in a world of {world}.")
    group = None
    if size < world:
        if size not in _SUBGROUPS:
            _SUBGROUPS[size] = dist.new_group(ranks=list(range(size)))
        group = _SUBGROUPS[size]
        if dist.get_rank() >= size:
            raise ValueError(f"rank {dist.get_rank()} is not in the first {size} ranks.")
    backend = str(dist.get_backend(group))
    return Mesh(group=group, rank=dist.get_rank(group), size=size,
                device=torch.device(device) if device is not None else _rank_device(backend),
                axis_name=axis_name)


def resolve_mesh(mesh, axis: str = "data") -> Optional[Mesh]:
    """Normalize the `mesh` argument the distributable models take, as the
    reference does:

    - None   -> None (single-device training);
    - a Mesh -> itself, or None for a mesh of one rank;
    - "auto" -> a mesh over the whole world (None when the world is one
      rank or torch.distributed is not initialized);
    - int n  -> None for n <= 1, a mesh over the first n ranks, ValueError
      above the world size;
    - anything else: TypeError."""
    if mesh is None:
        return None
    if isinstance(mesh, Mesh):
        return mesh if mesh.size > 1 else None
    initialized = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if initialized else 1
    if isinstance(mesh, str) and mesh == "auto":
        return make_mesh(axis) if world > 1 else None
    if isinstance(mesh, int) and not isinstance(mesh, bool):
        if mesh > world:
            raise ValueError(f"mesh={mesh} ranks requested but the world has {world}.")
        if mesh <= 1:
            return None
        return make_mesh(axis, size=mesh)
    raise TypeError(f"mesh must be None, 'auto', an int or a Mesh; got "
                    f"{type(mesh).__name__}.")


# ------------------------------------------------------------- collectives
def all_reduce(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Sum `t` over the mesh, in place; returns it."""
    mesh.check(t)
    dist.all_reduce(t, group=mesh.group)
    return t


def all_gather(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The ranks' equally shaped `t` concatenated along dim 0 in rank
    order."""
    mesh.check(t)
    t = t.contiguous()
    parts: List[torch.Tensor] = [torch.empty_like(t) for _ in range(mesh.size)]
    dist.all_gather(parts, t, group=mesh.group)
    return torch.cat(parts)


def all_to_all(send: torch.Tensor, mesh: Mesh,
               out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Block p of `send` (equal blocks along dim 0) goes to rank p; block q
    of the result came from rank q. Into `out` when given."""
    mesh.check(send)
    send = send.contiguous()
    out = torch.empty_like(send) if out is None else out
    dist.all_to_all_single(out, send, group=mesh.group)
    return out
