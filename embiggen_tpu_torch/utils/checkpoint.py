"""Mid-training checkpoints — counterpart of
`embiggen_tpu/utils/checkpoint.py`, wired into the walk embedders'
(`WalkBasedEmbedder._fit_transform`), the minibatch embedders'
(`MinibatchEmbedder._fit_transform`) and the GCNs' (`TrainLoop.run`) epoch
loops, so a killed fit resumes to the uninterrupted fit's result.

Format: one `.npz` of host arrays, written to a temporary file and renamed
into place, so a kill never leaves half a checkpoint. A tree is nested dicts
(keys sorted), lists and tuples; its leaves are tensors (copied to the host
first), numpy arrays and scalars. A `__fingerprint__` entry ties the file to
its run: a checkpoint written by another run is ignored with a warning, and
a fit deletes its checkpoint when it completes.

A fit's draws come from its `torch.Generator`s and, on the card, from the
Philox key and counter offset of its `BatchDraws`; `RandomState` carries
both through a checkpoint. On the CPU a resumed fit equals the uninterrupted
one bit for bit; on the card two uninterrupted fits already differ in the
last bits, as the kernels that add into sums use float atomics.
"""
from __future__ import annotations

import os
import warnings
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch


def checkpoint_exists(path: str) -> bool:
    """True if `save_pytree(path, ...)` wrote a checkpoint here."""
    return os.path.exists(os.path.abspath(path) + ".npz")


def checkpoint_matches(path: str, fingerprint: Optional[str]) -> bool:
    """True if the checkpoint at `path` exists and carries `fingerprint`. A
    checkpoint without a stored fingerprint matches only `fingerprint=None`."""
    path = os.path.abspath(path)
    if not os.path.exists(path + ".npz"):
        return False
    try:
        with np.load(path + ".npz") as data:
            stored = (str(data["__fingerprint__"])
                      if "__fingerprint__" in data.files else None)
    except Exception:
        return False
    return stored == fingerprint


def delete_checkpoint(path: str) -> None:
    """Remove a checkpoint written by `save_pytree` (nothing if absent), so a
    completed run is never taken for a resumable one."""
    path = os.path.abspath(path) + ".npz"
    if os.path.exists(path):
        os.remove(path)


def _flatten(tree) -> List[Any]:
    """The leaves of `tree` in a fixed order (dict keys sorted; None holds
    no leaf)."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _flatten(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for item in tree for leaf in _flatten(item)]
    return [tree]


def _unflatten(like, leaves):
    """`like`'s structure with the next leaves of the iterator `leaves`; a
    tensor leaf of `like` takes its dtype's bits back on its device."""
    if like is None:
        return None
    if isinstance(like, dict):
        return {k: _unflatten(like[k], leaves) for k in sorted(like)}
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(item, leaves) for item in like)
    arr = next(leaves)
    if isinstance(like, torch.Tensor):
        # np.array keeps a 0-d leaf 0-d (np.ascontiguousarray would not).
        return torch.from_numpy(np.array(arr)).to(like.device)
    return arr


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save_pytree(path: str, pytree: Any, backend: str = "npz",
                fingerprint: Optional[str] = None) -> None:
    """Write `pytree` to `<path>.npz` atomically, with `fingerprint` (an
    identity string of the run, read by `checkpoint_matches`)."""
    if backend != "npz":
        raise ValueError(
            f"backend={backend!r}: only 'npz' is supported; 'orbax' is JAX's "
            "multi-host format and has no counterpart here.")
    path = os.path.abspath(path)
    payload = {f"leaf_{i}": _host(leaf) for i, leaf in enumerate(_flatten(pytree))}
    if fingerprint is not None:
        payload["__fingerprint__"] = np.asarray(fingerprint)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".npz.tmp"
    with open(tmp, "wb") as fh:
        np.savez(fh, **payload)
    os.replace(tmp, path + ".npz")


def load_pytree(path: str, like: Any = None) -> Any:
    """The tree saved by `save_pytree` at `path`, in the structure of `like`
    (required): tensor leaves come back as tensors on `like`'s devices,
    the others as numpy arrays."""
    path = os.path.abspath(path)
    if like is None:
        raise ValueError(
            f"load_pytree needs `like` (a structure template) for npz checkpoints: {path}.npz")
    with np.load(path + ".npz") as data:
        n = sum(1 for k in data.files if k.startswith("leaf_"))
        leaves = [data[f"leaf_{i}"] for i in range(n)]
    if n != len(_flatten(like)):
        raise ValueError(f"{path}.npz holds {n} leaves; the template has "
                         f"{len(_flatten(like))}.")
    return _unflatten(like, iter(leaves))


class RandomState:
    """The random state a fit carries from step to step: its generators'
    states and, on the card, each `BatchDraws`' Philox key and counter
    offset (-1 for one not drawn yet). `draws` is a callable that returns
    the fit's draws at the time of the call (None for one not made yet)."""

    def __init__(self, generators: Sequence[torch.Generator] = (),
                 draws: Callable[[], Sequence[Any]] = tuple):
        self.generators = list(generators)
        self.draws = draws

    def state(self) -> Dict[str, Any]:
        rows = [[-1, -1] if d is None else
                [-1 if d.key is None else d.key, -1 if d.offset is None else d.offset]
                for d in self.draws()]
        return {"generators": [g.get_state() for g in self.generators],
                "draws": np.asarray(rows, np.int64).reshape(-1, 2)}

    def load(self, state: Dict[str, Any]) -> None:
        """Set the generators' states, and the key and offset of each of the
        fit's draws made by now (a fit that makes its draws later gives them
        theirs with `set_draws`)."""
        for g, s in zip(self.generators, state["generators"]):
            g.set_state(torch.as_tensor(np.asarray(s), dtype=torch.uint8).cpu())
        for d, row in zip(self.draws(), state["draws"]):
            if d is not None:
                self.set_draws(d, row)

    @staticmethod
    def set_draws(draws, row) -> None:
        """Give `draws` the key and offset of a saved row."""
        key, offset = (int(v) for v in row)
        draws.key = None if key < 0 else key
        draws.offset = None if offset < 0 else offset


class FitCheckpoint:
    """One fit's checkpoint at `<directory>/<name>.npz`: restored once at
    the start of the fit when its fingerprint matches (else ignored with a
    warning), written every `interval` epochs but after the last and on a
    stop, deleted when the fit completes. Over a mesh, rank 0 writes and
    deletes, and every rank waits for it, so all ranks then read one file."""

    def __init__(self, directory: str, name: str, fingerprint: str, interval: int,
                 epochs: int, mesh=None):
        self.path = os.path.join(directory, name)
        self.fingerprint = fingerprint
        self.interval = max(1, int(interval))
        self.epochs = int(epochs)
        self.mesh = mesh

    def restore(self, like: Any) -> Optional[Any]:
        """The saved state in `like`'s structure, or None."""
        if not checkpoint_exists(self.path):
            return None
        if not checkpoint_matches(self.path, self.fingerprint):
            warnings.warn(
                f"Ignoring checkpoint at {self.path}: it was written by a different "
                "model/graph/hyper-parameter run.")
            return None
        return load_pytree(self.path, like=like)

    def due(self, epoch: int, stop: bool = False) -> bool:
        """Whether to save after `epoch` (0-based)."""
        return ((epoch + 1) % self.interval == 0 and epoch + 1 < self.epochs
                and not stop)

    def _barrier(self) -> None:
        if self.mesh is not None and self.mesh.size > 1:
            torch.distributed.barrier()

    def save(self, state: Any) -> None:
        if self.mesh is None or self.mesh.rank == 0:
            # Looked up at the call, so a wrapped `save_pytree` takes effect.
            save_pytree(self.path, state, fingerprint=self.fingerprint)
        self._barrier()

    def finish(self) -> None:
        self._barrier()
        if self.mesh is None or self.mesh.rank == 0:
            delete_checkpoint(self.path)
        self._barrier()
