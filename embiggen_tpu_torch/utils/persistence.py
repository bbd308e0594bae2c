"""Model persistence — counterpart of `embiggen_tpu/utils/persistence.py`:
a model pickled into a gzip file, loadable on another device or on a host
without a GPU.

`dump_model` pickles every tensor as its CPU copy, without changing the
model it dumps; the models drop their device workspaces from a pickle (the
fit's `BatchDraws`, step workspaces, the GCN's cached node representations)
and a `Graph` its cached device exports, all rebuilt at their first use.
`load_model(path, device)` puts every tensor of the model, and every
`torch.device` it records, on `device` ("cuda" unless the caller asks for
the CPU, as the port's entry points). Tensors are stored uncompressed inside
the gzip container (`COMPRESSLEVEL`): float tables do not compress, and
deflate would cost tens of seconds a gigabyte.
"""
from __future__ import annotations

import gzip
import pickle
from typing import Any, Union

import torch

# gzip's level for the port's pickles: stored blocks, no deflate.
COMPRESSLEVEL = 0


class HostPickler(pickle.Pickler):
    """A pickler that writes every tensor as its CPU copy."""

    def __init__(self, file, protocol: int = pickle.HIGHEST_PROTOCOL):
        super().__init__(file, protocol=protocol)
        self._protocol = protocol

    def reducer_override(self, obj):
        if isinstance(obj, torch.Tensor) and obj.device.type != "cpu":
            return obj.detach().cpu().__reduce_ex__(self._protocol)
        return NotImplemented


class _DeviceUnpickler(pickle.Unpickler):
    """An unpickler that rebuilds every tensor on `device` and reads every
    recorded `torch.device` as `device`."""

    def __init__(self, file, device: torch.device):
        super().__init__(file)
        self._device = device

    def find_class(self, module: str, name: str):
        device = self._device
        if module == "torch._utils" and name in ("_rebuild_tensor_v2", "_rebuild_tensor_v3"):
            rebuild = super().find_class(module, name)
            return lambda *args: rebuild(*args).to(device)
        if (module, name) == ("torch", "device"):
            return lambda *args: device
        return super().find_class(module, name)


def dump_pickle(obj: Any, path: str) -> None:
    """`obj` pickled into the gzip file `path`, its tensors as CPU copies."""
    with gzip.open(path, "wb", compresslevel=COMPRESSLEVEL) as f:
        HostPickler(f).dump(obj)


def load_pickle(path: str, device: Union[str, torch.device]) -> Any:
    """The object `dump_pickle` wrote to `path`, on `device`."""
    with gzip.open(path, "rb") as f:
        return _DeviceUnpickler(f, torch.device(device)).load()


def dump_model(model: Any, path: str) -> None:
    """Pickle `model` into the gzip file `path`, every tensor as its CPU
    copy (the model itself keeps its tensors where they are)."""
    dump_pickle(model, path)


def load_model(path: str, device: Union[str, torch.device] = "cuda") -> Any:
    """The model `dump_model` wrote to `path`, its tensors and recorded
    devices on `device`."""
    return load_pickle(path, device)
