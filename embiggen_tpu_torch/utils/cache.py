"""Result caching keyed by parameter hashes — counterpart of
`embiggen_tpu/utils/cache.py`: embeddings cached at
`embedding/{model}/{library}/{graph}/{hash}.pkl.gz` under
`DEFAULT_CACHE_DIR` (`EMBIGGEN_TPU_CACHE_DIR`, else `.embiggen_tpu_cache`).

Results are pickled with their tensors on the CPU (`persistence.dump_pickle`)
and load on the CPU. A model's hash does not hold its device, so the key adds
the device type: a fit on the card and one on the CPU from the same seed
draw differently, and neither is served for the other.
"""
from __future__ import annotations

import functools
import hashlib
import os
from typing import Callable, Optional

from .persistence import dump_pickle, load_pickle

DEFAULT_CACHE_DIR = os.environ.get("EMBIGGEN_TPU_CACHE_DIR", ".embiggen_tpu_cache")


def _hash_key(*parts: str) -> str:
    h = hashlib.sha256()
    for p in parts:
        h.update(str(p).encode())
    return h.hexdigest()[:32]


def cache_result(path: str, compute: Callable, enable: bool = True):
    """Load the pickled result at `path` if present, else compute and store
    it there."""
    if enable and os.path.exists(path):
        return load_pickle(path, "cpu")
    result = compute()
    if enable:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        tmp = f"{path}.tmp{os.getpid()}"
        dump_pickle(result, tmp)
        os.replace(tmp, path)
    return result


class Cache:
    """Decorator caching a method's result keyed by the model's
    consistent_hash, its device type and the graph's hash:

        @Cache("embedding/{model_name}/{library_name}/{graph_name}/{hash}.pkl.gz")
        def _cached_fit_transform(self, graph): ...

    The cache directory is `cache_dir`, else `DEFAULT_CACHE_DIR` as it is at
    the call."""

    def __init__(self, path_template: str, cache_dir: Optional[str] = None):
        self._template = path_template
        self._cache_dir = cache_dir

    def __call__(self, method: Callable) -> Callable:
        template = self._template

        @functools.wraps(method)
        def wrapper(model, graph, *args, **kwargs):
            if not getattr(model, "_enable_cache", False):
                return method(model, graph, *args, **kwargs)
            device = getattr(model, "device", None)
            path = os.path.join(
                self._cache_dir or DEFAULT_CACHE_DIR,
                template.format(
                    model_name=model.model_name().replace(" ", "_"),
                    library_name=model.library_name(),
                    graph_name=graph.name.replace(" ", "_"),
                    hash=_hash_key(model.consistent_hash(), graph.consistent_hash(),
                                   "cpu" if device is None else device.type),
                ),
            )
            return cache_result(path, lambda: method(model, graph, *args, **kwargs))

        return wrapper
