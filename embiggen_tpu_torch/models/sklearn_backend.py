"""What the three sklearn-like adapter modules share: the named rows'
estimator factory (sklearn imported only there) and the `use_edge_metrics`
columns of (src, dst) pairs over the fit's support graph.

The metric columns are the reference's (`graph/metrics.py::edge_metrics`,
preferential attachment as log1p): on a CPU device the host copy of that
module, which gives the reference's numbers bit for bit; on a CUDA device
kernel K8 (`ops/edge_metrics.py`) at a cap of the support's largest degree,
where it truncates no row and so computes the same exact function.
"""
from __future__ import annotations

import importlib
import inspect
from typing import Callable, Dict, Union

import numpy as np
import torch

from ..graph.graph import Graph
from ..graph.metrics import edge_metrics as host_edge_metrics
from ..ops.edge_metrics import edge_metrics


def sklearn_estimator(model_name: str, task_name: str, factory_path: str,
                      defaults: Dict, random_state: int, kwargs: Dict):
    """The named row's estimator: `factory_path`'s class built from its
    `defaults` updated by `kwargs`, with `random_state` where the class takes
    one. Raises ModuleNotFoundError naming scikit-learn where it is not
    installed."""
    module_name, cls_name = factory_path.rsplit(".", 1)
    try:
        module = importlib.import_module(module_name)
    except ModuleNotFoundError as exc:
        raise ModuleNotFoundError(
            f"The model {model_name} for task {task_name} from library "
            f"scikit-learn requires the Python package 'sklearn' "
            f"(scikit-learn), which is not installed in this environment "
            f"({exc}). Pass an estimator as model_instance= to the adapter "
            "instead.", name=exc.name,
        ) from exc
    cls = getattr(module, cls_name)
    params = dict(defaults)
    params.update(kwargs)
    if "random_state" in inspect.signature(cls).parameters:
        params.setdefault("random_state", random_state)
    return cls(**params)


def edge_metric_columns(
    support: Graph, device: Union[str, torch.device]
) -> Callable[[np.ndarray, np.ndarray], Union[np.ndarray, torch.Tensor]]:
    """fn(src, dst) -> [B, 4] float32 Adamic-Adar, Jaccard, resource
    allocation and log1p(preferential attachment) of the pairs over
    `support`: a numpy array from the host copy on a CPU device, else a
    tensor on `device` from K8 at a cap of the support's largest degree
    (the support's CSR exported once, here)."""
    device = torch.device(device)
    if device.type == "cpu":
        def host(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
            m = host_edge_metrics(support, src, dst)
            m[:, 3] = np.log1p(m[:, 3])
            return m

        return host
    tg = support.device(device)
    cap = max(tg.max_degree, 1)

    def on_device(src: np.ndarray, dst: np.ndarray) -> torch.Tensor:
        def put(ids):
            return torch.from_numpy(np.ascontiguousarray(ids, dtype=np.int32)).to(device)

        m = edge_metrics(tg, put(src), put(dst), cap=cap)
        m[:, 3] = torch.log1p(m[:, 3])
        return m

    return on_device
