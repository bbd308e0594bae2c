"""PerceptronEdgePrediction — counterpart of
`embiggen_tpu/models/edge_prediction/perceptron.py`: a logistic model over
topological edge features (Degree) and edge embeddings of node features
(CosineSimilarity, Hadamard, ...), trained by lr-decayed SGD against
scale-free negatives.

The [2E, F] training matrix is assembled on the model's device in chunks of
`CHUNK` pairs (a memory bound) and stays there; normalization is applied per
minibatch, never materialized. Each SGD step uses the closed-form gradient
of the logistic loss; on a CUDA device the steps replay captured CUDA
graphs. Scoring runs in the same chunks. AdamicAdar, JaccardCoefficient,
ResourceAllocationIndex, PreferentialAttachment and Cooccurrence come from
the edge heuristics (kernel K8) over the support graph.
"""
from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from ...graph.graph import Graph
from ...graph.sampling import sample_negative_graph
from ...ops import edge_ops
from ...ops.edge_metrics import edge_metrics
from ..registry import register_model
from .model import AbstractEdgePredictionModel

TOPOLOGICAL_FEATURES = [
    "Degree",
    "AdamicAdar",
    "JaccardCoefficient",
    "Cooccurrence",
    "ResourceAllocationIndex",
    "PreferentialAttachment",
]
K8_FEATURES = set(TOPOLOGICAL_FEATURES) - {"Degree"}
# SGD steps per captured CUDA graph: an epoch at the harness configuration
# is 9765 steps of ~20 small kernels each, and launching them one by one
# from the host takes far longer than they run.
GRAPH_STEPS = 64


def _epoch_runner(step, state, steps: int, batch: int, device: torch.device):
    """A function that runs `step(rows)` for each row of an epoch's
    [steps, batch] index tensor. On a CUDA device, blocks of GRAPH_STEPS
    steps replay one captured CUDA graph over a static index buffer (the
    remaining steps run eagerly); `state` are the tensors the steps update
    in place, restored after the warm-up run that precedes the capture."""
    if device.type != "cuda" or steps < GRAPH_STEPS:
        return lambda idx: [step(rows) for rows in idx]
    rows = torch.zeros((GRAPH_STEPS, batch), dtype=torch.long, device=device)
    saved = [t.clone() for t in state]
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        step(rows[0])
    torch.cuda.current_stream(device).wait_stream(side)
    for t, s in zip(state, saved):
        t.copy_(s)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for r in rows:
            step(r)

    def run(idx):
        whole = steps - steps % GRAPH_STEPS
        for i in range(0, whole, GRAPH_STEPS):
            rows.copy_(idx[i:i + GRAPH_STEPS])
            graph.replay()
        for r in idx[whole:]:
            step(r)
    return run


@register_model
class PerceptronEdgePrediction(AbstractEdgePredictionModel):
    # Pairs per chunk of feature assembly and scoring: bounds the [C, F]
    # feature block on the device.
    CHUNK = 1 << 22

    def __init__(
        self,
        edge_features: Optional[Union[str, List[str]]] = "Degree",
        edge_embeddings: Optional[Union[str, List[str]]] = None,
        number_of_epochs: int = 100,
        learning_rate: float = 0.01,
        learning_rate_decay: float = 0.99,
        l2_regularization: float = 0.0,
        number_of_edges_per_mini_batch: int = 4096,
        use_scale_free_distribution: bool = True,
        random_state: int = 42,
        device: Union[str, torch.device] = "cuda",
    ):
        if edge_features is None:
            edge_features = []
        if isinstance(edge_features, str):
            edge_features = [edge_features]
        for f in edge_features:
            if f not in TOPOLOGICAL_FEATURES:
                raise ValueError(
                    f"Unknown edge feature {f!r}; available: "
                    f"{TOPOLOGICAL_FEATURES}"
                )
        if edge_embeddings is None:
            edge_embeddings = []
        if isinstance(edge_embeddings, str):
            edge_embeddings = [edge_embeddings]
        for m in edge_embeddings:
            edge_ops.resolve(m, edge_ops.PERCEPTRON_EDGE_METHODS)
        if not edge_features and not edge_embeddings:
            raise ValueError(
                "Provide at least one of edge_features / edge_embeddings."
            )
        self._edge_features = list(edge_features)
        self._edge_embeddings = list(edge_embeddings)
        self._number_of_epochs = number_of_epochs
        self._learning_rate = learning_rate
        self._learning_rate_decay = learning_rate_decay
        self._l2_regularization = l2_regularization
        self._batch_size = number_of_edges_per_mini_batch
        self._use_scale_free_distribution = use_scale_free_distribution
        self._ctx: Optional[Tuple[str, Any, Any]] = None
        super().__init__(random_state=random_state, device=device)

    @classmethod
    def model_name(cls) -> str:
        return "Perceptron"

    def parameters(self) -> Dict[str, Any]:
        return {
            **super().parameters(),
            "edge_features": self._edge_features,
            "edge_embeddings": self._edge_embeddings,
            "number_of_epochs": self._number_of_epochs,
            "learning_rate": self._learning_rate,
            "learning_rate_decay": self._learning_rate_decay,
            "l2_regularization": self._l2_regularization,
            "number_of_edges_per_mini_batch": self._batch_size,
            "use_scale_free_distribution": self._use_scale_free_distribution,
        }

    @classmethod
    def smoke_test_parameters(cls) -> Dict[str, Any]:
        return {"number_of_epochs": 5, "number_of_edges_per_mini_batch": 128}

    # --------------------------------------------------------------- features
    def _device_ctx(self, support: Graph):
        """(support degrees, the support's TorchGraph when a K8 feature is
        asked for, node features) on the device, cached per support content
        (an evaluation scores several graphs against one support)."""
        fp = support.arcs_fingerprint
        if self._ctx is not None and self._ctx[0] == fp:
            return self._ctx[1]
        deg = (torch.from_numpy(support.degrees).to(self.device, torch.float32)
               if self._edge_features else None)
        tg = (support.device(self.device)
              if K8_FEATURES & set(self._edge_features) else None)
        feats = (torch.from_numpy(self._node_features).to(self.device)
                 if self._edge_embeddings else None)
        self._ctx = (fp, (deg, tg, feats))
        return self._ctx[1]

    def _features_device(self, ctx, src, dst) -> torch.Tensor:
        """[C, F] float32 feature block for int64 index tensors src, dst,
        over the device context `ctx` of `_device_ctx`."""
        deg, tg, feats = ctx
        metrics = (edge_metrics(tg, src.to(torch.int32), dst.to(torch.int32))
                   if tg is not None else None)
        parts = []
        for f in self._edge_features:
            if f == "Degree":
                parts.append(torch.stack(
                    [torch.log1p(deg[src]), torch.log1p(deg[dst])], dim=1))
            elif f == "AdamicAdar":
                parts.append(metrics[:, 0:1])
            elif f == "JaccardCoefficient":
                parts.append(metrics[:, 1:2])
            elif f == "ResourceAllocationIndex":
                parts.append(metrics[:, 2:3])
            elif f == "PreferentialAttachment":
                parts.append(torch.log1p(metrics[:, 3:4]))
            elif f == "Cooccurrence":
                # The reference's formula of the common-neighbour count from
                # Jaccard and the degree sum.
                union = deg[src] + deg[dst]
                jac = metrics[:, 1]
                parts.append((jac * union / (1 + jac))[:, None])
        if self._edge_embeddings:
            s, d = feats[src], feats[dst]
            for m in self._edge_embeddings:
                fn = edge_ops.resolve(m, edge_ops.PERCEPTRON_EDGE_METHODS)
                parts.append(fn(s, d).to(torch.float32))
        return torch.cat(parts, dim=1)

    def _chunked(self, fn, support: Graph, src, dst) -> List[torch.Tensor]:
        """fn(features [C, F]) over (src, dst) in chunks of CHUNK pairs."""
        if self._edge_embeddings and self._node_features is None:
            raise ValueError("edge_embeddings require node_features at fit time.")
        ctx = self._device_ctx(support)
        src = np.asarray(src, np.int64)
        dst = np.asarray(dst, np.int64)
        outs = []
        for i in range(0, len(src), self.CHUNK):
            s = torch.from_numpy(src[i:i + self.CHUNK]).to(self.device)
            d = torch.from_numpy(dst[i:i + self.CHUNK]).to(self.device)
            outs.append(fn(self._features_device(ctx, s, d)))
        return outs

    # ---------------------------------------------------------------- fitting
    def _epoch_indices(self, generator: torch.Generator, epoch: int, n: int,
                       steps: int, batch: int) -> torch.Tensor:
        """[steps, batch] example indices of one epoch, in one draw."""
        return torch.randint(0, n, (steps, batch), generator=generator,
                             device=self.device)

    def _sgd_step(self, xd, yd, mean, std, w, b, rows, lr, loss_sum) -> None:
        """One SGD step on the examples `rows`, updating w, b and loss_sum in
        place (lr is a 0-d tensor). The gradient is the closed form of
        mean(softplus(z) - y·z) + l2·|w|² in (w, b)."""
        l2 = self._l2_regularization
        xb = (xd[rows] - mean) / std
        yb = yd[rows]
        z = xb @ w + b
        r = torch.sigmoid(z) - yb
        loss_sum += (F.softplus(z) - yb * z).mean() + l2 * (w * w).sum()
        gw = xb.T @ r / rows.shape[0] + 2.0 * l2 * w
        w -= lr * gw
        b -= lr * r.mean()

    def _fit(self, graph: Graph, support: Graph, node_features, **kwargs):
        self._node_features = self.concatenate_features(node_features)
        self._support = support
        self._ctx = None
        t0 = time.perf_counter()
        neg = sample_negative_graph(
            graph,
            number_of_negative_samples=graph.number_of_directed_edges,
            random_state=self.random_state or 42,
            use_scale_free_distribution=self._use_scale_free_distribution,
            support=support,
            device=self.device,
        )
        negatives_s = time.perf_counter() - t0
        x_pos = self._chunked(lambda x: x, support, graph.sources, graph.col_idx)
        x_neg = self._chunked(lambda x: x, support, neg.sources, neg.col_idx)
        n_pos = sum(x.shape[0] for x in x_pos)
        xd = torch.cat(x_pos + x_neg)
        del x_pos, x_neg
        mean = xd.mean(dim=0)
        std = xd.std(dim=0, correction=0).clamp(min=1e-6)
        yd = torch.zeros(xd.shape[0], device=self.device)
        yd[:n_pos] = 1.0
        w = torch.zeros(xd.shape[1], device=self.device)
        b = torch.zeros((), device=self.device)
        lr_t = torch.zeros((), device=self.device)
        loss_sum = torch.zeros((), device=self.device)
        n = int(xd.shape[0])
        batch = min(self._batch_size, n)
        steps = max(1, n // batch)
        generator = torch.Generator(device=self.device).manual_seed(
            self.random_state or 0)
        lr = self._learning_rate
        with torch.no_grad():
            run_epoch = _epoch_runner(
                lambda rows: self._sgd_step(xd, yd, mean, std, w, b, rows, lr_t,
                                            loss_sum),
                (w, b, loss_sum), steps, batch, self.device)
            for e in range(self._number_of_epochs):
                idx = self._epoch_indices(generator, e, n, steps, batch)
                lr_t.fill_(lr)
                loss_sum.zero_()
                run_epoch(idx)
                lr *= self._learning_rate_decay
        self._linear = {"w": w, "b": b, "mean": mean, "std": std}
        self._last_loss = float(loss_sum / steps)   # waits for the device
        # Seconds of the fit's two stages: the negative graph (host, with
        # the membership test on the device), then the training matrix and
        # the SGD epochs.
        self._fit_seconds = {"negative_graph": negatives_s,
                             "train": time.perf_counter() - t0 - negatives_s}

    def _predict_proba(self, graph: Graph, support: Optional[Graph] = None,
                       **kwargs) -> np.ndarray:
        return self.predict_proba_from_edge_node_ids(
            graph.sources, graph.col_idx, support=support
        )

    def predict_proba_from_edge_node_ids(
        self, src: np.ndarray, dst: np.ndarray,
        support: Optional[Graph] = None,
    ) -> np.ndarray:
        """Scores in chunks on the device: features, normalization, dot
        product and sigmoid; only the [C] probabilities come to the host."""
        lin = self._linear

        def score(x):
            z = ((x - lin["mean"]) / lin["std"]) @ lin["w"] + lin["b"]
            return torch.sigmoid(z).cpu()

        with torch.no_grad():
            outs = self._chunked(score, support or self._support, src, dst)
        if not outs:
            return np.zeros((0,), np.float32)
        return torch.cat(outs).numpy()
