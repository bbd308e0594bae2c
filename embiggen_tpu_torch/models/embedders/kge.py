"""The knowledge-graph-embedding family — counterpart of
`embiggen_tpu/models/embedders/kge.py`: 21 triple-scoring models trained as
the siamese models are (`siamese.py`): K14's [5, B] block of corrupted
triples a step, the margin loss on gathered rows, autograd, and the
`Update`s applied in place (sparse `index_add_` for the entity and relation
rows, plain SGD for the dense tables).

Scoring functions follow the reference's; distances are "lower is better",
so the score-based models (DistMult and the rest) return minus the score.
HolE's circular correlation is `torch.fft` (cuFFT on the card) and ConvE's
convolution `F.conv2d`, which runs with cuDNN's TF32 off for the whole step
(forward and backward), so it stays float32 like the reference's. The
models that gather a [D, D] matrix per triple (TransR, RESCAL) or contract
a [D, D, D] core (TuckER) do so as the reference does, so their losses and
gradients are its; at batch 65536 and D 128 such a gathered leaf and its
gradient take 4.3 GB each.

NodePiece stores no entity table: a node is the mean of its k nearest
anchors' token embeddings through a tanh layer. Its anchor distances are
kernel K15a (`ops.bfs.multi_source_distances`, one anchor a column) on the
card, its plain version on the CPU, where the reference runs one host BFS
per anchor; the per-node token order is a stable sort, ties broken by
anchor index as `np.argsort(kind="stable")` breaks them.
"""
from __future__ import annotations

import contextlib
from typing import Any, Dict

import numpy as np
import torch
import torch.nn.functional as F

from ...graph.graph import Graph
from ...ops.bfs import UNREACHED, multi_source_distances
from ...ops.losses import absolute
from ..embedding_result import EmbeddingResult
from ..registry import register_model
from .minibatch import Update, value_and_grad
from .siamese import SiameseEmbedder, _near_identity, _normal


class KGEModel(SiameseEmbedder):
    """The KGE-wide defaults on `SiameseEmbedder`'s table scheme: edge types
    required, and an embedding size divisible by DIM_MULTIPLE (complex,
    quaternion and block models)."""

    REL_KEYS = ("edge_type_embedding",)
    DIM_MULTIPLE = 1

    def __init__(self, embedding_size: int = 100, **kwargs):
        if embedding_size % self.DIM_MULTIPLE:
            raise ValueError(
                f"{self.model_name()} requires embedding_size divisible by "
                f"{self.DIM_MULTIPLE}; got {embedding_size}."
            )
        super().__init__(embedding_size=embedding_size, **kwargs)

    @classmethod
    def requires_edge_types(cls) -> bool:
        return True

    @classmethod
    def smoke_test_parameters(cls) -> Dict[str, Any]:
        return {"embedding_size": 8, "epochs": 2, "batch_size": 64}



def _zeros(shapes, device) -> Dict[str, torch.Tensor]:
    return {name: torch.zeros(shape, device=device) for name, shape in shapes.items()}


# ---------------------------------------------------------------------------
# Translation / projection family
# ---------------------------------------------------------------------------


@register_model
class TransR(KGEModel):
    """Relation-space projection + translation: ||M_r h + r - M_r t||^2."""

    REL_KEYS = ("edge_type_embedding", "relation_projection")

    @classmethod
    def model_name(cls) -> str:
        return "TransR"

    def _relation_shapes(self, r):
        d = self.embedding_size
        return {"edge_type_embedding": (r, d), "relation_projection": (r, d, d)}

    def _init_relation_tables(self, graph, g):
        r, d = self._relations(graph), self.embedding_size
        return {"edge_type_embedding": _normal(g, (r, d), 1 / np.sqrt(d), self.device),
                "relation_projection": _near_identity(g, (r, d, d), self.device)}

    def _distance(self, h, t, rel, glob):
        m = rel["relation_projection"]
        diff = (torch.einsum("bij,bj->bi", m, h) + rel["edge_type_embedding"]
                - torch.einsum("bij,bj->bi", m, t))
        return (diff ** 2).sum(-1)


@register_model
class TransD(KGEModel):
    """Dynamic projection: h_perp = h + (h_p . h) r_p, translated in the
    projected space."""

    ENTITY_KEYS = ("node_embedding", "node_projection")
    REL_KEYS = ("edge_type_embedding", "relation_projection")

    @classmethod
    def model_name(cls) -> str:
        return "TransD"

    def _relation_shapes(self, r):
        return {name: (r, self.embedding_size) for name in self.REL_KEYS}

    def _triple_distance(self, h_dict, t_dict, rel, glob):
        rp = rel["relation_projection"]

        def perp(e, ep):
            return e + (ep * e).sum(-1, keepdim=True) * rp
        h = perp(h_dict["node_embedding"], h_dict["node_projection"])
        t = perp(t_dict["node_embedding"], t_dict["node_projection"])
        diff = h + rel["edge_type_embedding"] - t
        return (diff ** 2).sum(-1)


@register_model
class TransF(KGEModel):
    """Flexible translation: score = (h + r).t + (t - r).h."""

    @classmethod
    def model_name(cls) -> str:
        return "TransF"

    def _distance(self, h, t, rel, glob):
        r = rel["edge_type_embedding"]
        return -(((h + r) * t).sum(-1) + ((t - r) * h).sum(-1))


@register_model
class PairRE(KGEModel):
    """Paired relation vectors on normalized entities:
    ||h' * r_h - t' * r_t||_1."""

    REL_KEYS = ("head_relation_embedding", "tail_relation_embedding")
    EXTRACT_REL = ("head_relation_embedding", "tail_relation_embedding")

    @classmethod
    def model_name(cls) -> str:
        return "PairRE"

    def _relation_shapes(self, r):
        return {name: (r, self.embedding_size) for name in self.REL_KEYS}

    def _distance(self, h, t, rel, glob):
        def unit(e):
            # torch.maximum splits the gradient at a tie as jnp.maximum does.
            return e / torch.maximum(torch.linalg.norm(e, dim=-1, keepdim=True),
                                     e.new_tensor(1e-9))
        diff = (unit(h) * rel["head_relation_embedding"]
                - unit(t) * rel["tail_relation_embedding"])
        return absolute(diff).sum(-1)


@register_model
class TorusE(KGEModel):
    """Translation on the torus: h + r - t wrapped to [-0.5, 0.5] per
    dimension (round half to even, as jnp.round), L1 distance."""

    @classmethod
    def model_name(cls) -> str:
        return "TorusE"

    def _distance(self, h, t, rel, glob):
        diff = h + rel["edge_type_embedding"] - t
        return absolute(diff - torch.round(diff)).sum(-1)


# ---------------------------------------------------------------------------
# (Semi-)bilinear family
# ---------------------------------------------------------------------------


@register_model
class DistMult(KGEModel):
    """Diagonal bilinear: score = <h, r, t>."""

    @classmethod
    def model_name(cls) -> str:
        return "DistMult"

    def _distance(self, h, t, rel, glob):
        return -(h * rel["edge_type_embedding"] * t).sum(-1)


@register_model
class ComplEx(KGEModel):
    """Complex diagonal bilinear: Re(<h, r, conj(t)>), each vector's halves
    its real and imaginary parts."""

    DIM_MULTIPLE = 2

    @classmethod
    def model_name(cls) -> str:
        return "ComplEx"

    def _distance(self, h, t, rel, glob):
        hr, hi = h.chunk(2, -1)
        rr, ri = rel["edge_type_embedding"].chunk(2, -1)
        tr, ti = t.chunk(2, -1)
        return -(rr * (hr * tr + hi * ti) + ri * (hi * tr - hr * ti)).sum(-1)


@register_model
class RotatE(KGEModel):
    """Rotation in the complex plane: || h o e^{i theta} - t ||, the
    relation a phase vector of D / 2 uniform angles."""

    DIM_MULTIPLE = 2

    @classmethod
    def model_name(cls) -> str:
        return "RotatE"

    def _relation_shapes(self, r):
        return {"edge_type_embedding": (r, self.embedding_size // 2)}

    def _init_relation_tables(self, graph, g):
        shape = (self._relations(graph), self.embedding_size // 2)
        return {"edge_type_embedding": torch.empty(shape, device=self.device).uniform_(
            -np.pi, np.pi, generator=g)}

    def _distance(self, h, t, rel, glob):
        theta = rel["edge_type_embedding"]
        hr, hi = h.chunk(2, -1)
        tr, ti = t.chunk(2, -1)
        c, s = torch.cos(theta), torch.sin(theta)
        rot_r = hr * c - hi * s
        rot_i = hr * s + hi * c
        return torch.sqrt((rot_r - tr) ** 2 + (rot_i - ti) ** 2 + 1e-12).sum(-1)


@register_model
class HolE(KGEModel):
    """Holographic embeddings: score = <r, circular_correlation(h, t)> by
    real FFTs."""

    @classmethod
    def model_name(cls) -> str:
        return "HolE"

    def _distance(self, h, t, rel, glob):
        d = h.shape[-1]
        corr = torch.fft.irfft(torch.conj(torch.fft.rfft(h, dim=-1)) * torch.fft.rfft(t, dim=-1),
                               n=d, dim=-1)
        return -(rel["edge_type_embedding"] * corr).sum(-1)


@register_model
class RESCAL(KGEModel):
    """Full bilinear relation matrices: score = h^T M_r t."""

    REL_KEYS = ("relation_matrix",)
    EXTRACT_REL = ()

    @classmethod
    def model_name(cls) -> str:
        return "RESCAL"

    def _relation_shapes(self, r):
        d = self.embedding_size
        return {"relation_matrix": (r, d, d)}

    def _init_relation_tables(self, graph, g):
        r, d = self._relations(graph), self.embedding_size
        return {"relation_matrix": _normal(g, (r, d, d), 1 / d, self.device)}

    def _distance(self, h, t, rel, glob):
        return -torch.einsum("bi,bij,bj->b", h, rel["relation_matrix"], t)


@register_model
class TuckER(KGEModel):
    """Tucker decomposition with a shared core tensor:
    score = W x1 h x2 r x3 t."""

    GLOBAL_KEYS = ("core_tensor",)

    @classmethod
    def model_name(cls) -> str:
        return "TuckER"

    def _global_shapes(self, n_nodes):
        d = self.embedding_size
        return {"core_tensor": (d, d, d)}

    def _init_global_tables(self, graph, g):
        d = self.embedding_size
        return {"core_tensor": _normal(g, (d, d, d), 1 / d, self.device)}

    def _distance(self, h, t, rel, glob):
        return -torch.einsum("bi,ijk,bj,bk->b", h, glob["core_tensor"],
                             rel["edge_type_embedding"], t)


@register_model
class QuatE(KGEModel):
    """Quaternion rotation: score = <h (x) r_unit, t>, the Hamilton product
    with the unit relation quaternion."""

    DIM_MULTIPLE = 4

    @classmethod
    def model_name(cls) -> str:
        return "QuatE"

    def _distance(self, h, t, rel, glob):
        ha, hb, hc, hd = h.chunk(4, -1)
        ra, rb, rc, rd = rel["edge_type_embedding"].chunk(4, -1)
        ta, tb, tc, td = t.chunk(4, -1)
        norm = torch.sqrt(ra ** 2 + rb ** 2 + rc ** 2 + rd ** 2 + 1e-12)
        ra, rb, rc, rd = ra / norm, rb / norm, rc / norm, rd / norm
        pa = ha * ra - hb * rb - hc * rc - hd * rd
        pb = ha * rb + hb * ra + hc * rd - hd * rc
        pc = ha * rc - hb * rd + hc * ra + hd * rb
        pd = ha * rd + hb * rc - hc * rb + hd * ra
        return -(pa * ta + pb * tb + pc * tc + pd * td).sum(-1)


@register_model
class DistMA(KGEModel):
    """Additive dot products: score = <h,r> + <r,t> + <h,t>."""

    @classmethod
    def model_name(cls) -> str:
        return "DistMA"

    def _distance(self, h, t, rel, glob):
        r = rel["edge_type_embedding"]
        return -((h * r).sum(-1) + (r * t).sum(-1) + (h * t).sum(-1))


@register_model
class AutoSF(KGEModel):
    """Block-bilinear scoring of the AutoSF search space, SimplE's seed
    over 4 blocks: <h1,r1,t1> + <h2,r2,t2> + <h3,r3,t4> - <h4,r4,t3>."""

    DIM_MULTIPLE = 4

    @classmethod
    def model_name(cls) -> str:
        return "AutoSF"

    def _distance(self, h, t, rel, glob):
        h1, h2, h3, h4 = h.chunk(4, -1)
        r1, r2, r3, r4 = rel["edge_type_embedding"].chunk(4, -1)
        t1, t2, t3, t4 = t.chunk(4, -1)
        return -((h1 * r1 * t1).sum(-1) + (h2 * r2 * t2).sum(-1)
                 + (h3 * r3 * t4).sum(-1) - (h4 * r4 * t3).sum(-1))


# ---------------------------------------------------------------------------
# Neural / interaction family
# ---------------------------------------------------------------------------


@register_model
class ProjE(KGEModel):
    """Shared combination operator: e = tanh(d_e o h + d_r o r + b);
    score = <e, t>."""

    GLOBAL_KEYS = ("entity_weight", "relation_weight", "combination_bias")

    @classmethod
    def model_name(cls) -> str:
        return "ProjE"

    def _global_shapes(self, n_nodes):
        return {name: (self.embedding_size,) for name in self.GLOBAL_KEYS}

    def _init_global_tables(self, graph, g):
        tables = _zeros(self._global_shapes(graph.number_of_nodes), self.device)
        tables["entity_weight"].fill_(1.0)
        tables["relation_weight"].fill_(1.0)
        return tables

    def _distance(self, h, t, rel, glob):
        e = torch.tanh(glob["entity_weight"] * h
                       + glob["relation_weight"] * rel["edge_type_embedding"]
                       + glob["combination_bias"])
        return -(e * t).sum(-1)


@register_model
class CrossE(KGEModel):
    """Crossover interactions: q = tanh(c o h + c o h o r + b);
    score = <q, t>."""

    REL_KEYS = ("edge_type_embedding", "interaction_embedding")
    GLOBAL_KEYS = ("combination_bias",)

    @classmethod
    def model_name(cls) -> str:
        return "CrossE"

    def _relation_shapes(self, r):
        return {name: (r, self.embedding_size) for name in self.REL_KEYS}

    def _global_shapes(self, n_nodes):
        return {"combination_bias": (self.embedding_size,)}

    def _init_relation_tables(self, graph, g):
        r, d = self._relations(graph), self.embedding_size
        return {"edge_type_embedding": _normal(g, (r, d), 1 / np.sqrt(d), self.device),
                "interaction_embedding": _normal(g, (r, d), 0.1 / np.sqrt(d),
                                                 self.device).add_(1.0)}

    def _init_global_tables(self, graph, g):
        return _zeros(self._global_shapes(graph.number_of_nodes), self.device)

    def _distance(self, h, t, rel, glob):
        c = rel["interaction_embedding"]
        q = torch.tanh(c * h + c * h * rel["edge_type_embedding"] + glob["combination_bias"])
        return -(q * t).sum(-1)


@register_model
class ERMLP(KGEModel):
    """MLP over the concatenated triple: score = w2 . tanh(W1 [h;r;t] + b1)."""

    GLOBAL_KEYS = ("mlp_w1", "mlp_b1", "mlp_w2")

    @classmethod
    def model_name(cls) -> str:
        return "ERMLP"

    def _global_shapes(self, n_nodes):
        d = self.embedding_size
        return {"mlp_w1": (3 * d, d), "mlp_b1": (d,), "mlp_w2": (d,)}

    def _init_global_tables(self, graph, g):
        d = self.embedding_size
        return {"mlp_w1": _normal(g, (3 * d, d), 1 / np.sqrt(3 * d), self.device),
                "mlp_b1": torch.zeros(d, device=self.device),
                "mlp_w2": _normal(g, (d,), 1 / np.sqrt(d), self.device)}

    def _distance(self, h, t, rel, glob):
        x = torch.cat([h, rel["edge_type_embedding"], t], dim=-1)
        hidden = torch.tanh(x @ glob["mlp_w1"] + glob["mlp_b1"])
        return -(hidden @ glob["mlp_w2"])


@register_model
class ERMLPE(KGEModel):
    """ERMLP (E): a two-layer MLP encodes [h; r] into entity space, scored
    against t by a dot product."""

    GLOBAL_KEYS = ("mlp_w1", "mlp_b1", "mlp_w2", "mlp_b2")

    @classmethod
    def model_name(cls) -> str:
        return "ERMLPE"

    def _global_shapes(self, n_nodes):
        d = self.embedding_size
        return {"mlp_w1": (2 * d, d), "mlp_b1": (d,), "mlp_w2": (d, d), "mlp_b2": (d,)}

    def _init_global_tables(self, graph, g):
        d = self.embedding_size
        return {"mlp_w1": _normal(g, (2 * d, d), 1 / np.sqrt(2 * d), self.device),
                "mlp_b1": torch.zeros(d, device=self.device),
                "mlp_w2": _normal(g, (d, d), 1 / np.sqrt(d), self.device),
                "mlp_b2": torch.zeros(d, device=self.device)}

    def _distance(self, h, t, rel, glob):
        x = torch.cat([h, rel["edge_type_embedding"]], dim=-1)
        hidden = torch.relu(x @ glob["mlp_w1"] + glob["mlp_b1"])
        e = torch.relu(hidden @ glob["mlp_w2"] + glob["mlp_b2"])
        return -(e * t).sum(-1)


@contextlib.contextmanager
def _fp32_convolutions():
    """cuDNN convolutions in float32 inside the block (not TF32, PyTorch's
    default for them), restored after it."""
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = saved


@register_model
class ConvE(KGEModel):
    """2D convolution over the stacked [h; r] feature map, projected back to
    entity space and scored against t. The map's height is the largest
    divisor of embedding_size not above its square root."""

    GLOBAL_KEYS = ("conv_kernel", "conv_bias", "fc_weight", "fc_bias")

    def __init__(self, embedding_size: int = 100, number_of_filters: int = 8, **kwargs):
        self._number_of_filters = number_of_filters
        hh = int(np.floor(np.sqrt(embedding_size)))
        while embedding_size % hh:
            hh -= 1
        ww = embedding_size // hh
        if 2 * hh < 3 or ww < 3:
            raise ValueError(
                f"ConvE needs a feature map of at least 3x3 after stacking; "
                f"embedding_size={embedding_size} reshapes to ({2 * hh}, {ww})."
            )
        self._map_shape = (hh, ww)
        super().__init__(embedding_size=embedding_size, **kwargs)

    @classmethod
    def model_name(cls) -> str:
        return "ConvE"

    def parameters(self) -> Dict[str, Any]:
        return {**super().parameters(), "number_of_filters": self._number_of_filters}

    @classmethod
    def smoke_test_parameters(cls) -> Dict[str, Any]:
        return {"embedding_size": 9, "epochs": 2, "batch_size": 64, "number_of_filters": 2}

    def _global_shapes(self, n_nodes):
        d, f = self.embedding_size, self._number_of_filters
        hh, ww = self._map_shape
        flat = f * (2 * hh - 2) * (ww - 2)
        return {"conv_kernel": (f, 1, 3, 3), "conv_bias": (f,), "fc_weight": (flat, d),
                "fc_bias": (d,)}

    def _init_global_tables(self, graph, g):
        shapes = self._global_shapes(graph.number_of_nodes)
        flat = shapes["fc_weight"][0]
        return {"conv_kernel": _normal(g, shapes["conv_kernel"], 1 / 3.0, self.device),
                "conv_bias": torch.zeros(shapes["conv_bias"], device=self.device),
                "fc_weight": _normal(g, shapes["fc_weight"], 1 / np.sqrt(flat), self.device),
                "fc_bias": torch.zeros(shapes["fc_bias"], device=self.device)}

    def _distance(self, h, t, rel, glob):
        hh, ww = self._map_shape
        b = h.shape[0]
        image = torch.cat([h.reshape(b, hh, ww),
                           rel["edge_type_embedding"].reshape(b, hh, ww)], dim=1)[:, None]
        conv = F.conv2d(image, glob["conv_kernel"]) + glob["conv_bias"][None, :, None, None]
        conv = torch.relu(conv).reshape(b, -1)
        e = torch.relu(conv @ glob["fc_weight"] + glob["fc_bias"])
        return -(e * t).sum(-1)

    def _batch_updates(self, params, batch, full_batch):
        # The convolution's backward runs inside value_and_grad: the whole
        # step is in the block.
        with _fp32_convolutions():
            return super()._batch_updates(params, batch, full_batch)


# ---------------------------------------------------------------------------
# Spatial / box family
# ---------------------------------------------------------------------------


@register_model
class BoxE(KGEModel):
    """Box embeddings: each entity a point plus a translational bump, each
    relation a head box and a tail box; the head point (bumped by the tail
    entity) should fall in the head box and the tail point in the tail box.
    The distance grows slowly inside a box and fast outside, continuous at
    the boundary."""

    ENTITY_KEYS = ("node_embedding", "node_bump")
    REL_KEYS = ("head_box_center", "head_box_size", "tail_box_center", "tail_box_size")
    EXTRACT_REL = ("head_box_center", "tail_box_center")

    @classmethod
    def model_name(cls) -> str:
        return "BoxE"

    def _relation_shapes(self, r):
        return {name: (r, self.embedding_size) for name in self.REL_KEYS}

    def _init_relation_tables(self, graph, g):
        r, d = self._relations(graph), self.embedding_size
        tables = {name: torch.zeros((r, d), device=self.device) for name in self.REL_KEYS}
        for name in ("head_box_center", "tail_box_center"):
            tables[name] = _normal(g, (r, d), 1 / np.sqrt(d), self.device)
        return tables

    @staticmethod
    def _point_box_distance(p, center, raw_size):
        # jax.nn.softplus is logaddexp(x, 0).
        w = torch.logaddexp(raw_size, torch.zeros_like(raw_size)) + 1e-6
        dist = absolute(p - center)
        inside = dist <= w / 2
        # The continuity constant: both branches agree at w / 2.
        k = 0.5 * w * (w + 2) * w / (w + 1) / (w + 1)
        return torch.where(inside, dist / (w + 1), dist * (w + 1) - k).sum(-1)

    def _triple_distance(self, h_dict, t_dict, rel, glob):
        h_point = h_dict["node_embedding"] + t_dict["node_bump"]
        t_point = t_dict["node_embedding"] + h_dict["node_bump"]
        return (self._point_box_distance(h_point, rel["head_box_center"],
                                         rel["head_box_size"])
                + self._point_box_distance(t_point, rel["tail_box_center"],
                                           rel["tail_box_size"]))


# ---------------------------------------------------------------------------
# Tokenized entities
# ---------------------------------------------------------------------------


@register_model
class NodePiece(KGEModel):
    """Anchor-tokenized entities: each node is its k nearest anchors (the
    highest-degree nodes, by BFS distance from the anchor), encoded as the
    tanh of a linear layer over the mean of their token embeddings, and
    scored with a DistMult head. No [N] table: the anchor vocabulary
    replaces it."""

    ENTITY_KEYS = ()
    REL_KEYS = ("edge_type_embedding",)
    GLOBAL_KEYS = ("anchor_embedding", "encoder_weight", "encoder_bias")
    # Nodes a chunk of the final encoding ([chunk, k, D] gathered rows).
    _EXTRACT_CHUNK = 1 << 16

    def __init__(self, embedding_size: int = 100, number_of_anchors: int = 256,
                 tokens_per_node: int = 8, **kwargs):
        self._number_of_anchors = number_of_anchors
        self._tokens_per_node = tokens_per_node
        super().__init__(embedding_size=embedding_size, **kwargs)

    @classmethod
    def model_name(cls) -> str:
        return "NodePiece"

    def parameters(self) -> Dict[str, Any]:
        return {**super().parameters(), "number_of_anchors": self._number_of_anchors,
                "tokens_per_node": self._tokens_per_node}

    @classmethod
    def smoke_test_parameters(cls) -> Dict[str, Any]:
        return {"embedding_size": 8, "epochs": 2, "batch_size": 64, "number_of_anchors": 8,
                "tokens_per_node": 2}

    def _anchors(self, n_nodes: int) -> int:
        return min(self._number_of_anchors, n_nodes)

    def _tokenize(self, graph: Graph) -> torch.Tensor:
        """[N, k] int32 anchor-token ids of each node on the model's device,
        its k nearest anchors by BFS distance from the anchor (ties by
        anchor index); the id n_anchors pads the anchors a node cannot be
        reached from. The distances are K15a's relaxations with one anchor
        a column, along the reversed arcs of a directed graph; `max_depth`
        N - 1 never cuts them, and the loop stops after the first
        relaxation that moves nothing."""
        tg, init = self._anchor_problem(graph)
        dist = multi_source_distances(tg, init, max_depth=max(graph.number_of_nodes - 1, 0))
        del init
        return self._nearest_anchors(dist)

    def _anchor_problem(self, graph: Graph):
        """The graph whose arcs the anchor distances relax along, on the
        model's device, and the [N, n_anchors] initial distances: 0 at
        anchor j (the j-th highest degree, stable) in column j, UNREACHED
        elsewhere."""
        n = graph.number_of_nodes
        n_anchors = self._anchors(n)
        anchors = np.argsort(-graph.degrees, kind="stable")[:n_anchors]
        if graph.directed:
            graph = Graph.from_edge_arrays(graph.col_idx, graph.sources, n, directed=True)
        init = torch.full((n, n_anchors), UNREACHED, dtype=torch.float32, device=self.device)
        init[torch.from_numpy(anchors).to(self.device),
             torch.arange(n_anchors, device=self.device)] = 0.0
        return graph.device(self.device), init

    def _nearest_anchors(self, dist: torch.Tensor) -> torch.Tensor:
        """The tokens of the [N, n_anchors] anchor distances `dist`."""
        order = torch.sort(dist, dim=1, stable=True).indices[:, :self._tokens_per_node]
        reach = dist.gather(1, order) < UNREACHED
        return torch.where(reach, order, dist.shape[1]).to(torch.int32)

    def _prepare_data(self, graph: Graph):
        self._tokens = self._tokenize(graph)
        return {"tg": super()._prepare_data(graph), "tokens": self._tokens}

    def _sample_batch(self, ctx, generator, batch_size):
        block, _ = super()._sample_batch(ctx["tg"], generator, batch_size)
        return block, (ctx["tokens"],)

    def _global_shapes(self, n_nodes):
        d = self.embedding_size
        return {"anchor_embedding": (self._anchors(n_nodes) + 1, d),
                "encoder_weight": (d, d), "encoder_bias": (d,)}

    def _init_global_tables(self, graph, g):
        d, n_anchors = self.embedding_size, self._anchors(graph.number_of_nodes)
        anchor = _normal(g, (n_anchors + 1, d), 1 / np.sqrt(d), self.device)
        anchor[n_anchors] = 0.0  # the padding token
        return {"anchor_embedding": anchor,
                "encoder_weight": _near_identity(g, (d, d), self.device),
                "encoder_bias": torch.zeros(d, device=self.device)}

    @staticmethod
    def _encode(node_ids, glob, tokens):
        toks = tokens.index_select(0, node_ids.reshape(-1))
        emb = glob["anchor_embedding"].index_select(0, toks.reshape(-1))
        pooled = emb.view(*node_ids.shape, toks.shape[1], -1).mean(-2)
        return torch.tanh(pooled @ glob["encoder_weight"] + glob["encoder_bias"])

    def _pair_distance(self, a, b, rel, glob, tokens):
        """DistMult's distance over the encodings of nodes a and b."""
        return -(self._encode(a, glob, tokens) * rel * self._encode(b, glob, tokens)).sum(-1)

    def _triple_scores(self, params, src, dst, etypes=None):
        glob = {n: params[n] for n in self.GLOBAL_KEYS}
        rel = params["edge_type_embedding"].index_select(0, etypes)
        return self._pair_distance(src, dst, rel, glob, self._tokens)

    def _batch_updates(self, params, batch, full_batch):
        block, (tokens,) = batch
        src, dst, csrc, cdst, etype = block
        keys = self.GLOBAL_KEYS
        leaves = [params["edge_type_embedding"].index_select(0, etype)] + [params[n] for n in keys]
        bias = self._relu_bias

        def loss_fn(rel, *xs):
            glob = dict(zip(keys, xs))
            margin = (bias + self._pair_distance(src, dst, rel, glob, tokens)
                      - self._pair_distance(csrc, cdst, rel, glob, tokens))
            return torch.maximum(margin, margin.new_zeros(())).sum() / full_batch

        loss, grads = value_and_grad(loss_fn, leaves)
        updates = [Update("edge_type_embedding", etype, grads[0], "add")]
        updates += [Update(n, None, g, "dense") for n, g in zip(keys, grads[1:])]
        return loss * full_batch, updates

    def _extract(self, params, graph):
        glob = {n: params[n] for n in self.GLOBAL_KEYS}
        n = graph.number_of_nodes
        ids = torch.arange(n, dtype=torch.int32, device=self._tokens.device)
        emb = torch.cat([self._encode(ids[i:i + self._EXTRACT_CHUNK], glob, self._tokens)
                         for i in range(0, n, self._EXTRACT_CHUNK)])
        return EmbeddingResult(
            embedding_method_name=self.model_name(),
            node_embeddings=[emb.cpu().numpy()],
            edge_type_embeddings=[params["edge_type_embedding"].cpu().numpy()],
            node_names=graph.get_node_names(),
        )


KGE_MODELS = (
    TransR, TransD, TransF, PairRE, TorusE,
    DistMult, ComplEx, RotatE, HolE, RESCAL, TuckER, QuatE, DistMA, AutoSF,
    ProjE, CrossE, ERMLP, ERMLPE, ConvE,
    BoxE, NodePiece,
)
