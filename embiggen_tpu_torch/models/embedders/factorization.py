"""The factorization embedders — counterpart of
`embiggen_tpu/models/embedders/factorization.py`, single device: NetMF,
GraRep, BoostNE, RandNE, NodeSketch, MNMF, NMFADMM, NNSED and Role2Vec.

- The six dense models (NetMF, GraRep, BoostNE, MNMF, NMFADMM, NNSED) build
  the [N, N] adjacency on the model's device, refuse graphs above
  DENSE_NODE_LIMIT nodes, and run their matrix powers, multiplicative
  updates and solves as plain torch products (cuBLAS on the card, TF32
  off), as the reference runs them in jnp. NetMF and GraRep take a
  randomized SVD of a log-filtered power (`utils/extmath.py`, a copy of
  scikit-learn's).
- RandNE smooths a Gaussian projection by `alphas`-weighted hops of D⁻¹A,
  each hop kernel K7 (`ops/spmm.py::csr_spmm` at unit values with row
  scale 1 / max(deg, 1)), at any scale.
- NodeSketch runs `iterations` rounds of the min-hash race, kernel K18
  (`ops/nodesketch.py`), at any scale.
- Role2Vec is walk-based: walks are drawn as SkipGram's are (K2 for the
  starts, then K1, or K9 / K10 for p/q walks) and cut into windows; each
  context node is replaced by its Weisfeiler-Lehman structural role, and
  each centre node learns to predict the roles around it against K
  uniformly drawn roles, by a sigmoid NCE whose two terms are means over
  the pairs' positives and negatives. The updates are "add" updates through
  `apply_updates` (`index_add_`).

Each of the first eight fits in two steps: `initial_state(graph)` draws the
random state from torch.Generators seeded by `random_state or 0` (NodeSketch's
per-round noise by one seeded with 1, as the reference's round keys come
from PRNGKey(1) whatever the seed), and `run(graph, state)` computes the
embedding from a given state, so the reference's own draws can be injected
(`utils/convert.py::factorization_state_from_jax`). NetMF and GraRep draw
nothing of their own: their SVD sketches come from numpy's RandomState, as
scikit-learn's do.
"""
from __future__ import annotations

from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ...graph.graph import Graph
from ...ops.bfs import unit_kernel
from ...ops.negatives import sample_nodes_uniform
from ...ops.nodesketch import inverse_decay, sketch_race
from ...ops.spmm import csr_spmm
from ...ops.walks import node2vec_batch
from ...utils.extmath import cusolver_linalg, randomized_svd
from ..abstract import AbstractEmbeddingModel
from ..embedding_result import EmbeddingResult
from ..registry import register_model
from .minibatch import Update, apply_updates, value_and_grad
from .walk_based import WalkBasedEmbedder, _device_generator

# Dense n x n intermediates cap (KarateClub's own algorithms are dense too).
DENSE_NODE_LIMIT = 32_768

State = Dict[str, Any]


def _check_dense_ok(graph: Graph, model_name: str):
    if graph.number_of_nodes > DENSE_NODE_LIMIT:
        raise ValueError(
            f"{model_name} materializes dense n x n matrices; graph "
            f"{graph.name} has {graph.number_of_nodes} nodes "
            f"(limit {DENSE_NODE_LIMIT}). Use a walk-based or LINE-family "
            "embedder at this scale."
        )


def _dense_adjacency(graph: Graph, device: torch.device) -> torch.Tensor:
    """[N, N] float32 on `device`: the arc weights (1 without weights) at
    (source, destination). Of repeated arcs the last one's weight stands, as
    in the reference's numpy assignment; the pairs are made distinct on the
    host first, since a CUDA assignment with repeated indices keeps any."""
    n = graph.number_of_nodes
    keys = graph.sources.astype(np.int64) * n + graph.col_idx.astype(np.int64)
    _, first_from_end = np.unique(keys[::-1], return_index=True)
    last = len(keys) - 1 - first_from_end
    a = torch.zeros((n, n), dtype=torch.float32, device=device)
    values = (torch.from_numpy(np.asarray(graph.weights, np.float32)[last]).to(device)
              if graph.has_edge_weights else 1.0)
    a[torch.from_numpy(keys[last] // n).to(device),
      torch.from_numpy(keys[last] % n).to(device)] = values
    return a


def _row_normalized_(a: torch.Tensor) -> torch.Tensor:
    """a / max(row sum, 1e-12), in place."""
    return a.div_(a.sum(dim=1, keepdim=True).clamp_(min=1e-12))


def _svd_embedding(mat: torch.Tensor, k: int, n_iter: int, seed: int) -> torch.Tensor:
    """u · sqrt(max(s, 0)) of the rank-k randomized SVD (k cut to one less
    than the smaller side), zero-padded to k columns."""
    rank = min(k, min(mat.shape) - 1) if min(mat.shape) > 1 else 1
    u, s, _ = randomized_svd(mat, rank, n_iter, seed)
    emb = u * torch.sqrt(torch.clamp(s, min=0.0))
    if emb.shape[1] < k:  # degenerate tiny graphs: pad to the contract
        emb = F.pad(emb, (0, k - emb.shape[1]))
    return emb.to(torch.float32)


class _FactorizationModel(AbstractEmbeddingModel):
    """Shared bits: the embedding contract, the dense-size check, the two
    steps of a fit (draw the state, run from it)."""

    DENSE = True

    def __init__(self, embedding_size: int = 100, random_state: int = 42,
                 enable_cache: bool = False, device="cuda"):
        super().__init__(embedding_size=embedding_size, enable_cache=enable_cache,
                         random_state=random_state, device=device)

    @classmethod
    def smoke_test_parameters(cls) -> Dict[str, Any]:
        return {"embedding_size": 4}

    def _generator(self, seed=None) -> torch.Generator:
        """A generator on the model's device seeded by `seed`, by default
        `random_state or 0` as the reference's PRNGKey."""
        if seed is None:
            seed = self.random_state or 0
        return torch.Generator(device=self.device).manual_seed(seed)

    def _uniform(self, generator: torch.Generator, shape) -> torch.Tensor:
        """U[0.01, 1) float32 on the model's device, the reference's inits."""
        return torch.empty(shape, device=self.device).uniform_(0.01, 1.0, generator=generator)

    def initial_state(self, graph: Graph) -> State:
        """The fit's random draws, on the model's device."""
        return {}

    def run(self, graph: Graph, state: State) -> torch.Tensor:
        """The [N, D] embedding from `state`, on the model's device."""
        raise NotImplementedError

    def _fit_transform(self, graph: Graph) -> EmbeddingResult:
        if self.DENSE:
            _check_dense_ok(graph, self.model_name())
        return self._wrap(self.run(graph, self.initial_state(graph)), graph)

    def _wrap(self, emb: torch.Tensor, graph: Graph) -> EmbeddingResult:
        return EmbeddingResult(
            embedding_method_name=self.model_name(),
            node_embeddings=[emb.cpu().numpy().astype(np.float32)],
            node_names=graph.get_node_names(),
        )


@register_model
class NetMF(_FactorizationModel):
    """DeepWalk-matrix factorization: SVD of
    log max(vol/(T b) * sum_{r<=T} P^r D^-1, 1)
    (reference `karateclub_embedders/netmf.py:81`; NetMF paper)."""

    def __init__(
        self,
        embedding_size: int = 100,
        iteration: int = 10,
        order: int = 2,
        negative_samples: int = 1,
        random_state: int = 42,
        enable_cache: bool = False,
        device="cuda",
    ):
        self._iteration = iteration
        self._order = order
        self._negative_samples = negative_samples
        super().__init__(embedding_size, random_state, enable_cache, device)

    @classmethod
    def model_name(cls) -> str:
        return "NetMF"

    def parameters(self) -> Dict[str, Any]:
        return {
            **super().parameters(),
            "iteration": self._iteration,
            "order": self._order,
            "negative_samples": self._negative_samples,
        }

    def run(self, graph: Graph, state: State) -> torch.Tensor:
        a = _dense_adjacency(graph, self.device)
        vol = float(a.sum())
        inv_deg = 1.0 / a.sum(dim=1).clamp_(min=1e-12)
        p = a.mul_(inv_deg[:, None])  # D^-1 A
        # The reference's scan from the identity: its first product I @ P is P.
        acc, cur = torch.zeros_like(p), p
        for r in range(self._order):
            if r > 0:
                cur = cur @ p
            acc += cur
        del a, p, cur
        m = acc.mul_(inv_deg[None, :]).mul_(
            vol / (self._order * max(self._negative_samples, 1)))
        target = m.clamp_(min=1.0).log_()
        return _svd_embedding(target, self.embedding_size, self._iteration,
                              self.random_state or 0)


@register_model
class GraRep(_FactorizationModel):
    """Concatenated per-order SVDs of log-filtered transition-matrix powers
    (reference `karateclub_embedders/grarep.py:75`; GraRep paper). Each of
    the `order` blocks gets embedding_size // order dimensions."""

    def __init__(
        self,
        embedding_size: int = 100,
        iteration: int = 10,
        order: int = 5,
        random_state: int = 42,
        enable_cache: bool = False,
        device="cuda",
    ):
        if embedding_size % order:
            raise ValueError(
                f"GraRep concatenates {order} per-order blocks; "
                f"embedding_size ({embedding_size}) must be divisible by "
                f"order ({order})."
            )
        self._iteration = iteration
        self._order = order
        super().__init__(embedding_size, random_state, enable_cache, device)

    @classmethod
    def model_name(cls) -> str:
        return "GraRep"

    def parameters(self) -> Dict[str, Any]:
        return {
            **super().parameters(),
            "iteration": self._iteration,
            "order": self._order,
        }

    @classmethod
    def smoke_test_parameters(cls) -> Dict[str, Any]:
        return {"embedding_size": 4, "order": 2}

    def run(self, graph: Graph, state: State) -> torch.Tensor:
        n = graph.number_of_nodes
        p = _row_normalized_(_dense_adjacency(graph, self.device))
        per_block = self.embedding_size // self._order
        blocks: List[torch.Tensor] = []
        cur = p
        for k in range(self._order):
            if k > 0:
                cur = cur @ p
            target = torch.log(torch.clamp(cur * n, min=1.0))
            blocks.append(_svd_embedding(target, per_block, self._iteration,
                                         (self.random_state or 0) + k))
            del target
        return torch.cat(blocks, dim=1)


@register_model
class BoostNE(_FactorizationModel):
    """Gradient-boosted NMF: successive non-negative factorizations of the
    residual target matrix, blocks concatenated (reference
    `karateclub_embedders/boostne.py:81`; BoostNE paper)."""

    INNER_ITERATIONS = 30

    def __init__(
        self,
        embedding_size: int = 100,
        iterations: int = 16,
        order: int = 2,
        alpha: float = 0.01,
        random_state: int = 42,
        enable_cache: bool = False,
        device="cuda",
    ):
        if embedding_size % (iterations + 1):
            raise ValueError(
                f"BoostNE concatenates iterations+1 = {iterations + 1} "
                f"blocks; embedding_size ({embedding_size}) must be "
                "divisible by it."
            )
        self._iterations = iterations
        self._order = order
        self._alpha = alpha
        super().__init__(embedding_size, random_state, enable_cache, device)

    @classmethod
    def model_name(cls) -> str:
        return "BoostNE"

    def parameters(self) -> Dict[str, Any]:
        return {
            **super().parameters(),
            "iterations": self._iterations,
            "order": self._order,
            "alpha": self._alpha,
        }

    @classmethod
    def smoke_test_parameters(cls) -> Dict[str, Any]:
        return {"embedding_size": 4, "iterations": 1, "order": 1}

    def initial_state(self, graph: Graph) -> State:
        """Each block's NMF inits: w [N, k] and h [k, N], U[0.01, 1)."""
        n, k = graph.number_of_nodes, self.embedding_size // (self._iterations + 1)
        g = self._generator()
        blocks = [(self._uniform(g, (n, k)), self._uniform(g, (k, n)))
                  for _ in range(self._iterations + 1)]
        return {"w": [w for w, _ in blocks], "h": [h for _, h in blocks]}

    @classmethod
    def _nmf(cls, target: torch.Tensor, w: torch.Tensor, h: torch.Tensor):
        """Multiplicative-update NMF from (w, h)."""
        for _ in range(cls.INNER_ITERATIONS):
            h = h * (w.T @ target) / torch.clamp(w.T @ w @ h, min=1e-9)
            w = w * (target @ h.T) / torch.clamp(w @ h @ h.T, min=1e-9)
        return w, h

    def run(self, graph: Graph, state: State) -> torch.Tensor:
        p = _row_normalized_(_dense_adjacency(graph, self.device))
        # base target: mean of transition powers 1..order
        cur, acc = p, p
        for _ in range(self._order - 1):
            cur = cur @ p
            acc = acc + cur
        residual = acc / self._order
        del p, cur, acc
        blocks = []
        for w0, h0 in zip(state["w"], state["h"]):
            w, h = self._nmf(residual, w0, h0)
            blocks.append(w)
            residual = torch.clamp(residual - w @ h, min=0.0)
        return torch.cat(blocks, dim=1)


@register_model
class RandNE(_FactorizationModel):
    """Iterative Gaussian random projection smoothing:
    emb = sum_l alpha_l (D^-1 A)^l R, each hop kernel K7 over the arcs
    (reference `karateclub_embedders/randne.py:60`; RandNE paper)."""

    DENSE = False

    def __init__(
        self,
        embedding_size: int = 100,
        alphas: Sequence[float] = (0.5, 0.5),
        random_state: int = 42,
        enable_cache: bool = False,
        device="cuda",
    ):
        self._alphas = tuple(float(x) for x in alphas)
        super().__init__(embedding_size, random_state, enable_cache, device)

    @classmethod
    def model_name(cls) -> str:
        return "RandNE"

    def parameters(self) -> Dict[str, Any]:
        return {**super().parameters(), "alphas": self._alphas}

    def initial_state(self, graph: Graph) -> State:
        """base: [N, D] standard normal / sqrt(D)."""
        n, d = graph.number_of_nodes, self.embedding_size
        base = torch.randn((n, d), generator=self._generator(), device=self.device)
        return {"base": base / float(np.sqrt(d))}

    def run(self, graph: Graph, state: State) -> torch.Tensor:
        k = unit_kernel(graph.device(self.device))
        inv_deg = torch.from_numpy(
            1.0 / np.maximum(graph.degrees, 1).astype(np.float32)).to(self.device)
        cur = state["base"]
        acc = torch.zeros_like(cur)
        for alpha in self._alphas:
            cur = csr_spmm(k, cur, row_scale=inv_deg)
            acc += alpha * cur
        return acc


@register_model
class NodeSketch(_FactorizationModel):
    """Recursive min-hash sketches of the self-loop-augmented adjacency:
    each iteration merges a node's sketch with its neighbours' via an
    exponential race weighted by `decay`, kernel K18 (reference
    `karateclub_embedders/node_sketch.py:75`; NodeSketch paper). The
    embedding is the (categorical) sketch matrix, as float32."""

    DENSE = False
    # The reference draws its round noise from PRNGKey(1), whatever
    # random_state is (ROADMAP C); the port keeps that.
    NOISE_SEED = 1

    def __init__(
        self,
        embedding_size: int = 100,
        iterations: int = 10,
        decay: float = 0.01,
        random_state: int = 42,
        enable_cache: bool = False,
        device="cuda",
    ):
        self._iterations = iterations
        self._decay = decay
        super().__init__(embedding_size, random_state, enable_cache, device)

    @classmethod
    def model_name(cls) -> str:
        return "NodeSketch"

    def parameters(self) -> Dict[str, Any]:
        return {
            **super().parameters(),
            "iterations": self._iterations,
            "decay": self._decay,
        }

    @classmethod
    def smoke_test_parameters(cls) -> Dict[str, Any]:
        return {"embedding_size": 4, "iterations": 2}

    def initial_state(self, graph: Graph) -> State:
        """race0: [N, D] Exp(1); noise: one [N, D] Exp(1) matrix a round,
        drawn as the race takes it (an iterator, used once)."""
        shape = (graph.number_of_nodes, self.embedding_size)
        race0 = torch.empty(shape, device=self.device).exponential_(
            generator=self._generator())
        g = self._generator(self.NOISE_SEED)
        noise = (torch.empty(shape, device=self.device).exponential_(generator=g)
                 for _ in range(self._iterations))
        return {"race0": race0, "noise": noise}

    def run(self, graph: Graph, state: State) -> torch.Tensor:
        n, d = graph.number_of_nodes, self.embedding_size
        sketch = torch.arange(n, dtype=torch.int32, device=self.device)[:, None].repeat(1, d)
        _, sketch = sketch_race(graph.device(self.device), state["race0"], sketch,
                                state["noise"], inverse_decay(self._decay))
        return sketch.to(torch.float32)


@register_model
class MNMF(_FactorizationModel):
    """Community-preserving NMF: joint factorization A ~ M U^T with a
    community factor H tied to U by a cluster matrix C and regularized by
    modularity (reference `karateclub_embedders/mnmf.py:105`; M-NMF paper)."""

    def __init__(
        self,
        embedding_size: int = 128,
        clusters: int = 10,
        lambd: float = 0.2,
        alpha: float = 0.05,
        beta: float = 0.05,
        iterations: int = 200,
        lower_control: float = 1e-15,
        eta: float = 5.0,
        random_state: int = 42,
        enable_cache: bool = False,
        device="cuda",
    ):
        self._clusters = clusters
        self._lambd = lambd
        self._alpha = alpha
        self._beta = beta
        self._iterations = iterations
        self._lower_control = lower_control
        self._eta = eta
        super().__init__(embedding_size, random_state, enable_cache, device)

    @classmethod
    def model_name(cls) -> str:
        return "MNMF"

    def parameters(self) -> Dict[str, Any]:
        return {
            **super().parameters(),
            "clusters": self._clusters,
            "lambd": self._lambd,
            "alpha": self._alpha,
            "beta": self._beta,
            "iterations": self._iterations,
            "lower_control": self._lower_control,
            "eta": self._eta,
        }

    @classmethod
    def smoke_test_parameters(cls) -> Dict[str, Any]:
        return {"embedding_size": 4, "clusters": 2, "iterations": 10}

    def initial_state(self, graph: Graph) -> State:
        """m, u [N, D], h [N, clusters], c [clusters, D], U[0.01, 1)."""
        n, d, k = graph.number_of_nodes, self.embedding_size, self._clusters
        g = self._generator()
        return {name: self._uniform(g, shape) for name, shape in
                (("m", (n, d)), ("u", (n, d)), ("h", (n, k)), ("c", (k, d)))}

    def run(self, graph: Graph, state: State) -> torch.Tensor:
        a = _dense_adjacency(graph, self.device)
        deg = a.sum(dim=1)
        two_m = torch.clamp(deg.sum(), min=1.0)
        # S = first-order + eta * cosine second-order proximity
        a_n = a / torch.clamp(torch.linalg.norm(a, dim=1, keepdim=True), min=1e-12)
        s = a_n @ a_n.T
        del a_n
        s.mul_(self._eta).add_(a)
        # The modularity matrix B = A - d dᵀ / 2m, split into its positive
        # and negative parts once: the reference's loop recomputes both.
        b_pos = torch.outer(deg, deg).div_(two_m).neg_().add_(a)
        del a
        b_neg = b_pos.neg().clamp_(min=0.0)
        b_pos.clamp_(min=0.0)
        m, u, h, c = (state[k] for k in ("m", "u", "h", "c"))
        lo, al, be, lam = self._lower_control, self._alpha, self._beta, self._lambd
        for _ in range(self._iterations):
            m = m * (s @ u) / torch.clamp(m @ (u.T @ u), min=lo)
            num_u = s.T @ m + al * (h @ c)
            den_u = u @ (m.T @ m + al * (c.T @ c))
            u = u * num_u / torch.clamp(den_u, min=lo)
            c = c * (h.T @ u) / torch.clamp(c @ (u.T @ u), min=lo)
            # H update with modularity term (M-NMF eq. 9, with the
            # positive/negative split of B)
            num_h = be * (b_pos @ h) + lam * (u @ c.T)
            den_h = (be * (b_neg @ h) + lam * h @ (c @ c.T)
                     + 2.0 * lam * h * (h * h).sum())  # orthogonality pressure
            h = h * torch.sqrt(num_h / torch.clamp(den_h, min=lo))
            h = torch.clamp(h, min=lo)
        return u


@register_model
class NMFADMM(_FactorizationModel):
    """ADMM-split non-negative matrix factorization of the row-normalized
    adjacency (reference `karateclub_embedders/nmfadmm.py:75`; Sun &
    Fevotte ADMM-NMF); the least-squares steps are `torch.linalg.solve`."""

    def __init__(
        self,
        embedding_size: int = 100,
        iterations: int = 100,
        rho: float = 1.0,
        random_state: int = 42,
        enable_cache: bool = False,
        device="cuda",
    ):
        self._iterations = iterations
        self._rho = rho
        super().__init__(embedding_size, random_state, enable_cache, device)

    @classmethod
    def model_name(cls) -> str:
        return "NMFADMM"

    def parameters(self) -> Dict[str, Any]:
        return {
            **super().parameters(),
            "iterations": self._iterations,
            "rho": self._rho,
        }

    @classmethod
    def smoke_test_parameters(cls) -> Dict[str, Any]:
        return {"embedding_size": 4, "iterations": 10}

    def initial_state(self, graph: Graph) -> State:
        """w [N, D] and h [D, N], U[0.01, 1)."""
        n, d = graph.number_of_nodes, self.embedding_size
        g = self._generator()
        return {"w": self._uniform(g, (n, d)), "h": self._uniform(g, (d, n))}

    def run(self, graph: Graph, state: State) -> torch.Tensor:
        x = _row_normalized_(_dense_adjacency(graph, self.device))
        w, h = state["w"], state["h"]
        rho = self._rho
        eye = torch.eye(self.embedding_size, device=self.device)
        w_plus, h_plus = w, h
        dual_w, dual_h = torch.zeros_like(w), torch.zeros_like(h)
        with cusolver_linalg(self.device):
            for _ in range(self._iterations):
                # W least squares: (H H^T + rho I) W^T = H X^T + rho(W+ - dualW)^T
                gram_h = h @ h.T + rho * eye
                rhs_w = h @ x.T + rho * (w_plus - dual_w).T
                w = torch.linalg.solve(gram_h, rhs_w).T
                gram_w = w.T @ w + rho * eye
                rhs_h = w.T @ x + rho * (h_plus - dual_h)
                h = torch.linalg.solve(gram_w, rhs_h)
                w_plus = torch.clamp(w + dual_w, min=0.0)
                h_plus = torch.clamp(h + dual_h, min=0.0)
                dual_w = dual_w + w - w_plus
                dual_h = dual_h + h - h_plus
        return w_plus  # the non-negative basis


@register_model
class NNSED(_FactorizationModel):
    """Non-negative symmetric encoder-decoder: A ~ W Z with the code
    Z = max(W^T A, 0) re-derived each step (reference
    `karateclub_embedders/nnsed.py:73`; NNSED paper). Embedding = Z^T."""

    def __init__(
        self,
        embedding_size: int = 32,
        iterations: int = 10,
        noise: float = 1e-6,
        random_state: int = 42,
        enable_cache: bool = False,
        device="cuda",
    ):
        self._iterations = iterations
        self._noise = noise
        super().__init__(embedding_size, random_state, enable_cache, device)

    @classmethod
    def model_name(cls) -> str:
        return "NNSED"

    def parameters(self) -> Dict[str, Any]:
        return {
            **super().parameters(),
            "iterations": self._iterations,
            "noise": self._noise,
        }

    @classmethod
    def smoke_test_parameters(cls) -> Dict[str, Any]:
        return {"embedding_size": 4, "iterations": 3}

    def initial_state(self, graph: Graph) -> State:
        """w [N, D], U[0.01, 1)."""
        return {"w": self._uniform(self._generator(),
                                   (graph.number_of_nodes, self.embedding_size))}

    def run(self, graph: Graph, state: State) -> torch.Tensor:
        a = _dense_adjacency(graph, self.device)
        w = state["w"]
        noise = self._noise
        for _ in range(self._iterations):
            z = torch.clamp(w.T @ a, min=0.0)  # encoder code (d, n)
            num = a @ z.T
            den = w @ (z @ z.T) + noise
            w = w * num / torch.clamp(den, min=noise)
        return torch.clamp(w.T @ a, min=0.0).T


@register_model
class Role2Vec(WalkBasedEmbedder):
    """Structural-role embeddings: nodes are trained to predict the WL role
    ids of their walk contexts with a sigmoid-NCE objective."""

    def __init__(
        self,
        embedding_size: int = 100,
        weisfeiler_lehman_hashing_iterations: int = 2,
        erase_base_features: bool = False,
        **kwargs,
    ):
        self._wl_iterations = weisfeiler_lehman_hashing_iterations
        self._erase_base_features = erase_base_features
        super().__init__(embedding_size=embedding_size, **kwargs)

    @classmethod
    def model_name(cls) -> str:
        return "Role2Vec"

    def parameters(self) -> Dict[str, Any]:
        return {
            **super().parameters(),
            "weisfeiler_lehman_hashing_iterations": self._wl_iterations,
            "erase_base_features": self._erase_base_features,
        }

    def _wl_roles(self, graph: Graph) -> np.ndarray:
        """Compact structural role id per node: log-degree bins refined by
        WL iterations with a commutative multiset hash (host numpy, the
        reference's draws from default_rng(7))."""
        n = graph.number_of_nodes
        row_ptr, col_idx = graph.row_ptr, graph.col_idx
        labels = np.floor(
            np.log2(np.maximum(graph.degrees, 1))
        ).astype(np.int64)
        base = labels.copy()
        rng = np.random.default_rng(7)
        for _ in range(self._wl_iterations):
            _, labels = np.unique(labels, return_inverse=True)
            salt = rng.integers(1, 2**62, labels.max() + 1)
            hashed = salt[labels]
            neigh_sum = np.zeros(n, np.int64)
            np.add.at(
                neigh_sum,
                np.repeat(np.arange(n), np.diff(row_ptr)),
                hashed[col_idx],
            )
            labels = hashed * 31 + neigh_sum
        if not self._erase_base_features:
            labels = labels * 131 + base
        _, roles = np.unique(labels, return_inverse=True)
        return roles.astype(np.int32)

    # ------------------------------------------------------------- the tables
    def _param_shapes(self, graph: Graph) -> Dict[str, Tuple[int, ...]]:
        d = self.embedding_size
        return {"node_embedding": (graph.number_of_nodes, d),
                "role_embedding": (self._n_roles, d)}

    def _initial_tables(self, graph: Graph, generator: torch.Generator):
        roles = self._wl_roles(graph)
        self._roles = torch.from_numpy(roles).to(self.device)
        self._n_roles = int(roles.max()) + 1
        # Negative roles are drawn on the model's device.
        self._role_generator = (generator if self.device.type == "cpu"
                                else _device_generator(generator, self.device))
        return super()._initial_tables(graph, generator)

    def _new_sums(self, params) -> None:
        return None

    # ------------------------------------------------------------- the step
    def _sample_role_pairs(self, tg, generator: torch.Generator):
        """(words [M], roles [M, 2w], neg_roles [M, K]) for one step: the
        windows of fresh walks, their contexts' roles, and K uniform roles
        per pair from a generator on the model's device."""
        starts = sample_nodes_uniform(tg, generator, (self._run_batch_size,))
        contexts, words = node2vec_batch(
            tg, starts, self._walk_length, self._window_size, generator,
            iterations=self._iterations, return_weight=self._return_weight,
            explore_weight=self._explore_weight, max_neighbours=self._max_neighbours)
        neg_roles = torch.randint(0, self._n_roles,
                                  (words.shape[0], self._number_of_negative_samples),
                                  generator=self._role_generator, device=self.device,
                                  dtype=torch.int32)
        return words, self._roles[contexts.long()], neg_roles

    def _pair_updates(self, params, words, roles, neg_roles, n_full):
        """(loss, updates) for the pairs; each loss term is a mean over the
        `n_full` pairs' positives or negatives."""
        w, k = roles.shape[1], neg_roles.shape[1]

        def loss_fn(w_rows, pos_rows, neg_rows):
            pos_logit = torch.einsum("nd,nwd->nw", w_rows, pos_rows)
            neg_logit = torch.einsum("nd,nkd->nk", w_rows, neg_rows)
            return (F.softplus(-pos_logit).sum() / (n_full * w)
                    + F.softplus(neg_logit).sum() / (n_full * k))

        emb, role = params["node_embedding"], params["role_embedding"]
        loss, (g_w, g_pos, g_neg) = value_and_grad(
            loss_fn, [emb[words.long()], role[roles.long()], role[neg_roles.long()]])
        d = emb.shape[1]
        return loss, [
            Update("node_embedding", words, g_w, "add"),
            Update("role_embedding", roles.reshape(-1), g_pos.reshape(-1, d), "add"),
            Update("role_embedding", neg_roles.reshape(-1), g_neg.reshape(-1, d), "add"),
        ]

    def _step(self, tg, params, generator, lr, batch=None, sums=None) -> torch.Tensor:
        """One step on `params`, in place, from fresh pairs (or the injected
        `batch` of (words, roles, neg_roles)); returns the loss."""
        words, roles, neg_roles = (self._sample_role_pairs(tg, generator)
                                   if batch is None else batch)
        loss, updates = self._pair_updates(params, words, roles, neg_roles,
                                           words.shape[0])
        apply_updates(params, updates, lr)
        return loss

    def _extract(self, params, graph: Graph) -> EmbeddingResult:
        return EmbeddingResult(
            embedding_method_name=self.model_name(),
            node_embeddings=[params["node_embedding"].cpu().numpy()],
            node_names=graph.get_node_names(),
        )
