"""GraphVisualizer — counterpart of `embiggen_tpu/visualizations.py`:
embedding-space visual analysis with the reference's plot surface (34 plot
methods): TSNE/PCA/UMAP decomposition of node and edge embeddings; plots of
degrees, node types, ontologies, connected components, triangles, squares,
approximated closeness and harmonic centralities, edge types and edge
weights; positive-vs-negative edge scatters with per-metric histograms and
colored scatters (Adamic-Adar, Jaccard, resource allocation, preferential
attachment, Euclidean distance, cosine similarity, dot product);
distribution plots; node and edge subsampling (20k nodes, 10k edges by
default); cluster-separability commentary over repeated holdouts; 2D or 3D
output with a rotating-video export; and `fit_and_plot_all`.

It runs on the host, over `graph.metrics`, `graph.sampling.
sample_negative_graph` (its membership test on the CPU), `EmbeddingResult`
and the edge operators, and launches no kernel. matplotlib loads at the
first plot (`_plt()`, the Agg backend), and scikit-learn (TSNE, PCA, the
separability commentary) and umap-learn where they are used, so the module
imports on a host without them; there a plot or a decomposition raises the
ImportError of the missing package and tries no other method. Every plot
method returns (figure, axes).
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from .graph.graph import Graph
from .graph.metrics import (
    approximated_closeness_centrality,
    approximated_harmonic_centrality,
    edge_metrics,
    square_counts,
    triangle_counts,
)
from .graph.sampling import sample_negative_graph
from .models.embedding_result import EmbeddingResult
from .ops import edge_ops


def _plt():
    import matplotlib

    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    return matplotlib, plt


class GraphVisualizer:
    # (metric name, column in graph.metrics.edge_metrics output)
    _TOPOLOGICAL_METRICS = {
        "adamic_adar": ("Adamic-Adar", 0),
        "jaccard_coefficient": ("Jaccard coefficient", 1),
        "resource_allocation_index": ("Resource allocation index", 2),
        "preferential_attachment": ("Preferential attachment", 3),
    }

    def __init__(
        self,
        graph: Graph,
        decomposition_method: str = "TSNE",
        n_components: int = 2,
        number_of_subsampled_nodes: int = 20_000,
        number_of_subsampled_edges: int = 10_000,
        number_of_subsampled_negative_edges: int = 10_000,
        edge_embedding_method: str = "Hadamard",
        random_state: int = 42,
    ):
        if decomposition_method not in ("TSNE", "PCA", "UMAP"):
            raise ValueError(
                f"Unknown decomposition method {decomposition_method!r}; "
                "use 'TSNE', 'PCA' or 'UMAP'."
            )
        if n_components not in (2, 3):
            raise ValueError("n_components must be 2 or 3.")
        self._graph = graph
        self._decomposition_method = decomposition_method
        self._n_components = n_components
        self._n_nodes_sub = number_of_subsampled_nodes
        self._n_edges_sub = number_of_subsampled_edges
        self._n_neg_sub = number_of_subsampled_negative_edges
        self._edge_embedding_method = edge_embedding_method
        self._random_state = random_state
        self._node_decomposition: Optional[np.ndarray] = None
        self._edge_decomposition: Optional[np.ndarray] = None
        self._node_ids: Optional[np.ndarray] = None
        self._edge_ids: Optional[np.ndarray] = None
        self._node_features: Optional[np.ndarray] = None
        # fit_negative_and_positive_edges state
        self._pn_decomposition: Optional[np.ndarray] = None
        self._pn_labels: Optional[np.ndarray] = None
        self._pn_pos_ids: Optional[np.ndarray] = None
        self._pn_neg_graph: Optional[Graph] = None

    # ------------------------------------------------------------------- fit
    def _decompose(self, x: np.ndarray) -> np.ndarray:
        if x.shape[1] <= self._n_components:
            out = np.zeros((x.shape[0], self._n_components), dtype=np.float64)
            out[:, : x.shape[1]] = x
            return out
        if self._decomposition_method == "PCA":
            from sklearn.decomposition import PCA

            return PCA(
                n_components=self._n_components,
                random_state=self._random_state,
            ).fit_transform(x)
        if self._decomposition_method == "UMAP":
            try:
                from umap import UMAP
            except ImportError as exc:
                raise ModuleNotFoundError(
                    "decomposition_method='UMAP' requires the optional "
                    "`umap-learn` package; install it or use 'TSNE'/'PCA'."
                ) from exc
            return UMAP(
                n_components=self._n_components,
                random_state=self._random_state,
            ).fit_transform(x)
        from sklearn.manifold import TSNE

        perplexity = min(30, max(2, x.shape[0] // 4))
        return TSNE(
            n_components=self._n_components,
            random_state=self._random_state,
            perplexity=perplexity,
            init="random",
        ).fit_transform(x)

    @staticmethod
    def _as_matrix(node_features) -> np.ndarray:
        if isinstance(node_features, EmbeddingResult):
            node_features = node_features.get_node_embedding_from_index(0)
        if hasattr(node_features, "loc"):
            node_features = node_features.to_numpy()
        if isinstance(node_features, torch.Tensor):
            node_features = node_features.detach().cpu().numpy()
        return np.asarray(node_features, dtype=np.float64)

    def fit_nodes(self, node_features) -> "GraphVisualizer":
        x = self._as_matrix(node_features)
        rng = np.random.default_rng(self._random_state)
        n = self._graph.number_of_nodes
        self._node_ids = (
            rng.choice(n, size=self._n_nodes_sub, replace=False)
            if n > self._n_nodes_sub
            else np.arange(n)
        )
        self._node_features = x
        self._node_decomposition = self._decompose(x[self._node_ids])
        return self

    def fit_edges(self, node_features) -> "GraphVisualizer":
        x = self._as_matrix(node_features)
        rng = np.random.default_rng(self._random_state)
        e = self._graph.number_of_directed_edges
        self._edge_ids = (
            rng.choice(e, size=self._n_edges_sub, replace=False)
            if e > self._n_edges_sub
            else np.arange(e)
        )
        src = self._graph.sources[self._edge_ids]
        dst = self._graph.col_idx[self._edge_ids]
        fn = edge_ops.resolve(self._edge_embedding_method)
        if self._node_features is None:
            self._node_features = x
        emb = np.asarray(fn(x[src], x[dst]))
        self._edge_decomposition = self._decompose(emb)
        return self

    def fit_negative_and_positive_edges(
        self, node_features
    ) -> "GraphVisualizer":
        """Joint decomposition of existent vs sampled non-existent edge
        embeddings (reference `fit_negative_and_positive_edges`,
        `graph_visualizer.py:1076`); enables every pos-vs-neg plot below."""
        x = self._as_matrix(node_features)
        self._node_features = x
        rng = np.random.default_rng(self._random_state)
        e = self._graph.number_of_directed_edges
        self._pn_pos_ids = (
            rng.choice(e, size=self._n_edges_sub, replace=False)
            if e > self._n_edges_sub
            else np.arange(e)
        )
        self._pn_neg_graph = sample_negative_graph(
            self._graph,
            min(self._n_neg_sub, self._graph.number_of_edges),
            random_state=self._random_state,
            device="cpu",
        )
        fn = edge_ops.resolve(self._edge_embedding_method)
        pos_emb = np.asarray(
            fn(
                x[self._graph.sources[self._pn_pos_ids]],
                x[self._graph.col_idx[self._pn_pos_ids]],
            )
        )
        neg_emb = np.asarray(
            fn(x[self._pn_neg_graph.sources], x[self._pn_neg_graph.col_idx])
        )
        self._pn_decomposition = self._decompose(
            np.concatenate([pos_emb, neg_emb])
        )
        self._pn_labels = np.concatenate(
            [np.zeros(len(pos_emb), int), np.ones(len(neg_emb), int)]
        )
        return self

    # ------------------------------------------------------- pos/neg helpers
    def _pn_endpoints(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(src, dst, is_negative) for the fitted pos+neg edge sample."""
        self._require_pn()
        src = np.concatenate(
            [
                self._graph.sources[self._pn_pos_ids],
                self._pn_neg_graph.sources,
            ]
        )
        dst = np.concatenate(
            [
                self._graph.col_idx[self._pn_pos_ids],
                self._pn_neg_graph.col_idx,
            ]
        )
        return src, dst, self._pn_labels.astype(bool)

    def _pn_distance_values(self, kind: str) -> np.ndarray:
        src, dst, _ = self._pn_endpoints()
        x = self._node_features
        a, b = x[src], x[dst]
        if kind == "euclidean":
            return np.sqrt(((a - b) ** 2).sum(axis=1))
        if kind == "cosine":
            num = (a * b).sum(axis=1)
            den = np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1)
            return num / np.maximum(den, 1e-12)
        if kind == "dot":
            return (a * b).sum(axis=1)
        raise ValueError(kind)

    def _pn_metric_values(self, column: int) -> np.ndarray:
        src, dst, _ = self._pn_endpoints()
        return edge_metrics(self._graph, src, dst)[:, column]

    # ----------------------------------------------------------------- plots
    def _scatter(self, points, colors=None, title="", color_label=None,
                 categorical=False, labels=None, fig_ax=None):
        matplotlib, plt = _plt()

        is_3d = points.shape[1] == 3
        if fig_ax is None:
            fig = plt.figure(figsize=(7, 6))
            ax = fig.add_subplot(projection="3d" if is_3d else None)
        else:
            fig, ax = fig_ax
        coords = [points[:, i] for i in range(points.shape[1])]
        if categorical and colors is not None:
            uniq = np.unique(colors)
            cmap = matplotlib.colormaps["tab10"]
            for i, value in enumerate(uniq):
                mask = colors == value
                label = labels[value] if labels is not None else str(value)
                ax.scatter(
                    *(c[mask] for c in coords), s=6,
                    color=cmap(i % 10), label=label,
                )
            ax.legend(loc="best", fontsize=8)
        elif colors is not None:
            sc = ax.scatter(*coords, c=colors, s=6, cmap="viridis")
            fig.colorbar(sc, ax=ax, label=color_label)
        else:
            ax.scatter(*coords, s=6)
        ax.set_title(title)
        return fig, ax

    def _hist_pos_neg(self, values: np.ndarray, title: str, xlabel: str):
        _, plt = _plt()
        neg = self._pn_labels.astype(bool)
        fig, ax = plt.subplots(figsize=(6, 4))
        ax.hist(
            [values[~neg], values[neg]], bins=30,
            label=["existent", "non-existent"], density=True,
        )
        ax.set_xlabel(xlabel)
        ax.legend(fontsize=8)
        ax.set_title(f"{self._graph.name} {title}")
        return fig, ax

    def _scatter_pn_colored(self, values: np.ndarray, title: str):
        self._require_pn()
        return self._scatter(
            self._pn_decomposition,
            colors=values,
            title=f"{self._graph.name} {title}",
            color_label=title,
        )

    def _require_nodes(self):
        if self._node_decomposition is None:
            raise ValueError("Call fit_nodes(features) first.")

    def _require_edges(self):
        if self._edge_decomposition is None:
            raise ValueError("Call fit_edges(features) first.")

    def _require_pn(self):
        if self._pn_decomposition is None:
            raise ValueError(
                "Call fit_negative_and_positive_edges(features) first."
            )

    # ------------------------------------------------------------ node plots
    def plot_nodes(self, annotate_nodes: bool = False):
        self._require_nodes()
        fig, ax = self._scatter(
            self._node_decomposition,
            title=f"{self._graph.name} nodes "
            f"({self._decomposition_method})",
        )
        if annotate_nodes and len(self._node_ids) <= 100:
            names = self._graph.get_node_names()
            for i, nid in enumerate(self._node_ids):
                ax.annotate(
                    names[nid], self._node_decomposition[i, :2], fontsize=6
                )
        return fig, ax

    def plot_node_degrees(self):
        self._require_nodes()
        degrees = self._graph.degrees[self._node_ids]
        return self._scatter(
            self._node_decomposition,
            colors=np.log1p(degrees),
            title=f"{self._graph.name} node degrees",
            color_label="log1p(degree)",
        )

    def plot_node_types(self):
        self._require_nodes()
        if not self._graph.has_node_types:
            raise ValueError("Graph has no node types.")
        labels = self._graph.get_single_label_node_type_ids()[self._node_ids]
        return self._scatter(
            self._node_decomposition,
            colors=labels,
            categorical=True,
            labels=self._graph.get_node_type_names(),
            title=f"{self._graph.name} node types",
        )

    def plot_node_ontologies(self):
        """Nodes colored by ontology source — the prefix before ':' in each
        node name, the OBO convention the reference uses
        (`plot_node_ontologies`, `graph_visualizer.py:3134`)."""
        self._require_nodes()
        names = self._graph.get_node_names()
        prefixes = np.asarray(
            [str(n).split(":", 1)[0] if ":" in str(n) else "(no ontology)"
             for n in names]
        )
        uniq, codes = np.unique(prefixes, return_inverse=True)
        return self._scatter(
            self._node_decomposition,
            colors=codes[self._node_ids],
            categorical=True,
            labels=uniq,
            title=f"{self._graph.name} node ontologies",
        )

    def plot_connected_components(self):
        self._require_nodes()
        comp, n_comp = self._graph.connected_components()
        return self._scatter(
            self._node_decomposition,
            colors=comp[self._node_ids],
            categorical=n_comp <= 10,
            title=f"{self._graph.name} components (n={n_comp})",
        )

    def plot_node_triangles(self):
        self._require_nodes()
        tri = triangle_counts(self._graph)[self._node_ids]
        return self._scatter(
            self._node_decomposition,
            colors=np.log1p(tri),
            title=f"{self._graph.name} node triangles",
            color_label="log1p(triangles)",
        )

    def plot_node_squares(self):
        self._require_nodes()
        sq = square_counts(self._graph)[self._node_ids]
        return self._scatter(
            self._node_decomposition,
            colors=np.log1p(sq),
            title=f"{self._graph.name} node squares",
            color_label="log1p(squares)",
        )

    def plot_approximated_closeness_centrality(self):
        self._require_nodes()
        cc = approximated_closeness_centrality(
            self._graph, random_state=self._random_state
        )[self._node_ids]
        return self._scatter(
            self._node_decomposition,
            colors=cc,
            title=f"{self._graph.name} approximated closeness centrality",
            color_label="closeness",
        )

    def plot_approximated_harmonic_centrality(self):
        self._require_nodes()
        hc = approximated_harmonic_centrality(
            self._graph, random_state=self._random_state
        )[self._node_ids]
        return self._scatter(
            self._node_decomposition,
            colors=hc,
            title=f"{self._graph.name} approximated harmonic centrality",
            color_label="harmonic",
        )

    # ------------------------------------------------------------ edge plots
    def plot_edges(self):
        self._require_edges()
        return self._scatter(
            self._edge_decomposition,
            title=f"{self._graph.name} edges "
            f"({self._decomposition_method})",
        )

    def plot_edge_segments(self):
        """Straight segments between decomposed endpoints of a sample of
        edges (reference `plot_edge_segments`, `graph_visualizer.py:1740`)."""
        self._require_nodes()
        if self._n_components != 2:
            raise ValueError("plot_edge_segments requires n_components=2.")
        _, plt = _plt()
        # Position of each subsampled node in decomposition space.
        pos_of = {int(v): i for i, v in enumerate(self._node_ids)}
        rng = np.random.default_rng(self._random_state)
        e = self._graph.number_of_directed_edges
        ids = (
            rng.choice(e, size=self._n_edges_sub, replace=False)
            if e > self._n_edges_sub
            else np.arange(e)
        )
        src = self._graph.sources[ids]
        dst = self._graph.col_idx[ids]
        fig, ax = plt.subplots(figsize=(7, 6))
        from matplotlib.collections import LineCollection

        segs = [
            (
                self._node_decomposition[pos_of[int(s)], :2],
                self._node_decomposition[pos_of[int(d)], :2],
            )
            for s, d in zip(src, dst)
            if int(s) in pos_of and int(d) in pos_of
        ]
        ax.add_collection(
            LineCollection(segs, linewidths=0.3, colors="gray", alpha=0.4)
        )
        self._scatter(
            self._node_decomposition,
            title=f"{self._graph.name} edge segments",
            fig_ax=(fig, ax),
        )
        return fig, ax

    def plot_edge_types(self):
        self._require_edges()
        if not self._graph.has_edge_types:
            raise ValueError("Graph has no edge types.")
        labels = self._graph.edge_types[self._edge_ids]
        return self._scatter(
            self._edge_decomposition,
            colors=labels,
            categorical=True,
            labels=self._graph.get_edge_type_names(),
            title=f"{self._graph.name} edge types",
        )

    def plot_edge_weights(self):
        self._require_edges()
        if not self._graph.has_edge_weights:
            raise ValueError("Graph has no edge weights.")
        return self._scatter(
            self._edge_decomposition,
            colors=self._graph.weights[self._edge_ids],
            title=f"{self._graph.name} edge weights",
            color_label="weight",
        )

    # -------------------------------------------------------- pos/neg plots
    def plot_positive_and_negative_edges(self):
        self._require_pn()
        return self._scatter(
            self._pn_decomposition,
            colors=self._pn_labels,
            categorical=True,
            labels=np.asarray(["existent", "non-existent"], dtype=object),
            title=f"{self._graph.name} positive vs negative edges",
        )

    def plot_positive_and_negative_edge_metrics(self):
        """2x2 panel of all four topological metric histograms."""
        self._require_pn()
        _, plt = _plt()
        fig, axes = plt.subplots(2, 2, figsize=(10, 8))
        neg = self._pn_labels.astype(bool)
        for (title, col), ax in zip(
            self._TOPOLOGICAL_METRICS.values(), axes.reshape(-1)
        ):
            vals = self._pn_metric_values(col)
            ax.hist(
                [vals[~neg], vals[neg]], bins=30,
                label=["existent", "non-existent"], density=True,
            )
            ax.set_title(title)
            ax.legend(fontsize=8)
        fig.suptitle(f"{self._graph.name} edge metrics")
        return fig, axes

    # Per-metric histogram + colored-scatter pairs (reference
    # `plot_positive_and_negative_{metric}_histogram` /
    # `plot_positive_and_negative_edges_{metric}`,
    # `graph_visualizer.py:2440-2852`).
    def plot_positive_and_negative_adamic_adar_histogram(self):
        self._require_pn()
        return self._hist_pos_neg(
            self._pn_metric_values(0), "Adamic-Adar", "Adamic-Adar"
        )

    def plot_positive_and_negative_edges_adamic_adar(self):
        return self._scatter_pn_colored(
            self._pn_metric_values(0), "Adamic-Adar"
        )

    def plot_positive_and_negative_jaccard_coefficient_histogram(self):
        self._require_pn()
        return self._hist_pos_neg(
            self._pn_metric_values(1), "Jaccard coefficient", "Jaccard"
        )

    def plot_positive_and_negative_edges_jaccard_coefficient(self):
        return self._scatter_pn_colored(
            self._pn_metric_values(1), "Jaccard coefficient"
        )

    def plot_positive_and_negative_resource_allocation_index_histogram(self):
        self._require_pn()
        return self._hist_pos_neg(
            self._pn_metric_values(2),
            "resource allocation index",
            "resource allocation",
        )

    def plot_positive_and_negative_edges_resource_allocation_index(self):
        return self._scatter_pn_colored(
            self._pn_metric_values(2), "resource allocation index"
        )

    def plot_positive_and_negative_preferential_attachment_histogram(self):
        self._require_pn()
        return self._hist_pos_neg(
            np.log1p(self._pn_metric_values(3)),
            "preferential attachment",
            "log1p(preferential attachment)",
        )

    def plot_positive_and_negative_edges_preferential_attachment(self):
        return self._scatter_pn_colored(
            np.log1p(self._pn_metric_values(3)),
            "log1p(preferential attachment)",
        )

    def plot_positive_and_negative_edges_euclidean_distance_histogram(self):
        self._require_pn()
        return self._hist_pos_neg(
            self._pn_distance_values("euclidean"),
            "Euclidean distance",
            "Euclidean distance",
        )

    def plot_positive_and_negative_edges_euclidean_distance(self):
        return self._scatter_pn_colored(
            self._pn_distance_values("euclidean"), "Euclidean distance"
        )

    def plot_positive_and_negative_edges_cosine_similarity_histogram(self):
        self._require_pn()
        return self._hist_pos_neg(
            self._pn_distance_values("cosine"),
            "cosine similarity",
            "cosine similarity",
        )

    def plot_positive_and_negative_edges_cosine_similarity(self):
        return self._scatter_pn_colored(
            self._pn_distance_values("cosine"), "cosine similarity"
        )

    def plot_dot(self):
        """Dot-product histogram for pos vs neg edges (reference `plot_dot`,
        `graph_visualizer.py:4813`)."""
        self._require_pn()
        return self._hist_pos_neg(
            self._pn_distance_values("dot"), "dot product", "dot product"
        )

    # ----------------------------------------------------------- distributions
    def _distribution(self, values, title, xlabel, loglog=False):
        _, plt = _plt()
        fig, ax = plt.subplots(figsize=(6, 4))
        if loglog:
            values = np.sort(values)[::-1]
            ax.loglog(np.arange(1, len(values) + 1), values)
            ax.set_xlabel("rank")
            ax.set_ylabel(xlabel)
        else:
            ax.hist(values, bins=50)
            ax.set_xlabel(xlabel)
            ax.set_ylabel("count")
        ax.set_title(f"{self._graph.name} {title}")
        return fig, ax

    def plot_node_degree_distribution(self):
        return self._distribution(
            self._graph.degrees, "degree distribution", "degree", loglog=True
        )

    # Backwards-compatible alias kept from round 1.
    plot_degree_distribution = plot_node_degree_distribution

    def plot_triangle_distribution(self):
        return self._distribution(
            triangle_counts(self._graph), "triangle distribution", "triangles"
        )

    def plot_square_distribution(self):
        return self._distribution(
            square_counts(self._graph), "square distribution", "squares"
        )

    def plot_approximated_closeness_centrality_distribution(self):
        return self._distribution(
            approximated_closeness_centrality(
                self._graph, random_state=self._random_state
            ),
            "approximated closeness centrality distribution",
            "closeness",
        )

    def plot_approximated_harmonic_centrality_distribution(self):
        return self._distribution(
            approximated_harmonic_centrality(
                self._graph, random_state=self._random_state
            ),
            "approximated harmonic centrality distribution",
            "harmonic",
        )

    def plot_edge_weight_distribution(self):
        if not self._graph.has_edge_weights:
            raise ValueError("Graph has no edge weights.")
        return self._distribution(
            self._graph.weights, "edge weight distribution", "weight"
        )

    # ------------------------------------------------------- rotating video
    def plot_nodes_rotating_video(
        self, path: str, duration_seconds: float = 6.0, fps: int = 10
    ) -> str:
        """Render the 3D node decomposition as a rotating GIF/MP4 (reference
        rotating-video output, `graph_visualizer.py` `rotate=True` paths).
        Requires n_components=3; writes to `path` and returns it."""
        self._require_nodes()
        if self._n_components != 3:
            raise ValueError(
                "Rotating video requires n_components=3 decomposition."
            )
        _, plt = _plt()
        from matplotlib import animation

        fig, ax = self._scatter(
            self._node_decomposition,
            colors=np.log1p(self._graph.degrees[self._node_ids]),
            title=f"{self._graph.name} nodes (3D)",
            color_label="log1p(degree)",
        )
        n_frames = max(2, int(duration_seconds * fps))

        def rotate(frame):
            ax.view_init(elev=20, azim=360.0 * frame / n_frames)
            return (ax,)

        anim = animation.FuncAnimation(
            fig, rotate, frames=n_frames, interval=1000 / fps
        )
        writer = (
            animation.FFMpegWriter(fps=fps)
            if str(path).endswith(".mp4") and animation.FFMpegWriter.isAvailable()
            else animation.PillowWriter(fps=fps)
        )
        if not str(path).endswith(".mp4") and not str(path).endswith(".gif"):
            path = str(path) + ".gif"
        anim.save(path, writer=writer)
        plt.close(fig)
        return path

    # ------------------------------------------------ separability commentary
    def get_separability_comments(
        self, n_holdouts: int = 5, train_size: float = 0.7
    ) -> List[str]:
        """Automatic cluster-separability commentary: a decision tree on the
        decomposition predicts node types / components / pos-vs-neg edges
        over repeated holdouts; the mean±std test balanced accuracy decides
        the wording (reference `graph_visualizer.py:78-136`)."""
        from sklearn.metrics import balanced_accuracy_score
        from sklearn.model_selection import ShuffleSplit
        from sklearn.tree import DecisionTreeClassifier

        comments: List[str] = []

        def assess(points: np.ndarray, labels: np.ndarray, what: str):
            if len(np.unique(labels)) < 2:
                return
            scores = []
            splitter = ShuffleSplit(
                n_splits=n_holdouts,
                train_size=train_size,
                random_state=self._random_state,
            )
            for tr, te in splitter.split(points):
                clf = DecisionTreeClassifier(
                    max_depth=5, random_state=self._random_state
                )
                clf.fit(points[tr], labels[tr])
                scores.append(
                    balanced_accuracy_score(labels[te], clf.predict(points[te]))
                )
            mean, std = float(np.mean(scores)), float(np.std(scores))
            if mean > 0.85:
                verdict = "are well separable"
            elif mean > 0.65:
                verdict = "are partially separable"
            else:
                verdict = "do not appear separable"
            comments.append(
                f"{what} {verdict} in the {self._decomposition_method} "
                f"decomposition (balanced accuracy "
                f"{mean:.2f}±{std:.2f} over {n_holdouts} holdouts)."
            )

        if self._node_decomposition is not None:
            if self._graph.has_node_types:
                assess(
                    self._node_decomposition,
                    self._graph.get_single_label_node_type_ids()[
                        self._node_ids
                    ],
                    "Node types",
                )
            comp, n_comp = self._graph.connected_components()
            if 1 < n_comp:
                assess(
                    self._node_decomposition,
                    comp[self._node_ids],
                    "Connected components",
                )
        if self._pn_decomposition is not None:
            assess(
                self._pn_decomposition,
                self._pn_labels,
                "Existent and non-existent edges",
            )
        if self._edge_decomposition is not None and self._graph.has_edge_types:
            assess(
                self._edge_decomposition,
                self._graph.edge_types[self._edge_ids],
                "Edge types",
            )
        return comments

    # ----------------------------------------------------------------- facade
    def fit_and_plot_all(
        self, node_features, include_distribution_plots: bool = True
    ) -> List:
        """Run every applicable plot (reference
        `GraphVisualizer.fit_and_plot_all`, `graph_visualizer.py:5280`) and
        return the list of figures. Separability commentary is available via
        `get_separability_comments()`. Figures are detached from pyplot's
        manager (`plt.close`) so a 35-figure sweep doesn't trip matplotlib's
        open-figure limit; they remain fully usable for `savefig`/display."""
        self.fit_nodes(node_features)
        self.fit_edges(node_features)
        self.fit_negative_and_positive_edges(node_features)
        _, plt = _plt()
        figures: List = []

        def add(fig):
            # Detach each figure from pyplot as soon as it exists, so ~35
            # concurrent figures never accumulate in the manager.
            plt.close(fig[0] if isinstance(fig, tuple) else fig)
            figures.append(fig)

        add(self.plot_nodes())
        add(self.plot_node_degrees())
        add(self.plot_connected_components())
        add(self.plot_node_triangles())
        add(self.plot_node_squares())
        add(self.plot_approximated_closeness_centrality())
        add(self.plot_approximated_harmonic_centrality())
        add(self.plot_node_ontologies())
        add(self.plot_edges())
        add(self.plot_positive_and_negative_edges())
        add(self.plot_positive_and_negative_edge_metrics())
        add(self.plot_positive_and_negative_adamic_adar_histogram())
        add(self.plot_positive_and_negative_edges_adamic_adar())
        add(self.plot_positive_and_negative_jaccard_coefficient_histogram())
        add(self.plot_positive_and_negative_edges_jaccard_coefficient())
        add(self.plot_positive_and_negative_resource_allocation_index_histogram())
        add(self.plot_positive_and_negative_edges_resource_allocation_index())
        add(self.plot_positive_and_negative_preferential_attachment_histogram())
        add(self.plot_positive_and_negative_edges_preferential_attachment())
        add(self.plot_positive_and_negative_edges_euclidean_distance_histogram())
        add(self.plot_positive_and_negative_edges_euclidean_distance())
        add(self.plot_positive_and_negative_edges_cosine_similarity_histogram())
        add(self.plot_positive_and_negative_edges_cosine_similarity())
        add(self.plot_dot())
        if self._n_components == 2:
            add(self.plot_edge_segments())
        if include_distribution_plots:
            add(self.plot_node_degree_distribution())
            add(self.plot_triangle_distribution())
            add(self.plot_square_distribution())
            add(self.plot_approximated_closeness_centrality_distribution())
            add(self.plot_approximated_harmonic_centrality_distribution())
        if self._graph.has_node_types:
            add(self.plot_node_types())
        if self._graph.has_edge_types:
            add(self.plot_edge_types())
        if self._graph.has_edge_weights:
            add(self.plot_edge_weights())
            add(self.plot_edge_weight_distribution())
        return figures
