"""The port's GraphVisualizer (`embiggen_tpu_torch.visualizations`) against the
JAX package's, on the CPU: counterparts of the reference's seven tests
(`tests/test_visualizations.py`), the plot-method surface equal to the
reference's, and the data each plot draws equal to the reference's from the
same numpy features: PCA points within 1e-10, TSNE points within 1e-6 (same
`random_state`), the subsampled ids and the negative-edge sample identical,
the metric columns within 1e-6, the separability comments word for word."""
import dataclasses
import io
import os
import warnings

import matplotlib

matplotlib.use("Agg")

import numpy as np
import pytest

from embiggen_tpu_torch.graph import karate_club
from embiggen_tpu_torch.visualizations import GraphVisualizer
from test_visualizations import REFERENCE_PLOT_METHODS


def _typed_weighted(g):
    labels = g.get_single_label_node_type_ids()
    etypes = (labels[g.sources] != labels[g.col_idx]).astype(np.int32)
    return dataclasses.replace(g, edge_types=etypes,
                               weights=np.ones(g.number_of_directed_edges, np.float32))


@pytest.fixture(scope="module")
def typed_weighted_karate():
    return _typed_weighted(karate_club())


@pytest.fixture(scope="module")
def reference_graph():
    from embiggen_tpu.graph import karate_club as ref_karate

    return _typed_weighted(ref_karate())


@pytest.fixture(scope="module")
def features(typed_weighted_karate):
    from embiggen_tpu_torch.models.embedders import DegreeSPINE

    return DegreeSPINE(embedding_size=10, device="cpu").fit_transform(typed_weighted_karate)


def _pair(port_graph, reference_graph, **kw):
    from embiggen_tpu.visualizations import GraphVisualizer as RefVisualizer

    return GraphVisualizer(port_graph, **kw), RefVisualizer(reference_graph, **kw)


def test_plot_method_surface_parity():
    from embiggen_tpu.visualizations import GraphVisualizer as RefVisualizer

    def plots(cls):
        return {n for n in dir(cls) if n.startswith("plot_") and callable(getattr(cls, n))}

    assert plots(GraphVisualizer) == plots(RefVisualizer)
    assert set(REFERENCE_PLOT_METHODS) <= plots(GraphVisualizer)
    assert len(plots(GraphVisualizer)) >= 30


def test_fit_and_plot_all(typed_weighted_karate, features):
    import matplotlib.pyplot as plt

    viz = GraphVisualizer(typed_weighted_karate, decomposition_method="PCA", random_state=0)
    with warnings.catch_warnings():
        # fit_and_plot_all must not leak into pyplot's open-figure manager.
        warnings.simplefilter("error", RuntimeWarning)
        figures = viz.fit_and_plot_all(features)
    assert len(figures) >= 30
    assert all(fig is not None for fig, _ in figures)
    comments = viz.get_separability_comments()
    assert len(comments) >= 2
    assert any("separable" in c for c in comments)
    assert len(plt.get_fignums()) == 0
    figures[0][0].savefig(io.BytesIO(), format="png")


def test_tsne_and_3d(typed_weighted_karate, features):
    import matplotlib.pyplot as plt

    viz = GraphVisualizer(typed_weighted_karate, decomposition_method="TSNE", n_components=3,
                          random_state=0)
    viz.fit_nodes(features)
    viz.plot_node_degrees()
    assert viz._node_decomposition.shape == (34, 3)
    plt.close("all")


def test_rotating_video(typed_weighted_karate, features, tmp_path):
    import matplotlib.pyplot as plt

    viz = GraphVisualizer(typed_weighted_karate, decomposition_method="PCA", n_components=3,
                          random_state=0)
    viz.fit_nodes(features)
    out = viz.plot_nodes_rotating_video(str(tmp_path / "nodes"), duration_seconds=0.5, fps=4)
    assert os.path.exists(out) and os.path.getsize(out) > 0
    plt.close("all")


def test_invalid_config(typed_weighted_karate):
    with pytest.raises(ValueError, match="decomposition"):
        GraphVisualizer(typed_weighted_karate, decomposition_method="UMAP2")
    with pytest.raises(ValueError, match="n_components"):
        GraphVisualizer(typed_weighted_karate, n_components=4)
    viz = GraphVisualizer(typed_weighted_karate)
    with pytest.raises(ValueError, match="fit_nodes"):
        viz.plot_nodes()
    with pytest.raises(ValueError, match="fit_negative_and_positive"):
        viz.plot_dot()


def test_graph_analysis_methods(typed_weighted_karate):
    g = typed_weighted_karate
    comp, n = g.connected_components()
    assert n == 1
    assert g.is_connected()
    dot = g.to_dot()
    assert dot.startswith("graph {") and dot.count("--") == 78
    sub = g.filter_from_names(node_names_to_remove=[g.get_node_names()[0]])
    assert sub.number_of_nodes == 33


def test_node_structure_metrics(typed_weighted_karate):
    from embiggen_tpu_torch.graph.metrics import (
        approximated_closeness_centrality, approximated_harmonic_centrality, square_counts,
        triangle_counts,
    )

    g = typed_weighted_karate
    assert triangle_counts(g).sum() / 3 == 45  # karate club has 45 triangles
    assert square_counts(g)[0] == 63
    cc = approximated_closeness_centrality(g)
    hc = approximated_harmonic_centrality(g)
    assert cc.shape == (34,) and (cc > 0).all()
    assert hc.shape == (34,) and (hc > 0).all()
    assert cc[33] > cc[11]


@pytest.mark.parametrize("method, n_components, atol", [
    ("PCA", 2, 1e-10), ("PCA", 3, 1e-10), ("TSNE", 2, 1e-6),
])
def test_decompositions_match_reference(typed_weighted_karate, reference_graph, features,
                                        method, n_components, atol):
    """From the same numpy features, the node, edge and positive-negative
    decompositions and the subsampled ids equal the reference's."""
    x = features.node_embeddings[0].astype(np.float64)
    port, ref = _pair(typed_weighted_karate, reference_graph, decomposition_method=method,
                      n_components=n_components, random_state=0,
                      number_of_subsampled_nodes=30, number_of_subsampled_edges=60,
                      number_of_subsampled_negative_edges=40)
    for viz in (port, ref):
        viz.fit_nodes(x)
        viz.fit_edges(x)
        viz.fit_negative_and_positive_edges(x)
    np.testing.assert_array_equal(port._node_ids, ref._node_ids)
    np.testing.assert_array_equal(port._edge_ids, ref._edge_ids)
    np.testing.assert_array_equal(port._pn_pos_ids, ref._pn_pos_ids)
    for attr in ("_node_decomposition", "_edge_decomposition", "_pn_decomposition"):
        np.testing.assert_allclose(getattr(port, attr), getattr(ref, attr), rtol=0, atol=atol,
                                   err_msg=attr)


def test_plotted_data_matches_reference(typed_weighted_karate, reference_graph, features):
    """The negative-edge sample is identical, the metric and distance columns
    the plots color by are within 1e-6, the node metrics equal, and the
    separability comments are the same text."""
    x = features.node_embeddings[0].astype(np.float64)
    port, ref = _pair(typed_weighted_karate, reference_graph, decomposition_method="PCA",
                      random_state=0)
    for viz in (port, ref):
        viz.fit_nodes(x)
        viz.fit_edges(x)
        viz.fit_negative_and_positive_edges(x)
    for arr in ("sources", "col_idx"):
        np.testing.assert_array_equal(getattr(port._pn_neg_graph, arr),
                                      getattr(ref._pn_neg_graph, arr))
    np.testing.assert_array_equal(port._pn_labels, ref._pn_labels)
    for column in range(4):
        np.testing.assert_allclose(port._pn_metric_values(column), ref._pn_metric_values(column),
                                   rtol=0, atol=1e-6)
    for kind in ("euclidean", "cosine", "dot"):
        np.testing.assert_allclose(port._pn_distance_values(kind), ref._pn_distance_values(kind),
                                   rtol=0, atol=1e-6)
    assert port.get_separability_comments() == ref.get_separability_comments()
