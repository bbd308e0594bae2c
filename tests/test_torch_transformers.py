"""The port's transformers (`embiggen_tpu_torch/transformers`) on the CPU,
held to embiggen_tpu's on the same numpy inputs within 1e-6: the node
transformer by ids, by names after a DataFrame-indexed fit and by graph
(aligned and not), the edge transformer for every one of the 14 methods and
None, several methods concatenated and with edge-type features, the graph
transformer, and the three task transformers with their shuffles (the
reference's permutation, so the same rows in the same order) and the
edge-prediction transformer's extra columns."""
import dataclasses

import numpy as np
import pandas as pd
import pytest
import torch

from embiggen_tpu import transformers as ref_transformers
from embiggen_tpu.graph import erdos_renyi as ref_erdos_renyi
from embiggen_tpu.models.embedding_result import EmbeddingResult as RefEmbeddingResult
from embiggen_tpu_torch import transformers
from embiggen_tpu_torch.graph import erdos_renyi
from embiggen_tpu_torch.models.embedding_result import EmbeddingResult
from embiggen_tpu_torch.ops.edge_ops import EDGE_TRANSFORMER_METHODS

torch.set_num_threads(1)
TOL = dict(rtol=1e-6, atol=1e-6)
N = 60
METHODS = list(EDGE_TRANSFORMER_METHODS) + [None]


def _graphs(seed=5):
    args = dict(n_nodes=N, n_edges=240, seed=seed, n_edge_types=3, n_node_types=4)
    return erdos_renyi(**args), ref_erdos_renyi(**args)


def _features(d=7, seed=0):
    return np.random.default_rng(seed).standard_normal((N, d)).astype(np.float32)


def _pairs(seed=1, n=50):
    rng = np.random.default_rng(seed)
    return rng.integers(0, N, n), rng.integers(0, N, n)


def _both(name, *args, **kwargs):
    return (getattr(transformers, name)(*args, device="cpu", **kwargs),
            getattr(ref_transformers, name)(*args, **kwargs))


def test_package_exports_the_reference_names():
    assert sorted(transformers.__all__) == sorted(ref_transformers.__all__)
    assert transformers.EdgeTransformer.methods == ref_transformers.EdgeTransformer.methods


@pytest.mark.parametrize("aligned", [False, True])
def test_node_transformer_equals_reference(aligned):
    x, y = _features(), _features(3, seed=2)
    names = [f"n{i}" for i in range(N)]
    port, ref = _both("NodeTransformer", aligned_mapping=aligned)
    port.fit([x, y])
    ref.fit([x, y])
    assert port.is_fitted and port.device == torch.device("cpu")
    ids = np.random.default_rng(3).integers(0, N, 40)
    np.testing.assert_allclose(port.transform(ids), ref.transform(ids), **TOL)
    g, rg = _graphs()
    np.testing.assert_allclose(port.transform(g), ref.transform(rg), **TOL)
    with pytest.raises(ValueError, match="DataFrame-indexed fit"):
        port.transform(np.array(names[:3]))
    # A DataFrame fit keeps its index as the node names; a permuted frame
    # gathers by name.
    perm = np.random.default_rng(4).permutation(N)
    frame = pd.DataFrame(x[perm], index=np.array(names)[perm])
    port, ref = _both("NodeTransformer", aligned_mapping=aligned)
    port.fit(frame)
    ref.fit(frame)
    picked = list(np.array(names)[ids])
    np.testing.assert_allclose(port.transform(picked), ref.transform(picked), **TOL)
    named = dataclasses.replace(g, node_names=np.array(names, dtype=object))
    ref_named = dataclasses.replace(rg, node_names=np.array(names, dtype=object))
    np.testing.assert_allclose(port.transform(named), ref.transform(ref_named), **TOL)


def test_node_transformer_takes_embedding_results_and_refuses_unfitted():
    x, y = _features(), _features(2, seed=8)
    port, ref = _both("NodeTransformer")
    with pytest.raises(ValueError, match="must be fitted first"):
        port.transform(np.arange(3))
    port.fit(EmbeddingResult("m", node_embeddings=[x, y]))
    ref.fit(RefEmbeddingResult("m", node_embeddings=[x, y]))
    ids = np.arange(N)[::-1].copy()
    np.testing.assert_allclose(port.transform(ids), ref.transform(ids), **TOL)
    # A tensor fit lands on the transformer's device as float32.
    port.fit(torch.from_numpy(x).double())
    assert port.transform_tensor(ids).dtype == torch.float32
    np.testing.assert_allclose(port.transform(ids), x[ids], **TOL)


@pytest.mark.parametrize("method", METHODS)
def test_edge_transformer_method_equals_reference(method):
    x = _features()
    src, dst = _pairs()
    port, ref = _both("EdgeTransformer", methods=method)
    assert port.method_names == ref.method_names
    port.fit(x)
    ref.fit(x)
    got, want = port.transform(src, dst), ref.transform(src, dst)
    assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("methods", [
    ["Hadamard", "L2Distance"], ["concatenate", None, "cosinesimilarity"],
    ["L1Norm", "L2Norm", "Min", "Max"],
])
def test_edge_transformer_concatenates_methods_and_type_features(methods):
    x = _features()
    src, dst = _pairs(seed=6)
    types = np.random.default_rng(7).standard_normal((len(src), 3))
    port, ref = _both("EdgeTransformer", methods=methods)
    assert port.method_names == ref.method_names
    port.fit(x)
    ref.fit(x)
    np.testing.assert_allclose(port.transform(src, dst), ref.transform(src, dst), **TOL)
    np.testing.assert_allclose(port.transform(src, dst, edge_type_features=types),
                               ref.transform(src, dst, edge_type_features=types), **TOL)


def test_edge_transformer_refuses_an_unknown_method():
    for module in (transformers, ref_transformers):
        with pytest.raises(ValueError, match="Unknown edge-embedding method"):
            module.EdgeTransformer(methods="Nope")


@pytest.mark.parametrize("methods", ["Hadamard", ["Average", "SquaredL2"]])
def test_graph_transformer_equals_reference(methods):
    x = _features()
    g, rg = _graphs()
    port, ref = _both("GraphTransformer", methods=methods)
    port.fit(x)
    ref.fit(x)
    np.testing.assert_allclose(port.transform(g), ref.transform(rg), **TOL)
    types = np.ones((g.number_of_directed_edges, 2), np.float32)
    np.testing.assert_allclose(port.transform(g, edge_type_features=types),
                               ref.transform(rg, edge_type_features=types), **TOL)


def _metric_fn(src, dst):
    return np.stack([src * 0.5, dst - 1.0], axis=1).astype(np.float32)


@pytest.mark.parametrize("shuffle, seed, extra", [
    (True, 42, None), (True, 7, _metric_fn), (False, 42, _metric_fn),
])
def test_edge_prediction_transformer_equals_reference(shuffle, seed, extra):
    x = _features()
    g, rg = _graphs()
    neg, ref_neg = _graphs(seed=9)
    port, ref = _both("EdgePredictionTransformer", methods=["Hadamard", "Sum"],
                      aligned_mapping=True)
    port.fit(x)
    ref.fit(x)
    got = port.transform(g, neg, shuffle=shuffle, random_state=seed, extra_features_fn=extra)
    want = ref.transform(rg, ref_neg, shuffle=shuffle, random_state=seed,
                         extra_features_fn=extra)
    np.testing.assert_allclose(got[0], want[0], **TOL)
    np.testing.assert_array_equal(got[1], want[1])
    assert got[1].dtype == want[1].dtype


@pytest.mark.parametrize("shuffle, extra", [(False, None), (True, _metric_fn)])
def test_edge_label_prediction_transformer_equals_reference(shuffle, extra):
    x = _features()
    g, rg = _graphs()
    types = g.edge_types.copy()
    types[::5] = -1
    g, rg = (dataclasses.replace(g, edge_types=types), dataclasses.replace(rg, edge_types=types))
    port, ref = _both("EdgeLabelPredictionTransformer", methods="Concatenate")
    port.fit(x)
    ref.fit(x)
    got = port.transform(g, shuffle=shuffle, random_state=3, extra_features_fn=extra)
    want = ref.transform(rg, shuffle=shuffle, random_state=3, extra_features_fn=extra)
    np.testing.assert_allclose(got[0], want[0], **TOL)
    np.testing.assert_array_equal(got[1], want[1])
    untyped = dataclasses.replace(g, edge_types=None)
    with pytest.raises(ValueError, match="no edge types"):
        port.transform(untyped)


def _multilabel(g, rg):
    rng = np.random.default_rng(12)
    counts = rng.integers(0, 3, N)
    ids = np.concatenate([rng.choice(4, c, replace=False) for c in counts]).astype(np.int32)
    kw = dict(node_type_ptr=np.concatenate([[0], np.cumsum(counts)]).astype(np.int64),
              node_type_ids=ids)
    return dataclasses.replace(g, **kw), dataclasses.replace(rg, **kw)


@pytest.mark.parametrize("multilabel", [False, True])
@pytest.mark.parametrize("shuffle", [False, True])
def test_node_label_prediction_transformer_equals_reference(multilabel, shuffle):
    x = _features()
    g, rg = _graphs()
    if multilabel:
        g, rg = _multilabel(g, rg)
        assert g.has_multilabel_node_types()
    port, ref = _both("NodeLabelPredictionTransformer", aligned_mapping=True)
    port.fit(x)
    ref.fit(x)
    got, want = port.transform(g, shuffle=shuffle, random_state=5), ref.transform(
        rg, shuffle=shuffle, random_state=5)
    np.testing.assert_allclose(got[0], want[0], **TOL)
    np.testing.assert_array_equal(got[1], want[1])
    with pytest.raises(ValueError, match="no node types"):
        port.transform(dataclasses.replace(g, node_type_ptr=None, node_type_ids=None))
