"""Model persistence of the port (`embiggen_tpu_torch.utils.persistence`,
`EmbeddingResult.dump` / `load`) against the JAX package's, on the CPU: a
dumped and loaded model predicts as the model it was dumped from (rtol 1e-5,
the reference's `test_model_persistence`, run through both packages); the
loaded model's tensors and recorded devices are on the device `load_model`
names; device workspaces and cached graph exports stay out of the pickle;
embedding results round-trip."""
import os
import pickle

import numpy as np
import pytest
import torch

from embiggen_tpu_torch.graph import karate_club
from embiggen_tpu_torch.models.embedding_result import EmbeddingResult
from embiggen_tpu_torch.utils import dump_model, load_model


def _tensors(obj, seen=None):
    """Every tensor reachable from `obj` through containers and instance
    attributes."""
    seen = set() if seen is None else seen
    if id(obj) in seen or isinstance(obj, type):
        return []
    seen.add(id(obj))
    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, dict):
        items = obj.values()
    elif isinstance(obj, (list, tuple)):
        items = obj
    elif hasattr(obj, "__dict__"):
        items = vars(obj).values()
    else:
        return []
    return [t for v in items for t in _tensors(v, seen)]


def test_model_persistence(tmp_path):
    """The reference's test through both packages."""
    from embiggen_tpu.graph import karate_club as ref_karate
    from embiggen_tpu.models.gcn import KipfGCNNodeLabelPrediction as RefKipf
    from embiggen_tpu.utils import dump_model as ref_dump, load_model as ref_load
    from embiggen_tpu_torch.models.gcn import KipfGCNNodeLabelPrediction

    for label, model, g, dump, load in (
            ("reference", RefKipf.into_smoke_test(random_state=1), ref_karate(), ref_dump,
             ref_load),
            ("port", KipfGCNNodeLabelPrediction.into_smoke_test(random_state=1, device="cpu"),
             karate_club(), dump_model, lambda p: load_model(p, device="cpu"))):
        model.fit(g)
        before = model.predict_proba(g)
        path = str(tmp_path / f"{label}.pkl.gz")
        dump(model, path)
        after = load(path).predict_proba(g)
        np.testing.assert_allclose(before, after, rtol=1e-5, err_msg=label)


@pytest.mark.parametrize("name", ["Kipf GCN", "Perceptron"])
def test_edge_predictors_round_trip(name, tmp_path):
    """An edge predictor dumped after its fit and its first prediction
    predicts the same after a load; the dump leaves the model as it was, and
    the GCN's cached node representations stay out of the pickle."""
    from embiggen_tpu_torch.models import get_model_from_library

    g = karate_club()
    model = get_model_from_library(name, task_name="Edge Prediction").into_smoke_test(
        random_state=2, device="cpu")
    model.fit(g)
    before = model.predict_proba(g)
    cached = getattr(model, "_predict_h", None)
    path = str(tmp_path / "m.pkl.gz")
    dump_model(model, path)
    assert getattr(model, "_predict_h", None) is cached
    restored = load_model(path, device="cpu")
    assert getattr(restored, "_predict_h", None) is None
    np.testing.assert_array_equal(restored.predict_proba(g), before)
    assert restored.parameters() == model.parameters()


def test_load_puts_every_tensor_on_its_device(tmp_path):
    """`load_model(path, device)` rebuilds every tensor of the model on
    `device` and reads every recorded device as it (the "meta" device stands
    in for the card here); the file itself holds CPU tensors only."""
    from embiggen_tpu_torch.models.gcn import KipfGCNEdgePrediction
    from embiggen_tpu_torch.utils.persistence import load_pickle

    model = KipfGCNEdgePrediction.into_smoke_test(random_state=1, device="cpu")
    model.fit(karate_club())
    path = str(tmp_path / "m.pkl.gz")
    dump_model(model, path)
    on_cpu = load_pickle(path, "cpu")
    moved = load_model(path, device="meta")
    n = len(_tensors(model))
    assert n > 10 and len(_tensors(on_cpu)) == len(_tensors(moved)) == n
    assert {t.device.type for t in _tensors(on_cpu)} == {"cpu"}
    assert {t.device.type for t in _tensors(moved)} == {"meta"}
    assert moved.device == torch.device("meta")
    assert [(t.dtype, tuple(t.shape)) for t in _tensors(moved)] == [
        (t.dtype, tuple(t.shape)) for t in _tensors(model)]


def test_workspaces_and_graph_exports_stay_out(tmp_path):
    """A walk model's draws, a minibatch model's workspaces and a graph's
    cached device exports are left out of a pickle, and rebuilt at their
    next use: the loaded model fits as the original does."""
    from embiggen_tpu_torch.models.embedders import FirstOrderLINE, SkipGram
    from embiggen_tpu_torch.ops.negatives import BatchDraws

    g = karate_club()
    g._device_graph("cpu")
    walk = SkipGram(embedding_size=4, epochs=1, walk_length=8, window_size=2, device="cpu")
    walk._draws = BatchDraws.walks(4, 1, 8, 2, "cpu")
    line = FirstOrderLINE(embedding_size=4, epochs=1, device="cpu")
    line._fit_buffers["batches"] = BatchDraws.line(4, 2, "cpu")
    line._mean_sums[(34, 4)] = torch.zeros(3)
    path = str(tmp_path / "m.pkl.gz")
    dump_model({"walk": walk, "line": line, "graph": g}, path)
    back = load_model(path, device="cpu")
    assert back["walk"]._draws is None
    assert back["line"]._fit_buffers == {} and back["line"]._mean_sums == {}
    assert "_device_graphs" not in vars(back["graph"]) and "_device_graphs" in vars(g)
    assert back["graph"].consistent_hash() == g.consistent_hash()
    for fresh, loaded in ((SkipGram(embedding_size=4, epochs=1, walk_length=8, window_size=2,
                                    device="cpu"), back["walk"]),
                          (FirstOrderLINE(embedding_size=4, epochs=1, device="cpu"),
                           back["line"])):
        np.testing.assert_array_equal(fresh.fit_transform(g).node_embeddings[0],
                                      loaded.fit_transform(back["graph"]).node_embeddings[0])


def test_embedding_result_round_trips(tmp_path):
    """`EmbeddingResult.dump` / `load` through both packages: every
    embedding list, the names and the method name come back equal, as
    numpy arrays (a tensor given to the port's comes back on the CPU)."""
    from embiggen_tpu.models.embedding_result import EmbeddingResult as RefResult

    rng = np.random.default_rng(0)
    x, y = rng.standard_normal((5, 3)), rng.standard_normal((2, 4)).astype(np.float32)
    names = np.asarray([f"n{i}" for i in range(5)])
    for label, cls, first in (("reference", RefResult, x), ("port", EmbeddingResult,
                                                            torch.from_numpy(x))):
        result = cls("method", node_embeddings=[first, x], edge_type_embeddings=[y],
                     node_names=names)
        path = str(tmp_path / f"{label}.pkl")
        result.dump(path)
        back = cls.load(path)
        assert back.embedding_method_name == "method", label
        np.testing.assert_array_equal(back._node_names, names)
        for got, want in ((back.node_embeddings, [x, x]), (back.edge_type_embeddings, [y])):
            assert len(got) == len(want)
            for a, b in zip(got, want):
                assert isinstance(a, np.ndarray) and a.dtype == b.dtype, label
                np.testing.assert_array_equal(a, b)


def test_gcn_presets_pickle_by_name():
    """The Kipf GCN, GraphSAGE and GNN presets are found by pickle in the
    module that defines them."""
    from embiggen_tpu_torch.models import gcn

    names = [n for n in gcn.__all__ if n.startswith(("Kipf", "GraphSAGE", "GNN"))]
    assert len(names) == 9
    for name in names:
        cls = getattr(gcn, name)
        assert pickle.loads(pickle.dumps(cls)) is cls, name
        assert os.path.basename(cls.__module__.replace(".", "/")) in ("edge", "node_label")
