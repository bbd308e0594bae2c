"""The embedding cache and the experiment cache of the port, on the CPU:
`tests/test_experiment_cache.py`'s four tests and the reference's
`test_embedding_cache` (`tests/test_utils_extras.py`), against the port's
entry points, whose evaluations return rows (dicts) where the JAX package's
return DataFrames; the cache files' layout against the JAX package's; and
the rows read back from a file with the types the facade returned."""
import math
import os

import numpy as np
import pytest

from embiggen_tpu_torch.graph import karate_club
from embiggen_tpu_torch.models.edge_prediction import PerceptronEdgePrediction
from embiggen_tpu_torch.pipelines import edge_prediction_evaluation


@pytest.fixture(scope="module")
def karate():
    return karate_club()


def _files(root):
    return sorted(os.path.relpath(os.path.join(dp, f), root)
                  for dp, _, fs in os.walk(root) for f in fs)


def _layout(relpath):
    """A cache file's path with its hash replaced by a mark."""
    head, name = os.path.split(relpath)
    return os.path.join(head, "<hash>" + name[32:]), len(name.split(".")[0])


def test_model_level_evaluate(karate):
    model = PerceptronEdgePrediction(number_of_epochs=5, random_state=0, device="cpu")
    rows = model.evaluate(karate, holdouts_number=2)
    assert len(rows) == 2 * 2  # holdouts x {train, test}
    assert {r["evaluation_mode"] for r in rows} == {"train", "test"}
    assert {"auroc", "auprc", "fit_time", "holdout_number"} <= set(rows[0])
    assert all(r["model_name"] == "Perceptron" for r in rows)


def test_evaluate_cache_roundtrip(karate, tmp_path):
    """A second evaluate() with the same key is served from disk: the fit
    counter does not advance, and the rows are equal, with the same types;
    other hyper-parameters miss the cache."""
    calls = {"n": 0}

    class CountingPerceptron(PerceptronEdgePrediction):
        def _fit(self, *args, **kwargs):
            calls["n"] += 1
            return super()._fit(*args, **kwargs)

    cache_dir = str(tmp_path / "cache")
    model = CountingPerceptron(number_of_epochs=5, random_state=0, device="cpu")
    rows1 = model.evaluate(karate, holdouts_number=2, enable_cache=True, cache_dir=cache_dir)
    assert calls["n"] == 2
    found = _files(cache_dir)
    assert len(found) == 1
    layout, width = _layout(found[0])
    assert layout == os.path.join("experiments", "Edge_Prediction", "KarateClub",
                                  "<hash>.csv.gz") and width == 32
    rows2 = model.evaluate(karate, holdouts_number=2, enable_cache=True, cache_dir=cache_dir)
    assert calls["n"] == 2  # cache hit: no refit
    assert rows2 == rows1
    assert [[type(v) for v in r.values()] for r in rows2] == [
        [type(v) for v in r.values()] for r in rows1]
    CountingPerceptron(number_of_epochs=7, random_state=0, device="cpu").evaluate(
        karate, holdouts_number=2, enable_cache=True, cache_dir=cache_dir)
    assert calls["n"] == 4


def test_cache_disabled_across_workers(karate, tmp_path):
    """With number_of_workers set the cache is off: workers would race
    writing the same file."""
    cache_dir = str(tmp_path / "wcache")
    model = PerceptronEdgePrediction(number_of_epochs=5, random_state=0, device="cpu")
    rows = model.evaluate(karate, holdouts_number=2, enable_cache=True, cache_dir=cache_dir,
                          number_of_workers=2, worker_id=0)
    assert len(rows) == 1 * 2  # this worker owns holdout 0 only
    assert not os.path.exists(cache_dir)


def test_pipeline_uses_cache(karate, tmp_path):
    cache_dir = str(tmp_path / "pcache")
    kwargs = dict(holdouts_number=2, models=["Perceptron"], graphs=karate, enable_cache=True,
                  cache_dir=cache_dir, random_state=3, device="cpu")
    rows1 = edge_prediction_evaluation(**kwargs)
    rows2 = edge_prediction_evaluation(**kwargs)
    np.testing.assert_array_equal([r["auprc"] for r in rows1], [r["auprc"] for r in rows2])
    assert rows1 == rows2
    # smoke_test turns the cache off
    rows3 = edge_prediction_evaluation(
        holdouts_number=1, models=["Perceptron"], graphs=karate, enable_cache=True,
        cache_dir=str(tmp_path / "scache"), smoke_test=True, device="cpu")
    assert not os.path.exists(str(tmp_path / "scache"))
    assert len(rows3) == 2


def test_rows_round_trip_with_their_types(tmp_path):
    """Every scalar the facades return comes back with its value and type:
    floats bit for bit (nan and the infinities too), ints, bools, None and
    strings that look like numbers; a numpy scalar comes back as its Python
    value."""
    from embiggen_tpu_torch.pipelines.evaluation import (
        read_experiment_rows, write_experiment_rows,
    )

    rows = [{"a": 0.1 + 0.2, "b": 3, "c": "train", "d": True, "e": None, "f": float("nan")},
            {"a": float("inf"), "b": -2**40, "c": "1.5", "d": False, "e": "None",
             "f": -float("inf"), "g": np.float32(0.5)}]
    path = str(tmp_path / "x" / "rows.csv.gz")
    write_experiment_rows(rows, path)
    back = read_experiment_rows(path)
    assert [list(r) for r in back] == [list("abcdefg")] * 2
    assert back[0]["g"] is None and back[1]["g"] == 0.5 and type(back[1]["g"]) is float
    for got, want in zip(back, rows):
        for k, v in want.items():
            if isinstance(v, float) and math.isnan(v):
                assert math.isnan(got[k])
            else:
                assert got[k] == v and type(got[k]) is type(v.item() if isinstance(
                    v, np.generic) else v), k


def test_embedding_cache(tmp_path, monkeypatch):
    """The reference's `test_embedding_cache` through both packages: one
    file after the first fit, the second fit served from it; the port's file
    has the JAX package's layout, and its key holds the device type."""
    import embiggen_tpu.utils.cache as ref_cache_mod
    import embiggen_tpu_torch.utils.cache as cache_mod
    from embiggen_tpu.graph import karate_club as ref_karate
    from embiggen_tpu.models.embedders import DegreeSPINE as RefDegreeSPINE
    from embiggen_tpu_torch.models.embedders import DegreeSPINE

    layouts = {}
    for label, module, cls, g, kw in (
            ("reference", ref_cache_mod, RefDegreeSPINE, ref_karate(), {}),
            ("port", cache_mod, DegreeSPINE, karate_club(), {"device": "cpu"})):
        root = str(tmp_path / label)
        monkeypatch.setattr(module, "DEFAULT_CACHE_DIR", root)
        r1 = cls(embedding_size=5, enable_cache=True, **kw).fit_transform(g)
        files = _files(root)
        assert len(files) == 1, label
        layout, width = _layout(files[0])
        layouts[label] = layout.replace(f"/{cls.library_name()}/", "/<library>/"), width
        r2 = cls(embedding_size=5, enable_cache=True, **kw).fit_transform(g)
        np.testing.assert_array_equal(np.asarray(r1.get_node_embedding_from_index(0)),
                                      np.asarray(r2.get_node_embedding_from_index(0)))
    assert layouts["port"] == layouts["reference"] == (
        "embedding/Degree-based_SPINE/<library>/KarateClub/<hash>.pkl.gz", 32)

    # The second fit is not run: a model whose fit raises is served too.
    class Failing(DegreeSPINE):
        def _fit_transform(self, graph):
            raise AssertionError("fit ran")

    Failing(embedding_size=5, enable_cache=True, device="cpu").fit_transform(karate_club())
    # Another device type is another key.
    from embiggen_tpu_torch.utils.cache import Cache

    seen = []
    wrapped = Cache("{hash}", cache_dir=str(tmp_path / "keys"))(
        lambda model, graph: seen.append(model.device.type) or model.device.type)
    for device in ("cpu", "meta"):
        wrapped(DegreeSPINE(embedding_size=5, enable_cache=True, device=device), karate_club())
    assert seen == ["cpu", "meta"] and len(_files(str(tmp_path / "keys"))) == 2
