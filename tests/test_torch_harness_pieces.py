"""The evaluation harness's host pieces on the native helpers, on the CPU.

Draw parity: on a small planted-partition graph, `connected_holdout`,
`random_holdout` and `sample_negative_graph` give the arrays that their plain
versions give (every native helper replaced by its `_plain` numpy version)
and the JAX package's functions give, so the native helpers change no draw.
Then the evaluation entry point's `profile_dir` (a torch.profiler trace a
holdout, naming the fit's range), its `enable_cache` (rows served from the
experiment cache),
`sample_negative_graph`'s default device (the card), the profiling module's
`PhaseTimer` and `device_memory_stats` against the JAX package's, and the
harness's split recorder run from its source, as `harness_turns.py` runs it
in a checkout whose harness lacks it."""
import glob
import inspect
import json

import numpy as np
import pytest
import torch

from embiggen_tpu.graph import generators as ref_generators
from embiggen_tpu.graph.holdouts import connected_holdout as ref_connected_holdout
from embiggen_tpu.graph.holdouts import random_holdout as ref_random_holdout
from embiggen_tpu.graph.sampling import sample_negative_graph as ref_sample_negative_graph
from embiggen_tpu.utils import profiling as ref_profiling
from embiggen_tpu_torch import native
from embiggen_tpu_torch.graph import (
    connected_holdout, erdos_renyi, planted_partition_edges, random_holdout,
    sample_negative_graph,
)
from embiggen_tpu_torch.graph import sampling
from embiggen_tpu_torch.models.edge_prediction import PerceptronEdgePrediction
from embiggen_tpu_torch.pipelines import edge_prediction_evaluation, evaluation
from embiggen_tpu_torch.scripts import harness, harness_turns
from embiggen_tpu_torch.utils import profiling

torch.set_num_threads(1)
GRAPH = dict(n_nodes=3000, n_edges=12000, n_communities=6, seed=2)
HELPERS = ("alias_tables", "spanning_forest", "radix_argsort", "ranking_metrics_sorted",
           "sort_pairs", "sort_unique_pairs", "build_sym_csr", "parse_edge_list")


@pytest.fixture(scope="module")
def graphs():
    return planted_partition_edges(**GRAPH), ref_generators.planted_partition_edges(**GRAPH)


@pytest.fixture
def plain(monkeypatch):
    """Every native helper replaced by its plain version, and an empty
    negative-graph cache."""
    def use_plain():
        for name in HELPERS:
            monkeypatch.setattr(native, name, getattr(native, f"{name}_plain"))
        sampling._NEG_CACHE.clear()
    sampling._NEG_CACHE.clear()
    yield use_plain
    sampling._NEG_CACHE.clear()


def _arrays(graph):
    return [np.asarray(graph.row_ptr), np.asarray(graph.col_idx)]


def _same(a, b):
    for x, y in zip(_arrays(a), _arrays(b)):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("split", ["connected", "random"])
@pytest.mark.parametrize("random_state", [0, 7])
def test_holdouts_keep_their_draws(graphs, plain, split, random_state):
    port, ref = graphs
    fn, ref_fn = {"connected": (connected_holdout, ref_connected_holdout),
                  "random": (random_holdout, ref_random_holdout)}[split]
    got = fn(port, train_size=0.8, random_state=random_state)
    want = ref_fn(ref, train_size=0.8, random_state=random_state)
    plain()
    for g, w, p in zip(got, want, fn(port, train_size=0.8, random_state=random_state)):
        _same(g, w)
        _same(g, p)
    assert got[0].number_of_edges + got[1].number_of_edges == port.number_of_edges


@pytest.mark.parametrize("scale_free", [True, False])
@pytest.mark.parametrize("with_support", [False, True])
def test_negative_graph_keeps_its_draws(graphs, plain, scale_free, with_support):
    port, ref = graphs
    train, _ = connected_holdout(port, random_state=1)
    ref_train, _ = ref_connected_holdout(ref, random_state=1)
    kw = dict(number_of_negative_samples=train.number_of_edges, random_state=4,
              use_scale_free_distribution=scale_free)
    got = sample_negative_graph(train, support=port if with_support else None,
                                device="cpu", **kw)
    want = ref_sample_negative_graph(ref_train, support=ref if with_support else None, **kw)
    _same(got, want)
    plain()
    _same(got, sample_negative_graph(train, support=port if with_support else None,
                                     device="cpu", **kw))
    assert got.number_of_edges == train.number_of_edges


@pytest.mark.parametrize("holdouts", [1, 2])
def test_profile_dir_writes_a_trace_a_holdout(tmp_path, holdouts):
    model = PerceptronEdgePrediction(edge_features=["Degree"], number_of_epochs=2,
                                     random_state=0, device="cpu")
    rows = edge_prediction_evaluation(
        holdouts_number=holdouts, models=model, graphs=erdos_renyi(200, 800, seed=0),
        random_state=3, profile_dir=str(tmp_path))
    assert len(rows) == 2 * holdouts
    for h in range(holdouts):
        traces = glob.glob(str(tmp_path / f"holdout_{h}" / "*.json"))
        assert len(traces) == 1
        with open(traces[0]) as f:
            events = json.load(f)["traceEvents"]
        assert any(e.get("name") == f"fit:{model.model_name()}" for e in events)
    assert sorted(p.name for p in tmp_path.iterdir()) == [f"holdout_{h}"
                                                           for h in range(holdouts)]


def test_enable_cache_still_raises(tmp_path):
    """The experiment cache (ROADMAP A12) is ported since: a second call
    with the same key reads the first call's rows back from its file."""
    calls = []
    kw = dict(holdouts_number=1, graphs=erdos_renyi(50, 200, seed=0), enable_cache=True,
              cache_dir=str(tmp_path), random_state=3)
    first = edge_prediction_evaluation(
        models=PerceptronEdgePrediction(number_of_epochs=1, device="cpu"), **kw)

    class Counting(PerceptronEdgePrediction):
        def _fit(self, *args, **kwargs):
            calls.append(1)
            return super()._fit(*args, **kwargs)

    second = edge_prediction_evaluation(models=Counting(number_of_epochs=1, device="cpu"), **kw)
    assert calls == [] and second == first


def test_sample_negative_graph_defaults_to_the_card():
    assert inspect.signature(sample_negative_graph).parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        g = erdos_renyi(60, 200, seed=11)
        with pytest.raises((RuntimeError, AssertionError)):
            sample_negative_graph(g, 25, random_state=123)


@pytest.mark.parametrize("phases", [("fit", "fit"), ("split", "fit", "predict", "fit")])
def test_phase_timer_matches_the_reference(phases):
    port, ref = profiling.PhaseTimer(), ref_profiling.PhaseTimer()
    for name in phases:
        for timer in (port, ref):
            with timer.phase(name):
                pass
    for suffix in ("_time", "_s"):
        assert list(port.as_dict(suffix)) == list(ref.as_dict(suffix))
    assert all(v >= 0 for v in port.as_dict().values())


def test_device_memory_stats_on_the_cpu():
    assert profiling.device_memory_stats("cpu") is None
    if not torch.cuda.is_available():
        assert profiling.device_memory_stats() is None


def test_split_recorder_runs_from_its_source():
    ns = {}
    exec(harness_turns.recorder_source(), ns)
    get = evaluation._HoldoutMemo.get
    g = erdos_renyi(200, 800, seed=0)
    with ns["recorded_split"]() as split:
        edge_prediction_evaluation(
            holdouts_number=1, graphs=g, random_state=0,
            models=PerceptronEdgePrediction(edge_features=["Degree"], number_of_epochs=1,
                                            random_state=0, device="cpu"))
    assert evaluation._HoldoutMemo.get is get
    assert split["sha1"] == harness.split_sha1(
        *connected_holdout(g, train_size=0.8, random_state=0))
