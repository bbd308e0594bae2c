"""The public surface the port shares with embiggen_tpu's models: the
capability methods on every registered row of the port, equal to the
reference's for the same constructor arguments; the refusal to build a
DataFrame of over 100M rows; and `EmbeddingResult.embedding`."""
import inspect

import numpy as np
import pytest
import torch

from embiggen_tpu.models import registry as ref_registry
from embiggen_tpu.models.embedding_result import EmbeddingResult as RefEmbeddingResult
from embiggen_tpu_torch.models import MODELS_LIBRARY, EmbeddingResult
from embiggen_tpu_torch.models.embedders import NodeSketch, SkipGram

torch.set_num_threads(1)

CLASS_METHODS = ("requires_edge_weights", "requires_positive_edge_weights",
                 "requires_node_types", "requires_edge_types", "can_use_edge_weights",
                 "can_use_node_types", "can_use_edge_types")
INSTANCE_METHODS = ("is_using_edge_weights", "is_using_node_types", "is_using_edge_types")
# The methods of one kind of row: the embedders' class method and the
# classifiers' instance method.
TASK_CLASS_METHODS = {"Node Embedding": ("requires_nodes_sorted_by_decreasing_node_degree",)}
TASK_INSTANCE_METHODS = {"Edge Prediction": ("is_multilabel_prediction_task",)}
ROWS = sorted((task, name) for task, models in MODELS_LIBRARY.items() for name in models)


def _reference_class(task, name):
    libraries = ref_registry.MODELS_LIBRARY[task][name]
    assert len(libraries) == 1, libraries
    return next(iter(libraries.values()))


def _smoke_kwargs(cls):
    kwargs = dict(cls.smoke_test_parameters())
    if cls.is_stochastic():
        kwargs.setdefault("random_state", 3)
    return kwargs


@pytest.mark.parametrize("task, name", ROWS)
def test_capability_methods_match_reference(task, name):
    port = MODELS_LIBRARY[task][name]["Torch"]
    ref = _reference_class(task, name)
    class_methods = CLASS_METHODS + TASK_CLASS_METHODS.get(task, ())
    for method in class_methods:
        assert getattr(port, method)() == getattr(ref, method)(), method
    kwargs = _smoke_kwargs(ref)
    port_model, ref_model = port(device="cpu", **kwargs), ref(**kwargs)
    for method in class_methods + INSTANCE_METHODS + TASK_INSTANCE_METHODS.get(task, ()):
        assert getattr(port_model, method)() == getattr(ref_model, method)(), method


# The reference's rows the port leaves out: the label tasks' sklearn
# adapters and the GBDT stubs (ROADMAP A15).
LABEL_ROWS_LEFT_OUT = {
    "Random Forest Classifier", "Extra Trees Classifier", "Decision Tree Classifier",
    "Logistic Regression Classifier", "Gradient Boosting Classifier", "AdaBoost Classifier",
    "Bagging Classifier", "K-Neighbour Classifier", "Gaussian Naive Bayes", "MLP Classifier",
    "MLP Regression", "Hist Gradient Boosting Classifier", "Linear Support Vector Classifier",
    "Nu Support Vector Classifier", "Radius Neighbour Classifier",
    "Logistic Regression Cross Validator", "Ridge Classifier",
    "Ridge Classifier Cross Validator", "XGBoost", "LightGBM", "CatBoost", "LLeaves",
}


def test_every_row_has_its_kinds_methods():
    """The 56 embedders (35, and the 21 KGE rows) answer the C3 class
    method, the 5 edge predictors the C3 instance method; with the 4
    node-label and 4 edge-label GCNs and Graph Convolution, 70 rows. The
    label tasks and the preprocessor register the reference's names but
    for its sklearn adapters and GBDT stubs."""
    tasks = [task for task, _ in ROWS]
    assert (tasks.count("Node Embedding"), tasks.count("Edge Prediction"), len(ROWS)) == (56, 5, 70)
    for task in ("Node Label Prediction", "Edge Label Prediction", "Feature Preprocessor"):
        assert sorted(MODELS_LIBRARY[task]) == sorted(
            set(ref_registry.MODELS_LIBRARY[task]) - LABEL_ROWS_LEFT_OUT), task
        assert len(MODELS_LIBRARY[task]) == (1 if task == "Feature Preprocessor" else 4)


# Constructor parameters the port adds to every row: where it trains, and
# tables to start from.
PORT_PARAMETERS = ("device", "initial_params")


def _init_defaults(cls):
    return {k: v.default for k, v in inspect.signature(cls.__init__).parameters.items()
            if k != "self"}


@pytest.mark.parametrize("task, name", ROWS)
def test_constructor_parameters_match_reference(task, name):
    """Every row's constructor takes the reference's parameter names with
    the same defaults (C6: the Node2Vec rows' `checkpoint_interval`), and
    no other name but the port's own."""
    port = _init_defaults(MODELS_LIBRARY[task][name]["Torch"])
    ref = _init_defaults(_reference_class(task, name))
    for k in PORT_PARAMETERS:
        port.pop(k, None)
    assert sorted(port) == sorted(ref)
    assert {k: v for k, v in port.items() if v != ref[k]} == {}


def test_walk_rows_keep_checkpoint_interval():
    """C6: the Node2Vec rows are built with `checkpoint_interval`, as the
    reference's are; `checkpoint_dir` still raises, naming A12."""
    for name in ("Node2Vec", "Node2Vec SkipGram", "Node2Vec CBOW"):
        cls = MODELS_LIBRARY["Node Embedding"][name]["Torch"]
        assert cls(checkpoint_interval=5, device="cpu")._checkpoint_interval == 5
        _reference_class("Node Embedding", name)(checkpoint_interval=5)
        with pytest.raises(NotImplementedError, match="A12"):
            cls(checkpoint_dir="somewhere", device="cpu")


def test_top_level_names_match_reference():
    """C7: the package exports the reference's top-level names, but for
    `transformers` (ROADMAP A15)."""
    import embiggen_tpu
    import embiggen_tpu_torch

    assert sorted(embiggen_tpu_torch.__all__) == sorted(
        set(embiggen_tpu.__all__) - {"transformers"})
    for name in embiggen_tpu_torch.__all__:
        assert hasattr(embiggen_tpu_torch, name), name


@pytest.mark.parametrize("task, name", ROWS)
def test_supports_distribution_matches_reference_but_for_a13(task, name):
    """Equal to the reference's answer on every row that has one: since
    ROADMAP A13 no row is left out (the walk-based rows, Role2Vec and both
    GloVe rows train on a mesh too)."""
    port = MODELS_LIBRARY[task][name]["Torch"]
    ref = _reference_class(task, name)
    if not hasattr(ref, "supports_distribution"):
        return
    assert port.supports_distribution() == ref.supports_distribution()


class _HugeGraph:
    """What `fit_transform` reads of a graph before it fits: a graph of
    100,000,001 nodes and one arc."""
    name = "huge"
    number_of_nodes = 100_000_001
    number_of_directed_edges = 1
    has_edge_weights = has_node_types = has_edge_types = False
    degrees = np.ones(1, np.int32)


@pytest.mark.parametrize("model", [NodeSketch(device="cpu"),
                                   SkipGram(device="cpu", embedding_size=4)])
def test_fit_transform_refuses_a_dataframe_of_over_100m_rows(model):
    with pytest.raises(ValueError, match=r"Refusing to build a >100M-row DataFrame; set "
                                         r"return_dataframe=False\."):
        model.fit_transform(_HugeGraph(), return_dataframe=True)


@pytest.mark.parametrize("kinds", [
    ("node",), ("edge",), ("node_type",), ("edge_type",), ("node", "node"), ("node", "edge"),
])
def test_embedding_property_matches_reference(kinds):
    rng = np.random.default_rng(0)
    kwargs = {}
    for kind in kinds:
        kwargs.setdefault(f"{kind}_embeddings", []).append(rng.random((5, 3)).astype(np.float32))
    port = EmbeddingResult("m", **kwargs)
    ref = RefEmbeddingResult("m", **kwargs)
    if len(kinds) == 1:
        np.testing.assert_array_equal(port.embedding, ref.embedding)
        assert port.embedding is getattr(port, f"{kinds[0]}_embeddings")[0]
    else:
        for result in (port, ref):
            with pytest.raises(ValueError, match=f"EmbeddingResult holds {len(kinds)} "
                                                 "embeddings; use explicit accessors."):
                result.embedding
