"""The public surface the port shares with embiggen_tpu's models: the
capability methods on every registered row of the port, equal to the
reference's for the same constructor arguments; the rows registered per
task, the catalogue and the stubs' errors against the reference's; the
refusal to build a DataFrame of over 100M rows; and
`EmbeddingResult.embedding`."""
import inspect

import numpy as np
import pytest
import torch

from embiggen_tpu.models import registry as ref_registry
from embiggen_tpu.models.embedding_result import EmbeddingResult as RefEmbeddingResult
from embiggen_tpu_torch.models import MODELS_LIBRARY, EmbeddingResult, get_model_from_library
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


def _port_class(task, name):
    """The port's row: under "Torch" where the reference's is under "TPU",
    else under the reference's library name (the sklearn adapters'
    "scikit-learn", each stub's own)."""
    libraries = MODELS_LIBRARY[task][name]
    assert len(libraries) == 1, libraries
    (library, cls), = libraries.items()
    assert library == {"TPU": "Torch"}.get(
        _reference_class(task, name).library_name(), _reference_class(task, name).library_name())
    return cls


def _smoke_kwargs(cls):
    kwargs = dict(cls.smoke_test_parameters())
    if cls.is_stochastic():
        kwargs.setdefault("random_state", 3)
    return kwargs


@pytest.mark.parametrize("task, name", ROWS)
def test_capability_methods_match_reference(task, name):
    port = _port_class(task, name)
    ref = _reference_class(task, name)
    class_methods = CLASS_METHODS + TASK_CLASS_METHODS.get(task, ())
    for method in class_methods:
        # A stub is a bare model: it has only the methods the reference's has.
        assert hasattr(port, method) == hasattr(ref, method), method
        if hasattr(ref, method):
            assert getattr(port, method)() == getattr(ref, method)(), method
    kwargs = _smoke_kwargs(ref)
    if getattr(ref, "is_stub", lambda: False)():
        # A stub's instances do not exist: both raise at construction.
        for cls, kw in ((port, dict(device="cpu", **kwargs)), (ref, kwargs)):
            with pytest.raises(ModuleNotFoundError):
                cls(**kw)
        return
    port_model, ref_model = port(device="cpu", **kwargs), ref(**kwargs)
    for method in class_methods + INSTANCE_METHODS + TASK_INSTANCE_METHODS.get(task, ()):
        assert getattr(port_model, method)() == getattr(ref_model, method)(), method


# The reference's rows the port leaves out: none, since the spectral
# embedders (ROADMAP A15).
ROWS_LEFT_OUT = set()


def test_every_row_has_its_kinds_methods():
    """The port registers all 140 of the reference's rows: per task the
    reference's names. The 61 embedders (35, the 21 KGE rows, the four
    spectral rows and the "Non Existent Model" stub) answer the C3 class
    method, the 27 edge predictors (the Perceptron, the 4 edge GCNs, 18
    sklearn adapters and 4 GBDT stubs) the C3 instance method."""
    tasks = [task for task, _ in ROWS]
    assert (tasks.count("Node Embedding"), tasks.count("Edge Prediction"), len(ROWS)) == (
        61, 27, 140)
    assert sorted(MODELS_LIBRARY) == sorted(ref_registry.MODELS_LIBRARY)
    for task in ref_registry.MODELS_LIBRARY:
        assert sorted(MODELS_LIBRARY[task]) == sorted(
            set(ref_registry.MODELS_LIBRARY[task]) - ROWS_LEFT_OUT), task
    assert {task: len(MODELS_LIBRARY[task]) for task in MODELS_LIBRARY} == {
        "Node Embedding": 61, "Edge Prediction": 27, "Node Label Prediction": 26,
        "Edge Label Prediction": 25, "Feature Preprocessor": 1}


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
    port = _init_defaults(_port_class(task, name))
    ref = _init_defaults(_reference_class(task, name))
    for k in PORT_PARAMETERS:
        port.pop(k, None)
    assert sorted(port) == sorted(ref)
    assert {k: v for k, v in port.items() if v != ref[k]} == {}


def test_walk_rows_keep_checkpoint_interval():
    """C6: the Node2Vec rows are built with `checkpoint_interval`, as the
    reference's are, and take `checkpoint_dir` (ported with A12)."""
    for name in ("Node2Vec", "Node2Vec SkipGram", "Node2Vec CBOW"):
        cls = MODELS_LIBRARY["Node Embedding"][name]["Torch"]
        assert cls(checkpoint_interval=5, device="cpu")._checkpoint_interval == 5
        _reference_class("Node Embedding", name)(checkpoint_interval=5)
        assert cls(checkpoint_dir="somewhere", device="cpu")._checkpoint_dir == "somewhere"


def test_top_level_names_match_reference():
    """C7: the package exports the reference's top-level names,
    `transformers` among them."""
    import embiggen_tpu
    import embiggen_tpu_torch

    assert sorted(embiggen_tpu_torch.__all__) == sorted(embiggen_tpu.__all__)
    for name in embiggen_tpu_torch.__all__:
        assert hasattr(embiggen_tpu_torch, name), name


@pytest.mark.parametrize("task, name", ROWS)
def test_supports_distribution_matches_reference_but_for_a13(task, name):
    """Equal to the reference's answer on every row that has one: since
    ROADMAP A13 no row is left out (the walk-based rows, Role2Vec and both
    GloVe rows train on a mesh too)."""
    port = _port_class(task, name)
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


STUBS = [(task, name) for task, name in ROWS if getattr(_port_class(task, name), "is_stub",
                                                         lambda: False)()]


@pytest.mark.parametrize("task, name", STUBS)
def test_stub_raises_the_reference_error(task, name):
    """The 12 GBDT stubs and "Non Existent Model": each raises the
    reference's ModuleNotFoundError, word for word (the missing package, and
    that no other library implements the model)."""
    errors = []
    for cls in (_port_class(task, name), _reference_class(task, name)):
        assert cls.is_stub() and cls.task_name() == task
        with pytest.raises(ModuleNotFoundError) as err:
            cls()
        errors.append(str(err.value))
    assert errors[0] == errors[1]
    assert "no other implementation" in errors[0]


def test_stubs_cover_the_reference_stubs():
    ref_stubs = sorted((task, name) for task, models in ref_registry.MODELS_LIBRARY.items()
                       for name in models if getattr(_reference_class(task, name), "is_stub",
                                                     lambda: False)())
    assert len(STUBS) == 13 and sorted(STUBS) == ref_stubs


def test_stub_error_names_alternative_libraries():
    """As in the reference: with a sibling implementation of the same
    model registered, the stub's error names it."""
    libraries = MODELS_LIBRARY["Edge Prediction"]["XGBoost"]
    stub = libraries["XGBoost"]
    libraries["OtherLib"] = type("FakeXGB", (), {
        "task_name": classmethod(lambda c: "Edge Prediction"),
        "model_name": classmethod(lambda c: "XGBoost"),
        "library_name": classmethod(lambda c: "OtherLib")})
    try:
        with pytest.raises(ModuleNotFoundError, match="implemented in OtherLib"):
            stub()
    finally:
        libraries.pop("OtherLib")
    assert get_model_from_library("xgboost", task_name="Edge Prediction") is stub


def _catalogue_rows(classes, reference):
    """(task, model, library) of each class, "TPU" read as "Torch" and the
    rows in ROWS_LEFT_OUT dropped on the reference's side."""
    rows = [(c.task_name(), c.model_name(), c.library_name()) for c in classes]
    if reference:
        rows = [(t, m, "Torch" if lib == "TPU" else lib) for t, m, lib in rows
                if m not in ROWS_LEFT_OUT]
    return rows


def test_catalogue_equals_reference():
    """`find_available_models`, the four `get_available_models_for_*` and
    `get_models_dataframe` list the reference's rows, the spectral ones
    among them, with the same capability columns."""
    from embiggen_tpu_torch.models import registry

    assert registry.TASK_NAMES == ref_registry.TASK_NAMES
    for task in registry.TASK_NAMES:
        got = _catalogue_rows(registry.find_available_models(task), False)
        want = _catalogue_rows(ref_registry.find_available_models(task), True)
        assert sorted(got) == sorted(want), task
        if task != "Node Embedding":
            assert got == want, task   # the task packages import in the reference's order
    for suffix in ("node_embedding", "edge_prediction", "edge_label_prediction",
                   "node_label_prediction"):
        fn = f"get_available_models_for_{suffix}"
        assert sorted(_catalogue_rows(getattr(registry, fn)(), False)) == sorted(
            _catalogue_rows(getattr(ref_registry, fn)(), True)), fn
    keys = ["task_name", "model_name", "library_name"]
    got = registry.get_models_dataframe().sort_values(keys).reset_index(drop=True)
    want = ref_registry.get_models_dataframe()
    want = want[~want["model_name"].isin(ROWS_LEFT_OUT)].replace({"library_name": {"TPU": "Torch"}})
    want = want.sort_values(keys).reset_index(drop=True)
    assert list(got.columns) == list(want.columns) and len(got) == 140
    assert got.equals(want)
