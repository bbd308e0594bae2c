"""The public surface the port shares with embiggen_tpu's models: the
capability methods on every registered row of the port, equal to the
reference's for the same constructor arguments; the refusal to build a
DataFrame of over 100M rows; and `EmbeddingResult.embedding`."""
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
    for method in CLASS_METHODS:
        assert getattr(port, method)() == getattr(ref, method)(), method
    kwargs = _smoke_kwargs(ref)
    port_model, ref_model = port(device="cpu", **kwargs), ref(**kwargs)
    for method in CLASS_METHODS + INSTANCE_METHODS:
        assert getattr(port_model, method)() == getattr(ref_model, method)(), method


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
