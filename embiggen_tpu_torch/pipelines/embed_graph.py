"""`embed_graph` pipeline — counterpart of
`embiggen_tpu/pipelines/embed_graph.py`: resolve the graph name through
`get_dataset` and the model name through the port's registry, build the
model, run fit_transform."""
from __future__ import annotations

from typing import Optional, Union

from ..graph.graph import Graph
from ..graph.loaders import get_dataset
from ..models.abstract import AbstractEmbeddingModel
from ..models.embedding_result import EmbeddingResult
from ..models.registry import get_model_from_library


def embed_graph(
    graph: Union[Graph, str],
    embedding_model: Union[AbstractEmbeddingModel, str],
    library_name: Optional[str] = None,
    smoke_test: bool = False,
    return_dataframe: bool = False,
    **kwargs,
) -> EmbeddingResult:
    if isinstance(graph, str):
        graph = get_dataset(graph)
    if isinstance(embedding_model, str):
        cls = get_model_from_library(
            embedding_model, task_name="Node Embedding",
            library_name=library_name,
        )
        embedding_model = (
            cls.into_smoke_test(**kwargs) if smoke_test else cls(**kwargs)
        )
    elif smoke_test:
        embedding_model = type(embedding_model).into_smoke_test(
            **embedding_model.parameters(), device=embedding_model.device
        )
    if not isinstance(embedding_model, AbstractEmbeddingModel):
        raise ValueError(
            f"Expected an AbstractEmbeddingModel, got "
            f"{type(embedding_model).__name__}."
        )
    try:
        return embedding_model.fit_transform(
            graph, return_dataframe=return_dataframe
        )
    except Exception as exc:
        raise RuntimeError(
            f"Error embedding graph {graph.name} with model "
            f"{embedding_model.model_name()} from library "
            f"{embedding_model.library_name()}: {exc}"
        ) from exc
