"""embiggen_tpu_torch — the PyTorch and CUDA port of embiggen_tpu, for one
NVIDIA H100.

It mirrors embiggen_tpu's module paths and public names. Plain tensor code
is PyTorch; the device kernels are hand-written CUDA C++ for sm_90a in
`csrc/`, built with nvcc at first use, each beside a plain PyTorch version
that runs on CPU tensors. The package imports neither jax nor embiggen_tpu.
"""
__version__ = "0.1.0"

from . import graph
from .graph import Graph
from . import models
from . import transformers
from .pipelines import (
    classification_evaluation_pipeline,
    edge_label_prediction_evaluation,
    edge_prediction_evaluation,
    embed_graph,
    node_label_prediction_evaluation,
)

__all__ = [
    "graph", "Graph", "models", "transformers", "embed_graph", "classification_evaluation_pipeline",
    "edge_prediction_evaluation", "edge_label_prediction_evaluation",
    "node_label_prediction_evaluation", "__version__",
]
