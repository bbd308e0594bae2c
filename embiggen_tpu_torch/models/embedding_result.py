"""EmbeddingResult — counterpart of `embiggen_tpu/models/embedding_result.py`:
lists of node / edge / node-type / edge-type embeddings as numpy arrays,
validated for non-emptiness and NaN/Inf, with optional DataFrame views.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch


def _to_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class EmbeddingResult:
    """Validated container of embedding matrices produced by a model."""

    def __init__(
        self,
        embedding_method_name: str,
        node_embeddings: Optional[Sequence] = None,
        edge_embeddings: Optional[Sequence] = None,
        node_type_embeddings: Optional[Sequence] = None,
        edge_type_embeddings: Optional[Sequence] = None,
        node_names: Optional[np.ndarray] = None,
        validate: bool = True,
    ):
        self.embedding_method_name = embedding_method_name
        self._node_names = node_names

        def norm(seq, kind):
            if seq is None:
                return []
            if not isinstance(seq, (list, tuple)):
                seq = [seq]
            out = []
            for i, e in enumerate(seq):
                arr = e if hasattr(e, "loc") else _to_numpy(e)
                if validate:
                    self._validate(arr, f"{kind}[{i}]")
                out.append(arr)
            return out

        self.node_embeddings: List = norm(node_embeddings, "node_embeddings")
        self.edge_embeddings: List = norm(edge_embeddings, "edge_embeddings")
        self.node_type_embeddings: List = norm(
            node_type_embeddings, "node_type_embeddings"
        )
        self.edge_type_embeddings: List = norm(
            edge_type_embeddings, "edge_type_embeddings"
        )
        if validate and not (
            self.node_embeddings
            or self.edge_embeddings
            or self.node_type_embeddings
            or self.edge_type_embeddings
        ):
            raise ValueError(
                f"EmbeddingResult from {embedding_method_name!r} contains no "
                "embeddings."
            )

    def _validate(self, arr, label: str) -> None:
        values = arr.values if hasattr(arr, "values") else arr
        if values.size == 0:
            raise ValueError(
                f"{label} from {self.embedding_method_name!r} is empty."
            )
        # Skip the NaN scan for very large matrices, as the reference does.
        if values.shape[0] <= 1_000_000:
            if not np.isfinite(values).all():
                raise ValueError(
                    f"{label} from {self.embedding_method_name!r} contains "
                    "NaN or Inf values."
                )
            if not values.any():
                import warnings

                warnings.warn(
                    f"{label} from {self.embedding_method_name!r} is all "
                    "zeros."
                )

    def get_node_embedding_from_index(self, index: int = 0):
        return self.node_embeddings[index]

    def get_all_node_embedding(self) -> List:
        return self.node_embeddings

    def get_all_edge_embedding(self) -> List:
        return self.edge_embeddings

    @property
    def embedding(self):
        """The one embedding this result holds; raises unless it holds
        exactly one."""
        total = (
            self.node_embeddings
            + self.edge_embeddings
            + self.node_type_embeddings
            + self.edge_type_embeddings
        )
        if len(total) != 1:
            raise ValueError(
                f"EmbeddingResult holds {len(total)} embeddings; use explicit "
                "accessors."
            )
        return total[0]

    def to_dataframes(self) -> "EmbeddingResult":
        """Convert ndarray node embeddings to DataFrames indexed by node name."""
        import pandas as pd

        if self._node_names is None:
            raise ValueError("No node names available to index DataFrames.")
        node_embeddings = [
            e
            if hasattr(e, "loc")
            else pd.DataFrame(_to_numpy(e), index=self._node_names)
            for e in self.node_embeddings
        ]
        return EmbeddingResult(
            self.embedding_method_name,
            node_embeddings=node_embeddings,
            edge_embeddings=self.edge_embeddings,
            node_type_embeddings=self.node_type_embeddings,
            edge_type_embeddings=self.edge_type_embeddings,
            node_names=self._node_names,
            validate=False,
        )

    def __repr__(self) -> str:
        def shapes(seq):
            return [tuple(getattr(e, "shape", ())) for e in seq]

        return (
            f"EmbeddingResult(method={self.embedding_method_name!r}, "
            f"node={shapes(self.node_embeddings)}, "
            f"edge={shapes(self.edge_embeddings)}, "
            f"node_type={shapes(self.node_type_embeddings)}, "
            f"edge_type={shapes(self.edge_type_embeddings)})"
        )
