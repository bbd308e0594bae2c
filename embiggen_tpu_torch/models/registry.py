"""Model registry — counterpart of `embiggen_tpu/models/registry.py`: models
register at import time through the `@register_model` decorator and resolve
by (task, model, library) name; the catalogue lists them by task, or as a
pandas DataFrame of their capabilities (pandas imported only there)."""
from __future__ import annotations

from typing import Dict, List, Optional

TASK_NAMES = [
    "Node Embedding",
    "Edge Prediction",
    "Edge Label Prediction",
    "Node Label Prediction",
    "Feature Preprocessor",
]

# task_name -> model_name -> library_name -> class. The tasks are keyed in
# TASK_NAMES' order whatever order the modules register in, so a name that
# several tasks share ("GraphSAGE", "Decision Tree Classifier") resolves
# without a task to its edge-prediction row.
MODELS_LIBRARY: Dict[str, Dict[str, Dict[str, type]]] = {task: {} for task in TASK_NAMES}


def register_model(cls):
    """Class decorator: register by (task_name, model_name, library_name)."""
    task = cls.task_name()
    model = cls.model_name()
    library = cls.library_name()
    MODELS_LIBRARY.setdefault(task, {}).setdefault(model, {})[library] = cls
    return cls


def get_model_from_library(
    model_name: str,
    task_name: Optional[str] = None,
    library_name: Optional[str] = None,
) -> type:
    """Resolve a model class by case-insensitive name; prefers this
    package's 'Torch' library on ambiguity."""
    candidates = []
    tasks = [task_name] if task_name else list(MODELS_LIBRARY)
    for task in tasks:
        for m_name, libs in MODELS_LIBRARY.get(task, {}).items():
            if m_name.lower() != model_name.lower():
                continue
            for lib, cls in libs.items():
                if library_name is None or lib.lower() == library_name.lower():
                    candidates.append(cls)
    if not candidates:
        available = sorted(
            {m for task in tasks for m in MODELS_LIBRARY.get(task, {})}
        )
        raise ValueError(
            f"Model {model_name!r} not found"
            + (f" for task {task_name!r}" if task_name else "")
            + (f" in library {library_name!r}" if library_name else "")
            + f". Available models: {available}"
        )
    for cls in candidates:
        if cls.library_name() == "Torch":
            return cls
    return candidates[0]


def find_available_models(task_name: str) -> List[type]:
    return [
        cls
        for libs in MODELS_LIBRARY.get(task_name, {}).values()
        for cls in libs.values()
    ]


def get_models_dataframe():
    """Tidy catalogue of every registered model, one row a (task, model,
    library) with its capability flags."""
    import pandas as pd

    def _cap(cls, name):
        try:
            return bool(getattr(cls, name)())
        except Exception:
            return None

    rows = []
    for task, models in MODELS_LIBRARY.items():
        for model, libs in models.items():
            for lib, cls in libs.items():
                rows.append(
                    {
                        "task_name": task,
                        "model_name": model,
                        "library_name": lib,
                        **{name: _cap(cls, name) for name in (
                            "requires_node_types", "requires_edge_types",
                            "requires_edge_weights", "can_use_node_types",
                            "can_use_edge_types", "can_use_edge_weights",
                            "is_stochastic")},
                    }
                )
    return pd.DataFrame(rows)


def get_available_models_for_node_embedding():
    return find_available_models("Node Embedding")


def get_available_models_for_edge_prediction():
    return find_available_models("Edge Prediction")


def get_available_models_for_edge_label_prediction():
    return find_available_models("Edge Label Prediction")


def get_available_models_for_node_label_prediction():
    return find_available_models("Node Label Prediction")
