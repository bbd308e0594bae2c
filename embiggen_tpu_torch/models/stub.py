"""Stubs for the rows whose backing library is not installed — counterpart
of `embiggen_tpu/models/stub.py`: the 12 GBDT rows (XGBoost, LightGBM,
CatBoost and LLeaves for each of the three classification tasks) and the
"Non Existent Model" node embedding. Each registers under its own library
name, so the catalogue lists every row the reference lists, and raises at
construction the reference's ModuleNotFoundError, which names the missing
package and any other library implementing the same model.
"""
from __future__ import annotations

from typing import Any, Dict

from .abstract import AbstractModel
from .registry import MODELS_LIBRARY, register_model


def _format_list(items) -> str:
    items = list(items)
    if len(items) == 1:
        return items[0]
    return ", ".join(items[:-1]) + " and " + items[-1]


def make_stub(
    model_name: str,
    task_name: str,
    library_name: str,
    requirement: str,
) -> type:
    """Build and register a stub class for (model, task, library).

    The class is a real ``AbstractModel`` subclass so the catalog helpers
    (``get_models_dataframe``, ``find_available_models``) see it, but its
    ``__init__`` raises ``ModuleNotFoundError`` pointing at the missing
    dependency and at alternative implementations of the same model.
    """
    _model, _task, _library, _req = model_name, task_name, library_name, requirement

    class StubModel(AbstractModel):
        def __init__(self, *args, **kwargs):
            alternatives = [
                lib
                for lib, cls in MODELS_LIBRARY.get(_task, {}).get(_model, {}).items()
                if lib != _library and not getattr(cls, "is_stub", lambda: False)()
            ]
            if alternatives:
                extra = (
                    "Do be advised that, while this model is not currently "
                    "available on your system in this specific library "
                    "implementation, the same model is implemented in "
                    f"{_format_list(alternatives)}. Different implementations "
                    "may have very different parametrizations and performance."
                )
            else:
                extra = (
                    "At this time, there is no other implementation of the "
                    f"{_model} model available on your system."
                )
            raise ModuleNotFoundError(
                f"The model {_model} for task {_task} from library "
                f"{_library} requires the Python package {_req!r}, which is "
                f"not installed in this environment. {extra}"
            )

        @classmethod
        def is_stub(cls) -> bool:
            return True

        @classmethod
        def task_name(cls) -> str:
            return _task

        @classmethod
        def model_name(cls) -> str:
            return _model

        @classmethod
        def library_name(cls) -> str:
            return _library

        @classmethod
        def is_stochastic(cls) -> bool:
            return True

        @classmethod
        def smoke_test_parameters(cls) -> Dict[str, Any]:
            return {}

    StubModel.__name__ = model_name.replace(" ", "").replace("-", "") + "Stub"
    StubModel.__qualname__ = StubModel.__name__
    return register_model(StubModel)


_CLASSIFICATION_TASKS = (
    "Edge Prediction",
    "Edge Label Prediction",
    "Node Label Prediction",
)

# The GBDT rows of each classification task; none of these libraries is a
# dependency of the port.
for _task in _CLASSIFICATION_TASKS:
    make_stub("XGBoost", _task, "XGBoost", "xgboost")
    make_stub("LightGBM", _task, "LightGBM", "lightgbm")
    make_stub("CatBoost", _task, "CatBoost", "catboost")
    make_stub("LLeaves", _task, "LLeaves", "lleaves")

# A deliberately unimportable model, which shows the stub behaviour.
NonExistentModel = make_stub(
    "Non Existent Model",
    "Node Embedding",
    "Non Existent Library",
    "non_existent_package",
)
