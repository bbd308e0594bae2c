"""Model keyword coercion — counterpart of
`embiggen_tpu/utils/normalize_kwargs.py`: `normalize_kwargs` coerces each
keyword named in `NORMALIZATION_SCHEMA` to its type (int, float or bool;
"true", "1" and "yes" are true), and `normalize_model_list_parameter`
expands a scalar into one value a layer.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Union

# kwarg name -> the types it may have; the first is what others coerce to.
NORMALIZATION_SCHEMA: Dict[str, tuple] = {
    "embedding_size": (int,),
    "epochs": (int,),
    "number_of_epochs": (int,),
    "batch_size": (int,),
    "walk_length": (int,),
    "iterations": (int,),
    "window_size": (int,),
    "number_of_negative_samples": (int,),
    "max_neighbours": (int, type(None)),
    "maximum_depth": (int, type(None)),
    "number_of_convolutions": (int,),
    "number_of_hops": (int,),
    "precision": (int,),
    "bits": (int,),
    "power": (int,),
    "random_state": (int, type(None)),
    "learning_rate": (float,),
    "learning_rate_decay": (float,),
    "return_weight": (float,),
    "explore_weight": (float,),
    "relu_bias": (float,),
    "alpha": (float,),
    "x_max": (float,),
    "dropout_rate": (float,),
    "negative_samples_rate": (float,),
    "training_unbalance_rate": (float,),
    "use_scale_free_distribution": (bool,),
    "avoid_false_negatives": (bool,),
    "enable_cache": (bool,),
    "normalize": (bool,),
    "verbose": (bool,),
}

_COERCIBLE = {int: (float, str), float: (int, str), bool: (int, str)}


def normalize_kwargs(kwargs: Dict[str, Any]) -> Dict[str, Any]:
    """Coerce kwarg values to the schema types, raising on impossible
    conversions."""
    out = {}
    for name, value in kwargs.items():
        expected = NORMALIZATION_SCHEMA.get(name)
        if expected is None or value is None or isinstance(value, expected):
            out[name] = value
            continue
        target = expected[0]
        if isinstance(value, _COERCIBLE.get(target, ())):
            try:
                if target is bool and isinstance(value, str):
                    out[name] = value.lower() in ("true", "1", "yes")
                else:
                    out[name] = target(value)
                continue
            except (TypeError, ValueError):
                pass
        raise ValueError(
            f"Cannot coerce kwarg {name}={value!r} "
            f"({type(value).__name__}) to {target.__name__}."
        )
    return out


def normalize_model_list_parameter(
    value: Union[int, float, List], number_of_layers: int, object_type=int
) -> List:
    """`value` as a list of `number_of_layers` values of `object_type`: a
    scalar repeated, a list or tuple of that length converted."""
    if isinstance(value, (list, tuple)):
        value = list(value)
        if len(value) != number_of_layers:
            raise ValueError(
                f"Expected {number_of_layers} per-layer values, got "
                f"{len(value)}."
            )
        return [object_type(v) for v in value]
    return [object_type(value)] * number_of_layers
