"""Host-side helpers; exports what the JAX package's `utils` exports."""
from .cache import Cache, cache_result
from .checkpoint import load_pytree, save_pytree
from .persistence import dump_model, load_model

__all__ = [
    "Cache", "cache_result", "dump_model", "load_model",
    "save_pytree", "load_pytree",
]
