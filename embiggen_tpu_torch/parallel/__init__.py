"""Holdout-level parallelism across workers (multi-device training comes
with ROADMAP A13)."""
from .distributed import holdout_belongs_to_this_worker

__all__ = ["holdout_belongs_to_this_worker"]
