"""Tracing and profiling hooks — counterpart of `embiggen_tpu/utils/profiling.py`.

- `trace(log_dir)` — a torch.profiler trace of a block, written to `log_dir`
  as a Chrome trace (`*.pt.trace.json`, which TensorBoard's profiler plugin
  and chrome://tracing read), with the card's kernels when CUDA is
  available. A profiler that fails to start raises.
- `annotate(name)` — a named range (`torch.profiler.record_function`) that
  shows in a trace's host timeline.
- `PhaseTimer` — accumulates named wall-clock phases; `as_dict()` gives the
  evaluation report's `*_time` style columns.
- `device_memory_stats()` — `torch.cuda.memory_stats` of one card.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Iterator, Optional, Union

import torch


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Profile the block and write its trace into `log_dir` (made if
    missing) when the block ends."""
    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
        activities=activities,
        on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir),
    ) as prof:
        yield prof


def annotate(name: str):
    """A named range in a captured trace's host timeline."""
    return torch.profiler.record_function(name)


class PhaseTimer:
    """Accumulates named wall-clock phases.

    >>> t = PhaseTimer()
    >>> with t.phase("fit"): ...
    >>> t.as_dict()  # {"fit_time": ...}
    """

    def __init__(self) -> None:
        self._elapsed: Dict[str, float] = {}

    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._elapsed[name] = self._elapsed.get(name, 0.0) + time.perf_counter() - t0

    def as_dict(self, suffix: str = "_time") -> Dict[str, float]:
        return {f"{k}{suffix}": v for k, v in self._elapsed.items()}


def device_memory_stats(
    device: Optional[Union[str, int, torch.device]] = None,
) -> Optional[Dict[str, int]]:
    """`torch.cuda.memory_stats` of a card (the current one by default), or
    None for a CPU device or where CUDA is not available."""
    if device is not None and torch.device(device).type != "cuda":
        return None
    if not torch.cuda.is_available():
        return None
    return {k: int(v) for k, v in torch.cuda.memory_stats(device).items()}
