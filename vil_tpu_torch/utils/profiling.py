"""Tracing and memory read-outs: counterpart of ``vil_tpu/utils/profiling.py``.

The reference logs ``torch.cuda.max_memory_allocated`` per log line
(engine.py:164,193); the JAX package reads the device's memory statistics
and traces with ``jax.profiler``. Here:

* ``trace(log_dir)`` — a ``torch.profiler`` trace of the CPU and the card,
  written as a Chrome trace (``trace.json``) under ``log_dir``;
* ``peak_memory_mb()`` — the card's peak allocated memory, 0 without one.

The JAX package's compilation cache (``vil_tpu/utils/compilation_cache.py``)
has no counterpart: the port dispatches eagerly and its kernels are built
once per build directory.
"""
from __future__ import annotations

import contextlib
import os

import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile a region: ``with trace('/tmp/prof'): step(...)``."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def peak_memory_mb(device=None) -> float:
    """Peak memory allocated on the card since the start or the last
    ``torch.cuda.reset_peak_memory_stats``, in MiB; 0 without a card."""
    if not torch.cuda.is_available():
        return 0.0
    return torch.cuda.max_memory_allocated(device) / 2**20
