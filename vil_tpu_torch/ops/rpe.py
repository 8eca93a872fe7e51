"""Relative-position-bias index tables (Swin-style).

A copy of ``vil_tpu/ops/rpe.py`` (pure numpy, so the port runs on a host
without JAX); ``tests/test_torch_rpe.py`` checks that the two agree. Each
table maps a (query, key) position pair to the row of a learned bias table:

* ``full_rpe_index`` — dense attention over a wx×wy grid: every query/key
  pixel pair indexed into a (2wx-1)(2wy-1) table.
* ``sliding_chunk_rpe_index`` — sliding-chunk attention: each query pixel in
  the center W×W chunk vs every key slot in its 3×3 chunk neighbourhood,
  indexed into a (4w-1)² table.
* ``sliding_chunk_rpe_index_mode`` / ``all_mode_rpe_indices`` — the
  [self ‖ sampled] columns of random-shift training's modes 1..8.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np


@lru_cache(maxsize=None)
def full_rpe_index(wx: int, wy: int) -> np.ndarray:
    """Pairwise relative-position index over a wx×wy grid.

    Returns int32 (wx*wy, wx*wy) with values in [0, (2wx-1)(2wy-1)).
    """
    r = np.arange(wx * wy)
    x, y = r // wy, r % wy
    dx = x[:, None] - x[None, :] + (wx - 1)  # [0, 2wx-2]
    dy = y[:, None] - y[None, :] + (wy - 1)
    return (dx * (2 * wy - 1) + dy).astype(np.int32)


@lru_cache(maxsize=None)
def sliding_chunk_rpe_index(w: int) -> np.ndarray:
    """Relative-position index for the 3×3 chunk neighbourhood.

    Query pixels live in the center chunk; keys in all 9 chunks ordered
    (-1,-1),(-1,0),(-1,1),(0,-1),(0,0),(0,1),(1,-1),(1,0),(1,1). Relative
    offsets span [-(2w-1), 2w-1] per axis, so the bias table has (4w-1)² rows.

    Returns int32 (w*w, 9*w*w) with values in [0, (4w-1)²).
    """
    w2 = w * w
    l = np.arange(w2)
    qx, qy = l // w, l % w  # query pixel in center chunk coords
    j = np.arange(9 * w2)
    kx = ((j // w2) // 3 - 1) * w + (j % w2) // w  # key pixel, chunk-offset coords
    ky = ((j // w2) % 3 - 1) * w + (j % w2) % w
    dx = qx[:, None] - kx[None, :] + (2 * w - 1)  # [0, 4w-2]
    dy = qy[:, None] - ky[None, :] + (2 * w - 1)
    return (dx * (4 * w - 1) + dy).astype(np.int32)


def sliding_chunk_rpe_index_mode(w: int, mode: int) -> np.ndarray:
    """Per-mode slice of the sliding-chunk RPE index.

    mode 0: full (w², 9w²); mode -1: self only (w², w²);
    mode>0: [self ‖ sampled block] (w², 2w²).
    """
    w2 = w * w
    idx = sliding_chunk_rpe_index(w)
    if mode == 0:
        return idx
    if mode == -1:
        return np.ascontiguousarray(idx[:, 4 * w2:5 * w2])
    chunk_id = mode if mode > 4 else mode - 1
    return np.concatenate(
        [idx[:, 4 * w2:5 * w2], idx[:, chunk_id * w2:(chunk_id + 1) * w2]], axis=-1
    )


def all_mode_rpe_indices(w: int) -> np.ndarray:
    """Stacked per-mode RPE indices for modes 1..8: (8, w², 2w²)."""
    return np.stack([sliding_chunk_rpe_index_mode(w, m) for m in range(1, 9)])
