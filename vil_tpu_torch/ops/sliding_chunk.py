"""2-D sliding-chunk attention primitives in plain PyTorch.

Counterpart of ``vil_tpu/ops/sliding_chunk.py``. Neighbour modes:

  0    : all 8 neighbour chunks + self -> kv span 9W²
  -1   : self chunk only               -> kv span W²
  1..8 : self + one sampled neighbour  -> kv span 2W² (random-shift training)

The mode is a host ``int``: PyTorch runs eagerly, so each call rolls by its
own static shift (the JAX package's ``lax.switch`` over traced modes has no
counterpart here).

Layout is (B, mx, my, W², M): an mx × my grid of W×W chunks, head dim last.
The neighbour chunks are rolled onto the self position with ``torch.roll``
and concatenated into one (…, K·W², M) operand, so QKᵀ and P·V are each one
batched matmul. These functions are the plain tier the hand-written kernels
in ``ops/kernels/vil_attention.py`` and ``ops/kernels/vil_mode_attention.py``
are checked against.
"""
from __future__ import annotations

import numpy as np
import torch

from .masks import NEIGHBOR_OFFSETS

# Roll shift that aligns neighbour chunk (dx, dy) onto the self position:
# torch.roll by (-dx, -dy) over the (mx, my) axes.
_ROLL_SHIFTS = [(-dx, -dy) for dx, dy in NEIGHBOR_OFFSETS]

# mode (1..8) -> roll shift of the sampled neighbour, the reference's
# mode_dict (slidingchunk_2d.py:15-24); entry 0 is unused. The sampled chunk
# of query chunk (i, j) is ((i - sx) mod mx, (j - sy) mod my).
MODE_ROLL_SHIFTS = np.array(
    [(0, 0), (1, 1), (1, 0), (1, -1), (0, 1), (0, -1), (-1, 1), (-1, 0), (-1, -1)],
    dtype=np.int32,
)


def check_mode(mode: int) -> int:
    """``mode`` as an int in {-1, 0, 1..8}; anything else raises ValueError."""
    if isinstance(mode, bool) or not isinstance(mode, (int, np.integer)) or not -1 <= mode <= 8:
        raise ValueError(f"sliding-chunk mode must be an int in -1..8, got {mode!r}")
    return int(mode)


def sampled_roll(t: torch.Tensor, mode: int) -> torch.Tensor:
    """Roll that aligns the sampled neighbour chunk of ``mode`` (1..8) onto
    the self chunk, over the chunk-grid axes (1, 2) of (B, mx, my, W², M)."""
    if check_mode(mode) < 1:
        raise ValueError(f"sampled_roll takes a mode in 1..8, got {mode}")
    sx, sy = (int(s) for s in MODE_ROLL_SHIFTS[mode])
    return torch.roll(t, shifts=(sx, sy), dims=(1, 2))


def neighborhood(t: torch.Tensor, mode: int) -> torch.Tensor:
    """Gather the kv neighbourhood along the chunk axis.

    t: (B, mx, my, W², M) → (B, mx, my, K·W², M) with K = 9 (mode 0),
    1 (mode -1) or 2 (modes 1..8: [self ‖ sampled]).
    """
    mode = check_mode(mode)
    if mode == 0:
        rolled = [torch.roll(t, shifts=s, dims=(1, 2)) for s in _ROLL_SHIFTS]
        return torch.cat(rolled, dim=3)
    if mode == -1:
        return t
    return torch.cat([t, sampled_roll(t, mode)], dim=3)


def sliding_chunk_qk(q: torch.Tensor, k: torch.Tensor, mode: int = 0) -> torch.Tensor:
    """Windowed QKᵀ: (B, mx, my, W², M) ² → (B, mx, my, W², K·W²)."""
    return torch.matmul(q, neighborhood(k, mode).transpose(-1, -2))


def sliding_chunk_av(attn: torch.Tensor, v: torch.Tensor, mode: int = 0) -> torch.Tensor:
    """Attention · V: (B, mx, my, W², K·W²) × (B, mx, my, W², M) → (B, mx, my, W², M)."""
    return torch.matmul(attn, neighborhood(v, mode))


def chunk_grid(nx: int, ny: int, w: int) -> tuple[int, int, int, int]:
    """(padx, pady, mx, my) so that the padded grid is mx·w × my·w."""
    padx = (w - nx % w) % w
    pady = (w - ny % w) % w
    return padx, pady, (nx + padx) // w, (ny + pady) // w


def chunkify(t: torch.Tensor, nx: int, ny: int, w: int) -> torch.Tensor:
    """(B, nx·ny, M) token grid → (B, mx, my, W², M) zero-padded chunks."""
    b, n, m = t.shape
    if n != nx * ny:
        raise ValueError(f"token count {n} != {nx}x{ny}")
    padx, pady, mx, my = chunk_grid(nx, ny, w)
    t = t.reshape(b, nx, ny, m)
    if padx or pady:
        t = torch.nn.functional.pad(t, (0, 0, 0, pady, 0, padx))
    t = t.reshape(b, mx, w, my, w, m)
    return t.permute(0, 1, 3, 2, 4, 5).reshape(b, mx, my, w * w, m)


def unchunkify(t: torch.Tensor, nx: int, ny: int, w: int) -> torch.Tensor:
    """(B, mx, my, W², M) chunks → (B, nx·ny, M), cropping the pad."""
    b, mx, my, w2, m = t.shape
    t = t.reshape(b, mx, my, w, w, m).permute(0, 1, 3, 2, 4, 5)
    t = t.reshape(b, mx * w, my * w, m)[:, :nx, :ny]
    return t.reshape(b, nx * ny, m)
