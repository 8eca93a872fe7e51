"""Static validity-mask tables for 2-D sliding-chunk attention.

The sliding-chunk attention treats the (padded) token grid as an mx × my grid
of W×W chunks; each query chunk attends to its 3×3 chunk neighborhood laid out
cyclically. These tables mark which of the 9·W² key slots are INVALID for a
given query and must be filled with -inf before the softmax.

A copy of ``vil_tpu/ops/masks.py`` (pure numpy, so the port runs on a host
without JAX); ``tests/test_torch_ops.py`` checks that the tables are bitwise
equal.

Three semantics, selected by ``exact`` (reference
src/models/layers/slidingchunk_2d.py:249-357 and
config key MODEL.VIT.MSVIT.SW_EXACT):

  *  1 — exact conv-like sliding window (±w around each query pixel)
  *  0 — blockwise sliding chunk, zero padding (out-of-image neighbors invalid)
  * -1 — blockwise sliding chunk, cyclic padding (only padded pixels invalid)

Everything here is pure numpy executed at trace time: shapes (mx, my, padx,
pady, W) are config-time constants on TPU, so the masks become XLA constants.
Vectorized re-derivation of the reference's per-element predicates — no code
is shared with the reference.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np

# Neighbor-block visit order shared by every sliding-chunk table in this
# framework, matching the reference concat order (slidingchunk_2d.py:37-66):
# (-1,-1), (-1,0), (-1,+1), (0,-1), (0,0), (0,+1), (+1,-1), (+1,0), (+1,+1)
NEIGHBOR_OFFSETS = [(dx, dy) for dx in (-1, 0, 1) for dy in (-1, 0, 1)]
# Index of the self block (0,0) within NEIGHBOR_OFFSETS.
SELF_BLOCK = 4


def _grid_coords(mx: int, my: int, w: int):
    """Per-(chunk, key-slot) coordinates used by all mask variants.

    Returns arrays broadcastable to (mx*my, 9*w*w):
      qcr, qcc: query chunk row/col
      nbr, nbc: neighbor offset (-1..1) of the key slot's chunk
      kir, kic: key pixel row/col within its chunk (0..w-1)
    """
    w2 = w * w
    i = np.arange(mx * my)[:, None]  # (mx*my, 1)
    j = np.arange(9 * w2)[None, :]  # (1, 9w2)
    qcr = i // my
    qcc = i % my
    nbr = (j // w2) // 3 - 1
    nbc = (j // w2) % 3 - 1
    kir = (j % w2) // w
    kic = (j % w2) % w
    return qcr, qcc, nbr, nbc, kir, kic


@lru_cache(maxsize=None)
def invalid_mask_cyclic(mx: int, my: int, padx: int, pady: int, w: int) -> np.ndarray:
    """Cyclic-padding mask, shape (mx*my, 9*w*w), True = invalid.

    Only keys that land on padded pixels (which, with cyclic roll, always live
    in the last chunk row/col) are invalid (slidingchunk_2d.py:250-267).
    """
    qcr, qcc, nbr, nbc, kir, kic = _grid_coords(mx, my, w)
    # neighbor chunk is the last row (cyclically) and the key's absolute row
    # inside that last chunk falls into x-padding; same for columns
    row_bad = (qcr + nbr + 1 == mx) & ((mx - 1) * w + kir >= mx * w - padx)
    col_bad = (qcc + nbc + 1 == my) & ((my - 1) * w + kic >= my * w - pady)
    return row_bad | col_bad


@lru_cache(maxsize=None)
def invalid_mask_zero(mx: int, my: int, padx: int, pady: int, w: int) -> np.ndarray:
    """Zero-padding (no padding) mask, shape (mx*my, 9*w*w), True = invalid.

    Keys whose chunk falls outside the grid, or whose absolute pixel falls
    into the padding margin, are invalid (slidingchunk_2d.py:271-290).
    """
    qcr, qcc, nbr, nbc, kir, kic = _grid_coords(mx, my, w)
    kr_chunk = qcr + nbr  # absolute chunk row of the key (no wrap)
    kc_chunk = qcc + nbc
    row_bad = (kr_chunk < 0) | (kr_chunk >= mx) | (kr_chunk * w + kir >= mx * w - padx)
    col_bad = (kc_chunk < 0) | (kc_chunk >= my) | (kc_chunk * w + kic >= my * w - pady)
    return row_bad | col_bad


@lru_cache(maxsize=None)
def invalid_mask_exact(mx: int, my: int, padx: int, pady: int, w: int) -> np.ndarray:
    """Exact sliding-window mask, shape (mx*my, w*w, 9*w*w), True = invalid.

    Each query pixel sees exactly the (2w+1)² window around itself, clipped to
    the unpadded image (slidingchunk_2d.py:294-318).
    """
    w2 = w * w
    i = np.arange(mx * my)[:, None, None]  # query chunk
    l = np.arange(w2)[None, :, None]  # query pixel within chunk
    j = np.arange(9 * w2)[None, None, :]  # key slot
    qcr, qcc = i // my, i % my
    qr = qcr * w + l // w  # absolute query pixel row/col
    qc = qcc * w + l % w
    kr = (qcr + (j // w2) // 3 - 1) * w + (j % w2) // w  # absolute key pixel
    kc = (qcc + (j // w2) % 3 - 1) * w + (j % w2) % w
    nx_max = mx * w - 1 - padx
    ny_max = my * w - 1 - pady
    row_bad = (kr < np.maximum(0, qr - w)) | (kr > np.minimum(nx_max, qr + w))
    col_bad = (kc < np.maximum(0, qc - w)) | (kc > np.minimum(ny_max, qc + w))
    return row_bad | col_bad


def invalid_mask(
    mx: int, my: int, padx: int, pady: int, w: int, exact: int, mode: int = 0
) -> np.ndarray:
    """Mask table for the given semantics and neighbor-sampling mode.

    Mirrors reference ``mask_invalid_locations`` table selection
    (slidingchunk_2d.py:321-354). Returns True=invalid with shape:
      exact==1, mode==0: (mx*my, w*w, 9*w*w)
      otherwise mode==0: (mx*my, 9*w*w)
      mode==-1:          (mx*my, w*w)        [self block only]
      mode>0:            (mx*my, 2*w*w)      [self block ‖ sampled block]
    """
    w2 = w * w
    if exact == 1 and mode == 0:
        return invalid_mask_exact(mx, my, padx, pady, w)
    if exact == 0:
        mask = invalid_mask_zero(mx, my, padx, pady, w)
    elif exact == -1:
        mask = invalid_mask_cyclic(mx, my, padx, pady, w)
    else:
        raise ValueError("sliding-chunk exact must be in {1, 0, -1} "
                         "(exact=1 only supports mode=0)")
    if mode == 0:
        return mask
    if mode == -1:
        return mask[:, SELF_BLOCK * w2:(SELF_BLOCK + 1) * w2]
    # mode > 0: self block followed by the sampled neighbor block. The
    # reference maps mode->chunk_id skipping the self block
    # (slidingchunk_2d.py:348, longformer2d.py:169).
    chunk_id = mode if mode > 4 else mode - 1
    return np.concatenate(
        [
            mask[:, SELF_BLOCK * w2:(SELF_BLOCK + 1) * w2],
            mask[:, chunk_id * w2:(chunk_id + 1) * w2],
        ],
        axis=-1,
    )


def all_mode_masks(mx, my, padx, pady, w, exact) -> np.ndarray:
    """Stacked masks for modes 1..8, shape (8, mx*my, 2*w*w).

    Used by the random-shift training path: the mode is sampled on-device per
    step, and the per-mode table is selected with a dynamic index — one XLA
    compilation covers all 8 modes.
    """
    return np.stack(
        [invalid_mask(mx, my, padx, pady, w, exact, mode) for mode in range(1, 9)]
    )


def chunk_valid(nx: int, ny: int, w: int) -> np.ndarray:
    """(mx, my, w²) bool: True where the chunk position maps to a real token
    of the nx×ny grid (False on zero-pad positions). Chunk-order counterpart
    of the row-major token grid — used by the persistent-chunk layout to mask
    pad keys in the global-token attention branch."""
    padx = (w - nx % w) % w
    pady = (w - ny % w) % w
    mx, my = (nx + padx) // w, (ny + pady) // w
    valid = np.zeros((mx * w, my * w), dtype=bool)
    valid[:nx, :ny] = True
    return (
        valid.reshape(mx, w, my, w).transpose(0, 2, 1, 3).reshape(mx, my, w * w)
    )
