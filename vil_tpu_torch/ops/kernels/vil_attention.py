"""Sliding-chunk attention forward: the Hopper kernel and its plain version.

Counterpart of ``vil_tpu/ops/pallas/vil_kernel.py::_pallas_forward_mh`` (the
kernel, ``csrc/vil_attention_fwd.cu``) and of ``_xla_reference_mh`` (the plain
version, :func:`vil_attention_reference`). Per query chunk and head:

    S   = q · [K_glo ‖ K of the 3×3 cyclic chunk neighbourhood]ᵀ + bias + mask
    out = softmax(S) · [V_glo ‖ V_nbh]

Layouts are the JAX package's: q, k, v, out (B, mx, my, W², C) with the heads
packed in C; k_glo, v_glo (B, Nglo, C); bias (H, W², Nglo+9W²) f32 or None;
mask (mx, my, Wq, Nglo+9W²) f32 with Wq ∈ {1, W²}. Score columns are in front
order [glo ‖ neighbour 0 … 8]. q arrives scaled by M^-½.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .. import sliding_chunk as sc
from . import build

# finite mask fill: exp(fill - max) underflows to 0, and a row whose keys are
# all masked stays finite (exp(-inf - -inf) would be NaN)
NEG_INF = float(np.finfo(np.float32).min) / 2

HEAD_DIMS = (8, 16, 32, 64, 128)  # head dims the kernel is compiled for


def mask_to_additive(mask_bool: np.ndarray, mx: int, my: int, w2: int,
                     nglo: int) -> np.ndarray:
    """Boolean invalid-mask table → additive f32 (mx, my, Wq, Nglo+9W²).

    Global-token columns are never masked. Accepts the (mx·my, 9W²)
    blockwise tables or the (mx·my, W², 9W²) exact table.
    """
    if mask_bool.ndim == 2:
        m = mask_bool.reshape(mx, my, 1, -1)
    else:
        m = mask_bool.reshape(mx, my, w2, -1)
    add = np.where(m, NEG_INF, 0.0).astype(np.float32)
    if nglo > 0:
        glo = np.zeros(add.shape[:3] + (nglo,), dtype=np.float32)
        add = np.concatenate([glo, add], axis=-1)
    return add


def vil_attention_reference(q, k, v, k_glo, v_glo, bias, mask_add,
                            num_heads: int) -> torch.Tensor:
    """Plain PyTorch version: the same function in f32, through the
    neighbourhood-concat matmuls of ``ops.sliding_chunk``; the output is
    rounded to q's dtype."""
    B, mx, my, w2, C = q.shape
    H = num_heads
    M = C // H
    nglo = 0 if k_glo is None else k_glo.shape[1]

    def heads(t):  # (B, mx, my, W², C) → (B·H, mx, my, W², M) f32
        return (t.float().reshape(B, mx, my, w2, H, M)
                .permute(0, 4, 1, 2, 3, 5).reshape(B * H, mx, my, w2, M))

    def glo_heads(t):  # (B, Nglo, C) → (B·H, Nglo, M) f32
        return t.float().reshape(B, nglo, H, M).transpose(1, 2).reshape(B * H, nglo, M)

    qh, kh, vh = heads(q), heads(k), heads(v)
    scores = sc.sliding_chunk_qk(qh, kh, 0)  # (B·H, mx, my, W², 9W²)
    if nglo > 0:
        s_glo = torch.einsum("bxylm,btm->bxylt", qh, glo_heads(k_glo))
        scores = torch.cat([s_glo, scores], dim=-1)
    if bias is not None:  # row b·H + h takes bias[h]
        scores = scores + bias.float().repeat(B, 1, 1)[:, None, None]
    scores = scores + mask_add.float()[None]
    probs = torch.softmax(scores, dim=-1)
    out = sc.sliding_chunk_av(probs[..., nglo:], vh, 0)
    if nglo > 0:
        out = out + torch.einsum("bxylt,btm->bxylm", probs[..., :nglo],
                                 glo_heads(v_glo))
    out = out.reshape(B, H, mx, my, w2, M).permute(0, 2, 3, 4, 1, 5)
    return out.reshape(B, mx, my, w2, C).to(q.dtype)


def _check(q, k, v, k_glo, v_glo, bias, mask_add, num_heads):
    if q.dim() != 5 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v must share a 5-D shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, mx, my, w2, C = q.shape
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"dtype {q.dtype} is not supported (float32, bfloat16)")
    if C % num_heads or C // num_heads not in HEAD_DIMS:
        raise ValueError(f"head dim {C}/{num_heads} is not one of {HEAD_DIMS}")
    if (k_glo is None) != (v_glo is None):
        raise ValueError("k_glo and v_glo must both be given or both be None")
    nglo = 0 if k_glo is None else k_glo.shape[1]
    cols = nglo + 9 * w2
    tensors = [q, k, v]
    if k_glo is not None:
        if k_glo.shape != (B, nglo, C) or v_glo.shape != (B, nglo, C) or nglo == 0:
            raise ValueError(f"k_glo, v_glo must be ({B}, Nglo>0, {C}), got "
                             f"{tuple(k_glo.shape)}, {tuple(v_glo.shape)}")
        tensors += [k_glo, v_glo]
    if any(t.dtype != q.dtype for t in tensors):
        raise TypeError("q, k, v, k_glo, v_glo must share one dtype")
    if bias is not None:
        if bias.shape != (num_heads, w2, cols) or bias.dtype != torch.float32:
            raise ValueError(f"bias must be float32 ({num_heads}, {w2}, {cols}), "
                             f"got {bias.dtype} {tuple(bias.shape)}")
        tensors.append(bias)
    if (mask_add.dim() != 4 or mask_add.shape[:2] != (mx, my)
            or mask_add.shape[2] not in (1, w2) or mask_add.shape[3] != cols
            or mask_add.dtype != torch.float32):
        raise ValueError(f"mask must be float32 ({mx}, {my}, 1|{w2}, {cols}), "
                         f"got {mask_add.dtype} {tuple(mask_add.shape)}")
    tensors.append(mask_add)
    if any(t.device != q.device for t in tensors):
        raise ValueError("all operands must be on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("all operands must be contiguous")
    return tensors


def vil_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      k_glo: Optional[torch.Tensor], v_glo: Optional[torch.Tensor],
                      bias: Optional[torch.Tensor], mask_add: torch.Tensor,
                      num_heads: int) -> torch.Tensor:
    """Sliding-chunk attention forward. On a CUDA device this launches the
    hand-written kernel (or raises); on the CPU it runs the plain version."""
    tensors = _check(q, k, v, k_glo, v_glo, bias, mask_add, num_heads)
    if q.device.type == "cpu":
        return vil_attention_reference(q, k, v, k_glo, v_glo, bias, mask_add,
                                       num_heads)
    if q.device.type != "cuda":
        raise ValueError(f"device {q.device} is not supported")
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            "vil_attention_fwd has no backward kernel yet; run under "
            "torch.no_grad() or torch.inference_mode()")
    B, mx, my, w2, C = q.shape
    nglo = 0 if k_glo is None else k_glo.shape[1]
    out = torch.empty_like(q)
    ptr = lambda t: None if t is None else t.data_ptr()
    with torch.cuda.device(q.device):
        err = build.load().vil_attention_fwd(
            ptr(q), ptr(k), ptr(v), ptr(k_glo), ptr(v_glo), ptr(bias),
            ptr(mask_add), ptr(out), B, mx, my, w2, C, num_heads, nglo,
            mask_add.shape[2], int(q.dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream,
        )
    build.check(err, "vil_attention_fwd")
    vil_attention_fwd.launches += 1
    return out


vil_attention_fwd.launches = 0
