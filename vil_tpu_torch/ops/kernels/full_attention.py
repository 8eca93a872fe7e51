"""Dense multi-head attention forward: the Hopper kernel and its plain version.

Counterpart of ``vil_tpu/ops/pallas/full_attention.py::_pallas_forward`` (the
kernel, ``csrc/full_attention_fwd.cu``, which also covers the q-tiled tier
``_pallas_forward_tiled``) and of ``_xla_reference`` (the plain version,
:func:`full_attention_reference`):

    out = softmax(q · kᵀ + bias) · v    per image and head

q, k, v, out are (B, N, C) with the heads packed in C; q arrives scaled by
M^-½; bias is an optional (H, N, N) f32 table.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import build
from .vil_attention import HEAD_DIMS


def full_attention_reference(q, k, v, bias, num_heads: int) -> torch.Tensor:
    """Plain PyTorch version: the same function in f32; the output is
    rounded to q's dtype."""
    B, N, C = q.shape
    H = num_heads
    M = C // H
    q4, k4, v4 = (t.float().reshape(B, N, H, M).transpose(1, 2) for t in (q, k, v))
    scores = q4 @ k4.transpose(-1, -2)  # (B, H, N, N)
    if bias is not None:
        scores = scores + bias.float()[None]
    out = torch.softmax(scores, dim=-1) @ v4
    return out.transpose(1, 2).reshape(B, N, C).to(q.dtype)


def _check(q, k, v, bias, num_heads):
    if q.dim() != 3 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v must share a (B, N, C) shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, N, C = q.shape
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"dtype {q.dtype} is not supported (float32, bfloat16)")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("q, k, v must share one dtype")
    if C % num_heads or C // num_heads not in HEAD_DIMS:
        raise ValueError(f"head dim {C}/{num_heads} is not one of {HEAD_DIMS}")
    tensors = [q, k, v]
    if bias is not None:
        if bias.shape != (num_heads, N, N) or bias.dtype != torch.float32:
            raise ValueError(f"bias must be float32 ({num_heads}, {N}, {N}), "
                             f"got {bias.dtype} {tuple(bias.shape)}")
        tensors.append(bias)
    if any(t.device != q.device for t in tensors):
        raise ValueError("all operands must be on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("all operands must be contiguous")
    return tensors


def full_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       bias: Optional[torch.Tensor], num_heads: int) -> torch.Tensor:
    """Dense attention forward. On a CUDA device this launches the
    hand-written kernel (or raises); on the CPU it runs the plain version."""
    tensors = _check(q, k, v, bias, num_heads)
    if q.device.type == "cpu":
        return full_attention_reference(q, k, v, bias, num_heads)
    if q.device.type != "cuda":
        raise ValueError(f"device {q.device} is not supported")
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            "full_attention_fwd has no backward kernel yet; run under "
            "torch.no_grad() or torch.inference_mode()")
    B, N, C = q.shape
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = build.load().full_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if bias is None else bias.data_ptr(), out.data_ptr(),
            B, N, C, num_heads, int(q.dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream,
        )
    build.check(err, "full_attention_fwd")
    full_attention_fwd.launches += 1
    return out


full_attention_fwd.launches = 0
