"""Dense multi-head attention: the Hopper kernels and their plain versions.

Counterpart of ``vil_tpu/ops/pallas/full_attention.py``: ``_pallas_forward``
(the forward kernel, ``csrc/full_attention_fwd.cu``, which also covers the
q-tiled tier ``_pallas_forward_tiled``), ``_pallas_backward`` and its q-tiled
tier ``_pallas_backward_tiled`` (the backward kernel,
``csrc/full_attention_bwd.cu``), ``make_fused_full_attention``
(:class:`FullAttentionFunction`), ``make_fused_full_attention_rpe``
(:class:`FullAttentionRPEFunction`: the relative-position bias assembled
inside the Function and rebuilt in the backward) and ``_xla_reference`` (the
plain version, :func:`full_attention_reference`):

    out = softmax(q · kᵀ + bias) · v,    lse = log Σ exp(q · kᵀ + bias)

per image and head. q, k, v, out are (B, N, C) with the heads packed in C;
q arrives scaled by M^-½ (dq is with respect to that scaled q); bias is an
optional (H, N, N) f32 table; lse is (B, H, N) f32.

The kernels are chosen by the operand dtype: bf16 runs on the tensor cores
(``wgmma``, tiles by ``cp.async``; P and dS rounded to bf16 before the
products, as the TPU kernels round them), f32 on the CUDA cores in full f32
arithmetic, which the f32 parity checks need.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import build
from .vil_attention import HEAD_DIMS, SMS, _check_aligned


def full_attention_reference(q, k, v, bias, num_heads: int, with_lse: bool = False):
    """Plain PyTorch version: the same function in f32; the output is
    rounded to q's dtype. With ``with_lse`` it returns (out, lse)."""
    B, N, C = q.shape
    H = num_heads
    M = C // H
    q4, k4, v4 = (t.float().reshape(B, N, H, M).transpose(1, 2) for t in (q, k, v))
    scores = q4 @ k4.transpose(-1, -2)  # (B, H, N, N)
    if bias is not None:
        scores = scores + bias.float()[None]
    out = torch.softmax(scores, dim=-1) @ v4
    out = out.transpose(1, 2).reshape(B, N, C).to(q.dtype)
    return (out, torch.logsumexp(scores, dim=-1)) if with_lse else out


def full_attention_bwd_reference(q, k, v, bias, g, num_heads: int):
    """Plain PyTorch version of the backward: autograd through
    :func:`full_attention_reference` in f32. Returns (dq, dk, dv, dbias), each
    in its operand's dtype; dbias is None without a bias."""
    operands = (q, k, v, bias)
    leaves = [None if t is None else t.detach().float().requires_grad_() for t in operands]
    with torch.enable_grad():
        out = full_attention_reference(*leaves, num_heads)
        present = [t for t in leaves if t is not None]
        grads = iter(torch.autograd.grad(out, present, g.float()))
    return tuple(None if t is None else next(grads).to(t.dtype) for t in operands)


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


def _ptr(t):
    return None if t is None else t.data_ptr()


def image_group(B: int, N: int, num_heads: int) -> int:
    """Images a block of the biased backward's pass 1 walks (the kernel's
    ``per_group``): the largest divisor of B whose grid (64-row q tiles × H ×
    B / per_group) still holds two blocks an SM, or 1 where one image a
    block holds fewer. 8 at N 4097, H 6, batch 8 (one (H, N, N) partial,
    390 blocks); 4 at N 197, H 6, batch 64 (16 partials)."""
    blocks = -(-N // 64) * num_heads  # of one image
    return max((d for d in range(1, B + 1) if B % d == 0 and blocks * (B // d) >= 2 * SMS),
               default=1)


def full_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       bias: Optional[torch.Tensor], num_heads: int,
                       with_lse: bool = False):
    """Dense attention forward. On a CUDA device this launches the
    hand-written kernel (or raises); on the CPU it runs the plain version.
    With ``with_lse`` it returns (out, lse). It records no gradient: the
    differentiable form is :func:`full_attention`."""
    _check(q, k, v, bias, num_heads)
    if q.device.type == "cpu":
        with torch.no_grad():
            return full_attention_reference(q, k, v, bias, num_heads, with_lse)
    if q.device.type != "cuda":
        raise ValueError(f"device {q.device} is not supported")
    B, N, C = q.shape
    if q.dtype == torch.bfloat16:
        _check_aligned(q, k, v)
    out = torch.empty_like(q)
    lse = (torch.empty(B, num_heads, N, device=q.device, dtype=torch.float32)
           if with_lse else None)
    with torch.cuda.device(q.device):
        err = build.load().full_attention_fwd(
            _ptr(q), _ptr(k), _ptr(v), _ptr(bias), _ptr(out), _ptr(lse),
            B, N, C, num_heads, int(q.dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream,
        )
    build.check(err, "full_attention_fwd")
    full_attention_fwd.launches += 1
    return (out, lse) if with_lse else out


full_attention_fwd.launches = 0


def full_attention_bwd(q, k, v, bias, g, out, lse, num_heads: int):
    """Dense attention backward from the forward's ``out`` and ``lse``:
    returns (dq, dk, dv, dbias), dbias None without a bias. On a CUDA device
    this launches the hand-written kernels (or raises); the bf16 kernels take
    δ = rowsum(g ∘ out). On the CPU it runs the plain version, which
    recomputes the softmax and ignores ``out`` and ``lse``. The kernel sums
    dbias over each group of :func:`image_group` images, with no zero fill;
    the wrapper sums the groups' partials (one group: taken as it is)."""
    _check(q, k, v, bias, num_heads)
    B, N, C = q.shape
    H = num_heads
    for name, t in (("g", g), ("out", out)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name} must match q: {t.dtype} {tuple(t.shape)} on {t.device}")
    if lse.shape != (B, H, N) or lse.dtype != torch.float32 or lse.device != q.device:
        raise ValueError(f"lse must be float32 {(B, H, N)} on {q.device}, "
                         f"got {lse.dtype} {tuple(lse.shape)}")
    if not (g.is_contiguous() and out.is_contiguous() and lse.is_contiguous()):
        raise ValueError("g, out and lse must be contiguous")
    if q.device.type == "cpu":
        return full_attention_bwd_reference(q, k, v, bias, g, H)
    if q.device.type != "cuda":
        raise ValueError(f"device {q.device} is not supported")
    if q.dtype == torch.bfloat16:
        _check_aligned(q, k, v, g, out)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty(B, H, N, device=q.device, dtype=torch.float32)
    per = image_group(B, N, H) if bias is not None else 1
    dbias_part = (torch.empty(B // per, H, N, N, device=q.device, dtype=torch.float32)
                  if bias is not None else None)
    with torch.cuda.device(q.device):
        err = build.load().full_attention_bwd(
            _ptr(q), _ptr(k), _ptr(v), _ptr(g), _ptr(out), _ptr(bias), _ptr(lse), _ptr(delta),
            _ptr(dq), _ptr(dk), _ptr(dv), _ptr(dbias_part), B, N, C, H, per,
            int(q.dtype == torch.bfloat16), torch.cuda.current_stream().cuda_stream,
        )
    build.check(err, "full_attention_bwd")
    full_attention_bwd.launches += 1
    if bias is None:
        return dq, dk, dv, None
    return dq, dk, dv, dbias_part[0] if per == B else dbias_part.sum(dim=0)


full_attention_bwd.launches = 0


class FullAttentionFunction(torch.autograd.Function):
    """Dense attention with the hand-written backward: the forward keeps its
    output and per-row log-sum-exp, the backward launches
    :func:`full_attention_bwd`."""

    @staticmethod
    def forward(ctx, q, k, v, bias, num_heads):
        out, lse = full_attention_fwd(q, k, v, bias, num_heads, with_lse=True)
        ctx.save_for_backward(q, k, v, bias, out, lse)
        ctx.num_heads = num_heads
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, bias, out, lse = ctx.saved_tensors
        return (*full_attention_bwd(q, k, v, bias, g.contiguous(), out, lse, ctx.num_heads),
                None)


def full_attention(q, k, v, bias, num_heads: int) -> torch.Tensor:
    """Dense attention through the kernels: the forward alone where no
    gradient is needed, else :class:`FullAttentionFunction`."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in (q, k, v, bias)):
        return FullAttentionFunction.apply(q, k, v, bias, num_heads)
    return full_attention_fwd(q, k, v, bias, num_heads)


class FullAttentionRPEFunction(torch.autograd.Function):
    """Dense attention with a relative-position bias assembled inside the
    Function (``vil_tpu``'s ``make_fused_full_attention_rpe``): the forward
    builds the (H, N, N) f32 bias from the tables with ``assemble`` and runs
    the kernel with the LSE, then saves q, k, v, out, the LSE and the tables,
    not the bias (403 MB a block at N 4097, H 6). The backward rebuilds the
    bias, launches :func:`full_attention_bwd` and takes dbias back to the
    tables through ``assemble`` by autograd."""

    @staticmethod
    def forward(ctx, q, k, v, assemble, num_heads, *tables):
        out, lse = full_attention_fwd(q, k, v, assemble(*tables), num_heads, with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse, *tables)
        ctx.assemble, ctx.num_heads = assemble, num_heads
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse, *tables = ctx.saved_tensors
        leaves = [t.detach().requires_grad_() for t in tables]
        with torch.enable_grad():
            bias = ctx.assemble(*leaves)
        dq, dk, dv, dbias = full_attention_bwd(q, k, v, bias.detach(), g.contiguous(), out, lse,
                                               ctx.num_heads)
        return (dq, dk, dv, None, None, *torch.autograd.grad(bias, leaves, dbias))


def full_attention_rpe(q, k, v, assemble, tables, num_heads: int) -> torch.Tensor:
    """Dense attention through the kernels with the bias ``assemble(*tables)``
    (f32 (H, N, N)): the forward alone where no gradient is needed, else
    :class:`FullAttentionRPEFunction`."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v, *tables)):
        return FullAttentionRPEFunction.apply(q, k, v, assemble, num_heads, *tables)
    return full_attention_fwd(q, k, v, assemble(*tables), num_heads)
