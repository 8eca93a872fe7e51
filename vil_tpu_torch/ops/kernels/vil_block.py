"""The fused attention block: the Hopper kernels and their plain versions.

Counterpart of ``vil_tpu/ops/pallas/vil_block.py``: of
``_pallas_block_forward`` (the forward kernel B9a, ``csrc/vil_block_fwd.cu``:
in bf16 on the tensor cores, its products in ``csrc/gemm_tc.cuh`` and its
attention on B1's body), of ``_pallas_block_backward`` (the backward kernel
B9b, ``csrc/vil_block_bwd.cu``: in bf16 on the tensor cores, its products in
``csrc/gemm_tc.cuh`` and its attention on B2's body; both in f32 on the CUDA
cores), of ``make_fused_vil_block``
(:class:`VilBlockFunction`, :func:`vil_block`) and of ``_xla_block_reference``
(the plain version, :func:`vil_block_reference`). One ViL attention block's
local branch at neighbour mode 0, from the LayerNorm output x to the
projected output y:

    q = x·Wq + bq,  k = x·Wk + bk,  v = x·Wv + bv     (f32 sums, rounded to x's type)
    attn = sliding-chunk attention of q over [k_glo ‖ 3×3 chunk neighbourhood]
    y = attn·Wo + bo

Layouts: x, y, k, v (B, mx, my, W², C); weights (C, C) in (in, out) layout
(flax's: y = x·W) and x's type, wq and bq scaled by M^-½; biases f32 (C,),
bq, bk, bv may be None; k_glo, v_glo (B, Nglo, C) the projected global rows,
or None; bias (H, W², Nglo+9W²) f32 in front column order, or None; mask as
in ``vil_attention.py``. The block also returns k and v (the projected image
rows), which the block's global branch reads; their gradients are folded
into dx, dWk, dbk, dWv and dbv by :class:`VilBlockFunction` with plain
matrix products, as the JAX package does in XLA outside its kernel.

The JAX package routes a shape here only when ``block_fits`` finds that a
whole image fits the TPU's VMEM. The kernels here stage one chunk, or one
matrix tile, at a time, so they take any (mx, my), cyclic 1×2 and 2×2 grids
and padded grids included, and nothing gates them. The forward keeps q and
attn for the backward (the TPU kernel recomputes them from x). The bf16
kernels copy rows 16 bytes at a time: their bf16 operands must start on a
16-byte boundary, and C must be a multiple of 8.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import build
from .vil_attention import (
    _check_aligned,
    _ptr,
    bf16_exp,
    check_grad_operands,
    check_operands,
    vil_attention_reference,
)

WEIGHT_GRAD_SLICES = 128  # most row slices of the f32 weight-gradient partials


def _project(t, w, b):
    """t·w (+ b) in f32 over t's type's values, rounded to t's type."""
    y = torch.matmul(t.float(), w.to(t.dtype).float())
    if b is not None:
        y = y + b.float()
    return y.to(t.dtype)


def vil_block_fwd_reference(x, wq, bq, wk, bk, wv, bv, wo, bo, k_glo, v_glo, bias, mask_add,
                            num_heads: int, with_lse: bool = False):
    """Plain PyTorch version of everything the forward kernels write: (y, q,
    k, v, attn, lse), lse None without ``with_lse``; q, k, v and attn are
    rounded to x's type as the kernels store them."""
    q, k, v = _project(x, wq, bq), _project(x, wk, bk), _project(x, wv, bv)
    out = vil_attention_reference(q, k, v, k_glo, v_glo, bias, mask_add, num_heads, with_lse)
    attn, lse = out if with_lse else (out, None)
    return _project(attn, wo, bo), q, k, v, attn, lse


def vil_block_reference(x, wq, bq, wk, bk, wv, bv, wo, bo, k_glo, v_glo, bias, mask_add,
                        num_heads: int):
    """Plain PyTorch version, ``_xla_block_reference``: the three
    projections, :func:`vil_attention_reference`, the output projection.
    Returns (y, k, v); differentiable."""
    y, _, k, v, _, _ = vil_block_fwd_reference(x, wq, bq, wk, bk, wv, bv, wo, bo, k_glo, v_glo,
                                               bias, mask_add, num_heads)
    return y, k, v


def vil_block_bwd_reference(x, wq, bq, wk, bk, wv, bv, wo, bo, k_glo, v_glo, bias, g,
                            mask_add, num_heads: int):
    """Plain PyTorch version of the backward: autograd through
    :func:`vil_block_reference` in f32 with ``g`` the gradient of y (none of
    k and v). Returns (dx, dwq, dbq, dwk, dbk, dwv, dbv, dwo, dbo, dk_glo,
    dv_glo, dbias): dx in x's type, the others in f32, None where the
    operand is."""
    operands = (x, wq, bq, wk, bk, wv, bv, wo, bo, k_glo, v_glo, bias)
    leaves = [None if t is None else t.detach().float().requires_grad_() for t in operands]
    with torch.enable_grad():
        y, _, _ = vil_block_reference(*leaves, mask_add, num_heads)
        present = [t for t in leaves if t is not None]
        grads = iter(torch.autograd.grad(y, present, g.float()))
    out = [None if t is None else next(grads) for t in operands]
    out[0] = out[0].to(x.dtype)
    return tuple(out)


def _check(x, wq, bq, wk, bk, wv, bv, wo, bo, k_glo, v_glo, bias, mask_add, num_heads):
    """Raise on what the kernels do not take."""
    check_operands(x, x, x, k_glo, v_glo, bias, mask_add, num_heads)
    C = x.shape[-1]
    if C % 8:  # the kernels' products stage rows of 8 values (16 bf16 bytes)
        raise ValueError(f"the width C must be a multiple of 8, got {C}")
    for name, w in (("wq", wq), ("wk", wk), ("wv", wv), ("wo", wo)):
        if w.shape != (C, C) or w.dtype != x.dtype or w.device != x.device:
            raise ValueError(f"{name} must be {x.dtype} ({C}, {C}) on {x.device}, got "
                             f"{w.dtype} {tuple(w.shape)} on {w.device}")
        if not w.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if bo is None:
        raise ValueError("bo must be given")
    for name, b in (("bq", bq), ("bk", bk), ("bv", bv), ("bo", bo)):
        if b is not None and (b.shape != (C,) or b.dtype != torch.float32
                              or b.device != x.device or not b.is_contiguous()):
            raise ValueError(f"{name} must be contiguous float32 ({C},) on {x.device}, got "
                             f"{b.dtype} {tuple(b.shape)}")


def vil_block_fwd(x: torch.Tensor, wq: torch.Tensor, bq: Optional[torch.Tensor],
                  wk: torch.Tensor, bk: Optional[torch.Tensor], wv: torch.Tensor,
                  bv: Optional[torch.Tensor], wo: torch.Tensor, bo: torch.Tensor,
                  k_glo: Optional[torch.Tensor], v_glo: Optional[torch.Tensor],
                  bias: Optional[torch.Tensor], mask_add: torch.Tensor, num_heads: int,
                  with_lse: bool = False, saved: bool = False):
    """Fused attention block forward: (y, k, v), with ``with_lse`` (y, k, v,
    lse), with ``saved`` as well the q and attn the backward reads. On a CUDA
    device this launches the hand-written kernels (or raises); on the CPU it
    runs the plain version. It records no gradient: the differentiable form
    is :func:`vil_block`."""
    _check(x, wq, bq, wk, bk, wv, bv, wo, bo, k_glo, v_glo, bias, mask_add, num_heads)
    if x.device.type == "cpu":
        with torch.no_grad():
            y, q, k, v, attn, lse = vil_block_fwd_reference(
                x, wq, bq, wk, bk, wv, bv, wo, bo, k_glo, v_glo, bias, mask_add, num_heads,
                with_lse)
    else:
        if x.device.index != torch.cuda.current_device():
            with torch.cuda.device(x.device):
                return vil_block_fwd(x, wq, bq, wk, bk, wv, bv, wo, bo, k_glo, v_glo, bias,
                                     mask_add, num_heads, with_lse, saved)
        if x.dtype == torch.bfloat16:  # the tensor-core kernels
            _check_aligned(x, wq, wk, wv, wo, k_glo, v_glo)
        B, mx, my, w2, C = x.shape
        nglo = 0 if k_glo is None else k_glo.shape[1]
        q, k, v, attn, y = (torch.empty_like(x) for _ in range(5))
        lse = (torch.empty(B, num_heads, mx, my, w2, device=x.device, dtype=torch.float32)
               if with_lse else None)
        err = build.load().vil_block_fwd(
            *(_ptr(t) for t in (x, wq, wk, wv, bq, bk, bv, wo, bo, k_glo, v_glo, bias,
                                mask_add, q, k, v, attn, y, lse)),
            B, mx, my, w2, C, num_heads, nglo, mask_add.shape[2],
            int(x.dtype == torch.bfloat16), int(bf16_exp()), build.stream(x.device))
        build.check(err, "vil_block_fwd")
        vil_block_fwd.launches += 1
    out = (y, k, v) + ((lse,) if with_lse else ())
    return out + (q, attn) if saved else out


vil_block_fwd.launches = 0


def vil_block_bwd(x, wq, bq, wk, bk, wv, bv, wo, bo, k_glo, v_glo, bias, g, mask_add, lse,
                  num_heads: int, saved):
    """Fused attention block backward from the gradient g of y, the
    forward's ``lse`` and ``saved`` = (q, k, v, attn) of the forward: returns
    (dx, dwq, dbq, dwk, dbk, dwv, dbv, dwo, dbo, dk_glo, dv_glo, dbias), dx
    in x's type and the others in f32, None where the operand is. On a CUDA
    device this launches the hand-written kernels (or raises); on the CPU it
    runs the plain version, which recomputes the forward and ignores ``lse``
    and ``saved``."""
    _check(x, wq, bq, wk, bk, wv, bv, wo, bo, k_glo, v_glo, bias, mask_add, num_heads)
    check_grad_operands(x, g, lse, num_heads)
    if x.device.type == "cpu":
        return vil_block_bwd_reference(x, wq, bq, wk, bk, wv, bv, wo, bo, k_glo, v_glo, bias, g,
                                       mask_add, num_heads)
    if x.device.index != torch.cuda.current_device():
        with torch.cuda.device(x.device):
            return vil_block_bwd(x, wq, bq, wk, bk, wv, bv, wo, bo, k_glo, v_glo, bias, g,
                                 mask_add, lse, num_heads, saved)
    q, k, v, attn = saved
    if any(t.shape != x.shape or t.dtype != x.dtype or not t.is_contiguous() for t in saved):
        raise ValueError("saved must be the forward's contiguous q, k, v, attn")
    if x.dtype == torch.bfloat16:  # the tensor-core kernels
        _check_aligned(x, wq, wk, wv, wo, k_glo, v_glo, g, *saved)
    B, mx, my, w2, C = x.shape
    H = num_heads
    nglo = 0 if k_glo is None else k_glo.shape[1]
    R = B * mx * my * w2
    per_slice = -(-R // min(WEIGHT_GRAD_SLICES, max(1, R // 256)))
    slices = -(-R // per_slice)
    f32 = dict(device=x.device, dtype=torch.float32)
    dattn, dq, dk, dv, dx = (torch.empty_like(x) for _ in range(5))
    delta = torch.empty(B, H, mx, my, w2, **f32)
    p_glo = torch.empty(B, H, mx, my, w2, nglo, **f32) if nglo else None
    ds_glo = torch.empty(B, H, mx, my, w2, nglo, **f32) if nglo else None
    dkg = torch.empty(B, nglo, C, **f32) if nglo else None
    dvg = torch.empty(B, nglo, C, **f32) if nglo else None
    cols = mask_add.shape[3]
    dbias_part = torch.zeros(B, H, w2, cols, **f32) if bias is not None else None
    part = torch.empty(slices, 4 * C * C + 4 * C, **f32)
    grads = torch.empty(4 * C * C + 4 * C, **f32)
    err = build.load().vil_block_bwd(
        *(_ptr(t) for t in (x, wq, wk, wv, wo, k_glo, v_glo, bias, mask_add, q, k, v, attn,
                            g, lse, dattn, delta, dq, dk, dv, p_glo, ds_glo, dbias_part,
                            dkg, dvg, part, grads, dx)),
        B, mx, my, w2, C, H, nglo, mask_add.shape[2], slices, per_slice,
        int(x.dtype == torch.bfloat16), int(bf16_exp()), build.stream(x.device))
    build.check(err, "vil_block_bwd")
    vil_block_bwd.launches += 1
    dw = grads[:4 * C * C].view(4, C, C)
    db = grads[4 * C * C:].view(4, C)
    dbias = None if bias is None else dbias_part.sum(dim=0)
    return (dx, dw[0], None if bq is None else db[0], dw[1], None if bk is None else db[1],
            dw[2], None if bv is None else db[2], dw[3], db[3], dkg, dvg, dbias)


vil_block_bwd.launches = 0


class VilBlockFunction(torch.autograd.Function):
    """The fused block with the hand-written backward. The forward keeps its
    log-sum-exp, q and attn; the backward launches :func:`vil_block_bwd` for
    the gradient of y and folds those of k and v (the global branch's) into
    dx, dWk, dbk, dWv and dbv with plain matrix products."""

    @staticmethod
    def forward(ctx, x, wq, bq, wk, bk, wv, bv, wo, bo, k_glo, v_glo, bias, mask_add,
                num_heads):
        y, k, v, lse, q, attn = vil_block_fwd(x, wq, bq, wk, bk, wv, bv, wo, bo, k_glo, v_glo,
                                              bias, mask_add, num_heads, with_lse=True,
                                              saved=True)
        ctx.save_for_backward(x, wq, bq, wk, bk, wv, bv, wo, bo, k_glo, v_glo, bias, mask_add,
                              lse, q, k, v, attn)
        ctx.num_heads = num_heads
        ctx.set_materialize_grads(False)  # an unused output's gradient arrives as None
        return y, k, v

    @staticmethod
    def backward(ctx, g_y, g_k, g_v):
        (x, wq, bq, wk, bk, wv, bv, wo, bo, k_glo, v_glo, bias, mask_add, lse, q, k, v,
         attn) = ctx.saved_tensors
        if g_y is None:
            g_y = torch.zeros_like(x)
        grads = list(vil_block_bwd(x, wq, bq, wk, bk, wv, bv, wo, bo, k_glo, v_glo, bias,
                                   g_y.contiguous(), mask_add, lse, ctx.num_heads,
                                   (q, k, v, attn)))
        C = x.shape[-1]
        x2 = x.reshape(-1, C)
        # the k and v outputs: dx += g·Wᵀ, dW += xᵀ·g, db += Σ g
        for g_t, w, iw in ((g_k, wk, 3), (g_v, wv, 5)):
            if g_t is None:
                continue
            g2 = g_t.reshape(-1, C)
            grads[0] = grads[0] + torch.matmul(g2, w.t()).reshape(x.shape).to(x.dtype)
            grads[iw] = grads[iw] + torch.matmul(x2.t().float(), g2.float())
            if grads[iw + 1] is not None:
                grads[iw + 1] = grads[iw + 1] + g2.float().sum(dim=0)
        operands = (x, wq, bq, wk, bk, wv, bv, wo, bo, k_glo, v_glo, bias)
        grads = [None if t is None else d.to(t.dtype) for t, d in zip(operands, grads)]
        return (*grads, None, None)


def vil_block(x, wq, bq, wk, bk, wv, bv, wo, bo, k_glo, v_glo, bias, mask_add,
              num_heads: int):
    """The fused block through the kernels: (y, k, v), the forward alone
    where no gradient is needed, else :class:`VilBlockFunction`."""
    operands = (x, wq, bq, wk, bk, wv, bv, wo, bo, k_glo, v_glo, bias)
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in operands):
        return VilBlockFunction.apply(x, wq, bq, wk, bk, wv, bv, wo, bo, k_glo, v_glo, bias,
                                      mask_add, num_heads)
    return vil_block_fwd(x, wq, bq, wk, bk, wv, bv, wo, bo, k_glo, v_glo, bias, mask_add,
                         num_heads)
