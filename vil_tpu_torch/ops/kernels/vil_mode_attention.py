"""Sampled-neighbour sliding-chunk attention (MODE 1..8) and its self-only
form (mode -1): the Hopper kernels and their plain versions.

Counterpart of ``vil_tpu/ops/pallas/vil_mode_kernel.py``: of ``mode_forward``
(the forward kernel B5, ``csrc/vil_mode_attention_fwd.cu``), of
``mode_backward`` (the backward kernels B6, ``csrc/vil_mode_attention_bwd.cu``),
both in bf16 on the tensor cores and in f32 on the CUDA cores, and of
``make_fused_mode_attention`` (:class:`VilModeAttentionFunction`).
Random-shift training attends each query chunk to itself and to ONE
neighbour chunk sampled per layer and step. Per query chunk (i, j) and head:

    S   = q · [K_glo ‖ K_self ‖ K_sampled]ᵀ + bias + mask
    out = softmax(S) · [V_glo ‖ V_self ‖ V_sampled],    lse = log Σ exp(S)

The sampled chunk is ((i + dx) mod mx, (j + dy) mod my), with (dx, dy) =
−``MODE_ROLL_SHIFTS[mode]``: the kernels read it in place, where the TPU path
rolls copies of K and V in XLA first. Layouts are those of
``vil_attention.py``: q, k, v, out (B, mx, my, W², C); k_glo, v_glo
(B, Nglo, C); bias (H, W², Nglo+2W²) f32 or None; mask
(mx, my, Wq, Nglo+2W²) f32, Wq ∈ {1, W²}; lse (B, H, mx, my, W²) f32.
Score columns are in front order [glo ‖ self ‖ sampled] (the JAX kernel's
tail order [self ‖ sampled ‖ glo] is a TPU layout choice). ``mode`` is a
host int in 1..8. The gradients dk and dv are with respect to the unrolled
k and v: the JAX kernel's dks + roll⁻¹(dknb). The backward takes the
forward's ``out``: its bf16 kernels form δ = rowsum(P ∘ dP) as
rowsum(g ∘ out).

Mode -1 attends each query chunk to the global keys and to itself alone,
[glo ‖ self] (bias (H, W², Nglo+W²), mask (mx, my, Wq, Nglo+W²)): the same
kernels' bodies over a one-chunk neighbourhood (``SelfNbh``), launched by
their own entry points (``vil_self_attention_fwd`` / ``_bwd``), with
wrappers and launch counts of their own (:func:`vil_self_attention_fwd`,
:func:`vil_self_attention_bwd`); :func:`vil_mode_attention_fwd`,
:func:`vil_mode_attention_bwd` and :func:`vil_mode_attention` take mode -1
through them. ``vil_tpu`` has no Pallas kernel for mode -1: it runs its XLA
tier there (``vil_tpu/models/attention.py:768``). The port writes a kernel
all the same, because its plain version is the oracle of the tests and runs
on no card.
"""
from __future__ import annotations

from typing import Optional

import torch

from .. import sliding_chunk as sc
from .vil_attention import (
    _check_aligned,
    check_grad_operands,
    check_operands,
    chunk_attention_bwd_reference,
    chunk_attention_reference,
    launch_bwd,
    launch_fwd,
)


def _offset(mode: int) -> tuple[int, ...]:
    """(dx, dy) of the sampled chunk of ``mode`` (1..8); () for the self
    chunk alone (-1), whose entry points take no offset."""
    if sc.check_mode(mode) == 0:
        raise ValueError("the sampled-neighbour kernels take a mode in 1..8 or -1, got 0")
    if mode == -1:
        return ()
    sx, sy = sc.MODE_ROLL_SHIFTS[mode]
    return -int(sx), -int(sy)


def _check(q, k, v, k_glo, v_glo, bias, mask_add, num_heads, mode):
    span = 1 if len(_offset(mode)) == 0 else 2  # key chunks a query chunk attends to
    check_operands(q, k, v, k_glo, v_glo, bias, mask_add, num_heads, span=span)


def vil_mode_attention_reference(q, k, v, k_glo, v_glo, bias, mask_add, num_heads: int,
                                 mode: int, with_lse: bool = False):
    """Plain PyTorch version: the same function in f32 through the
    [self ‖ sampled] (mode -1: [self]) concat matmuls of
    ``ops.sliding_chunk.neighborhood``; the output is rounded to q's dtype.
    With ``with_lse`` it returns (out, lse)."""
    _offset(mode)
    return chunk_attention_reference(q, k, v, k_glo, v_glo, bias, mask_add, num_heads, mode,
                                     with_lse)


def vil_mode_attention_bwd_reference(q, k, v, k_glo, v_glo, bias, g, mask_add,
                                     num_heads: int, mode: int):
    """Plain PyTorch version of the backward: autograd through
    :func:`vil_mode_attention_reference` in f32. Returns (dq, dk, dv, dk_glo,
    dv_glo, dbias), each in its operand's dtype, None where the operand is."""
    _offset(mode)
    return chunk_attention_bwd_reference(q, k, v, k_glo, v_glo, bias, g, mask_add,
                                         num_heads, mode)


def vil_mode_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           k_glo: Optional[torch.Tensor], v_glo: Optional[torch.Tensor],
                           bias: Optional[torch.Tensor], mask_add: torch.Tensor,
                           num_heads: int, mode: int, with_lse: bool = False):
    """Sampled-neighbour attention forward. On a CUDA device this launches
    the hand-written kernel (or raises); on the CPU it runs the plain
    version. With ``with_lse`` it returns (out, lse). It records no
    gradient: the differentiable form is :func:`vil_mode_attention`."""
    if mode == -1:
        return vil_self_attention_fwd(q, k, v, k_glo, v_glo, bias, mask_add, num_heads,
                                      with_lse)
    _check(q, k, v, k_glo, v_glo, bias, mask_add, num_heads, mode)
    if q.device.type == "cpu":
        with torch.no_grad():
            return vil_mode_attention_reference(q, k, v, k_glo, v_glo, bias, mask_add,
                                                num_heads, mode, with_lse)
    if q.dtype == torch.bfloat16:  # the tensor-core kernel
        _check_aligned(q, k, v, k_glo, v_glo)
    out, lse = launch_fwd("vil_mode_attention_fwd", q, k, v, k_glo, v_glo, bias, mask_add,
                          num_heads, with_lse, *_offset(mode))
    vil_mode_attention_fwd.launches += 1
    return (out, lse) if with_lse else out


vil_mode_attention_fwd.launches = 0


def vil_self_attention_fwd(q, k, v, k_glo, v_glo, bias, mask_add, num_heads: int,
                           with_lse: bool = False):
    """Self-only (mode -1) attention forward, [glo ‖ self]: on a CUDA device
    the kernel (``SelfNbh``'s instance, entry ``vil_self_attention_fwd``) or
    an error, on the CPU the plain version. With ``with_lse`` it returns
    (out, lse)."""
    _check(q, k, v, k_glo, v_glo, bias, mask_add, num_heads, -1)
    if q.device.type == "cpu":
        with torch.no_grad():
            return vil_mode_attention_reference(q, k, v, k_glo, v_glo, bias, mask_add,
                                                num_heads, -1, with_lse)
    if q.dtype == torch.bfloat16:  # the tensor-core kernel
        _check_aligned(q, k, v, k_glo, v_glo)
    out, lse = launch_fwd("vil_self_attention_fwd", q, k, v, k_glo, v_glo, bias, mask_add,
                          num_heads, with_lse)
    vil_self_attention_fwd.launches += 1
    return (out, lse) if with_lse else out


vil_self_attention_fwd.launches = 0


def vil_mode_attention_bwd(q, k, v, k_glo, v_glo, bias, g, out, mask_add, lse,
                           num_heads: int, mode: int):
    """Sampled-neighbour attention backward from the forward's ``out`` and
    ``lse``: returns (dq, dk, dv, dk_glo, dv_glo, dbias), None where the
    operand is. On a CUDA device this launches the hand-written kernels (or
    raises); the bf16 ones take δ = rowsum(g ∘ out). On the CPU it runs the
    plain version, which recomputes the softmax and reads neither ``out``
    nor ``lse``."""
    if mode == -1:
        return vil_self_attention_bwd(q, k, v, k_glo, v_glo, bias, g, out, mask_add, lse,
                                      num_heads)
    _check(q, k, v, k_glo, v_glo, bias, mask_add, num_heads, mode)
    check_grad_operands(q, g, lse, num_heads, out, takes_out=True)
    if q.device.type == "cpu":
        return vil_mode_attention_bwd_reference(q, k, v, k_glo, v_glo, bias, g, mask_add,
                                                num_heads, mode)
    if q.dtype == torch.bfloat16:  # the tensor-core kernels
        _check_aligned(q, k, v, k_glo, v_glo, g, out)
    grads = launch_bwd("vil_mode_attention_bwd", 2, q, k, v, k_glo, v_glo, bias, g, mask_add,
                       lse, num_heads, *_offset(mode), out=out)
    vil_mode_attention_bwd.launches += 1
    return grads


vil_mode_attention_bwd.launches = 0


def vil_self_attention_bwd(q, k, v, k_glo, v_glo, bias, g, out, mask_add, lse,
                           num_heads: int):
    """Self-only (mode -1) attention backward from the forward's ``out`` and
    ``lse``: (dq, dk, dv, dk_glo, dv_glo, dbias), None where the operand is.
    On a CUDA device the kernels (entry ``vil_self_attention_bwd``) or an
    error, on the CPU the plain version."""
    _check(q, k, v, k_glo, v_glo, bias, mask_add, num_heads, -1)
    check_grad_operands(q, g, lse, num_heads, out, takes_out=True)
    if q.device.type == "cpu":
        return vil_mode_attention_bwd_reference(q, k, v, k_glo, v_glo, bias, g, mask_add,
                                                num_heads, -1)
    if q.dtype == torch.bfloat16:  # the tensor-core kernels
        _check_aligned(q, k, v, k_glo, v_glo, g, out)
    grads = launch_bwd("vil_self_attention_bwd", 1, q, k, v, k_glo, v_glo, bias, g, mask_add,
                       lse, num_heads, out=out)
    vil_self_attention_bwd.launches += 1
    return grads


vil_self_attention_bwd.launches = 0


class VilModeAttentionFunction(torch.autograd.Function):
    """Sampled-neighbour (or self-only) attention with the hand-written
    backward: the forward keeps its output and per-row log-sum-exp, the
    backward launches :func:`vil_mode_attention_bwd` from them."""

    @staticmethod
    def forward(ctx, q, k, v, k_glo, v_glo, bias, mask_add, num_heads, mode):
        out, lse = vil_mode_attention_fwd(q, k, v, k_glo, v_glo, bias, mask_add, num_heads,
                                          mode, with_lse=True)
        ctx.save_for_backward(q, k, v, k_glo, v_glo, bias, mask_add, out, lse)
        ctx.num_heads, ctx.mode = num_heads, mode
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, k_glo, v_glo, bias, mask_add, out, lse = ctx.saved_tensors
        grads = vil_mode_attention_bwd(q, k, v, k_glo, v_glo, bias, g.contiguous(), out,
                                       mask_add, lse, ctx.num_heads, ctx.mode)
        return (*grads, None, None, None)


def vil_mode_attention(q, k, v, k_glo, v_glo, bias, mask_add, num_heads: int,
                       mode: int) -> torch.Tensor:
    """Sampled-neighbour (``mode`` 1..8) or self-only (-1) attention through
    the kernels: the forward alone where no gradient is needed, else
    :class:`VilModeAttentionFunction`."""
    operands = (q, k, v, k_glo, v_glo, bias)
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in operands):
        return VilModeAttentionFunction.apply(q, k, v, k_glo, v_glo, bias, mask_add,
                                              num_heads, mode)
    return vil_mode_attention_fwd(q, k, v, k_glo, v_glo, bias, mask_add, num_heads, mode)
