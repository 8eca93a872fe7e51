"""Sampled-neighbour sliding-chunk attention over halo-extended K/V: the
Hopper kernels of random-shift training (MODE 1..8) under spatial
parallelism, and their plain versions.

The halo forms of B5 and B6 (``vil_mode_attention.py``): the forward B5h
(``csrc/vil_mode_attention_halo_fwd.cu``) and the backward B6h
(``csrc/vil_mode_attention_halo_bwd.cu``), in bf16 on the tensor cores and
in f32 on the CUDA cores, and :class:`VilModeAttentionHaloFunction`. They
stand for ``vil_tpu/ops/pallas/vil_mode_kernel.py``'s ``mode_forward`` and
``mode_backward`` as ``vil_tpu`` runs them on a shard: there
``parallel/spatial.py::neighborhood_spatial`` gathers the sampled chunk
from the halo-extended rows by slices and rolls, and the chunk-local mode
kernel attends [self ‖ sampled]; here the kernels read it in place.

A spatial shard (``parallel/spatial.py``) holds ``mxs`` chunk rows of q and
``mxs + 2`` rows of K and V: its own rows between the previous shard's last
row and the next shard's first, cyclic over the ranks. With (dx, dy) =
−``MODE_ROLL_SHIFTS[mode]``, query chunk (i, j) attends to the global keys,
to K/V chunk (i + 1, j) (itself) and to (i + dx + 1, (j + dy) mod my) (the
sampled chunk): rows come from static slices of the extended K/V, with no
wrap, and columns keep the cyclic roll over ``my``. Per query chunk and
head:

    S   = q · [K_glo ‖ K_self ‖ K_sampled]ᵀ + bias + mask
    out = softmax(S) · [V_glo ‖ V_self ‖ V_sampled],    lse = log Σ exp(S)

Layouts: q, out (B, mxs, my, W², C); k_ext, v_ext (B, mxs+2, my, W², C);
k_glo, v_glo (B, Nglo, C); bias (H, W², Nglo+2W²) f32 or None, the same on
every shard; ``mask_rows`` (mxs, my, Wq, Nglo+2W²) this shard's rows of the
whole image's table of the mode; lse (B, H, mxs, my, W²) f32. Columns are in
front order [glo ‖ self ‖ sampled]. The gradients dk_ext and dv_ext have
mxs + 2 rows (zero on a halo row the mode does not read);
``parallel.spatial.halo_rows`` returns the halo rows' share to the shards
that own them. ``mode`` is a host int in 1..8; mode −1 needs no halo and
runs the self-only wrappers of ``vil_mode_attention.py`` on a shard's rows
as they are.
"""
from __future__ import annotations

from typing import Optional

import torch

from .. import sliding_chunk as sc
from .vil_attention import (
    _check_aligned,
    check_grad_operands,
    check_operands,
    grads_by_autograd,
    launch_bwd,
    launch_fwd,
    neighbourhood_attention,
)


def _offset(mode: int) -> tuple[int, int]:
    """(dx, dy) of the sampled chunk of ``mode``, which must be in 1..8."""
    if sc.check_mode(mode) <= 0:
        raise ValueError(f"the sampled-neighbour halo kernels take a mode in 1..8, got {mode}")
    sx, sy = sc.MODE_ROLL_SHIFTS[mode]
    return -int(sx), -int(sy)


def halo_sampled_neighborhood(t_ext: torch.Tensor, mode: int) -> torch.Tensor:
    """(B, mxs+2, my, W², M) halo-extended rows → (B, mxs, my, 2W², M): the
    [self ‖ sampled] chunks of every chunk of the shard at ``mode`` (1..8),
    the gather of ``parallel.spatial.neighborhood_spatial``."""
    dx, dy = _offset(mode)
    mxs = t_ext.shape[1] - 2
    return torch.cat([t_ext[:, 1:1 + mxs],
                      torch.roll(t_ext[:, 1 + dx:1 + dx + mxs], -dy, dims=2)], dim=3)


def vil_mode_attention_halo_reference(q, k_ext, v_ext, k_glo, v_glo, bias, mask_rows,
                                      num_heads: int, mode: int, with_lse: bool = False):
    """Plain PyTorch version: the same function in f32 through the
    [self ‖ sampled] concat matmuls over static row slices of the extended
    K/V; the output is rounded to q's dtype. With ``with_lse`` it returns
    (out, lse)."""
    return neighbourhood_attention(q, k_ext, v_ext, k_glo, v_glo, bias, mask_rows, num_heads,
                                   lambda t: halo_sampled_neighborhood(t, mode), with_lse)


def vil_mode_attention_halo_bwd_reference(q, k_ext, v_ext, k_glo, v_glo, bias, g, mask_rows,
                                          num_heads: int, mode: int):
    """Plain PyTorch version of the backward: autograd through
    :func:`vil_mode_attention_halo_reference` in f32. Returns (dq, dk_ext,
    dv_ext, dk_glo, dv_glo, dbias), each in its operand's dtype, None where
    the operand is."""
    return grads_by_autograd(
        lambda *ops: vil_mode_attention_halo_reference(*ops, mask_rows, num_heads, mode),
        (q, k_ext, v_ext, k_glo, v_glo, bias), g)


def _check(q, k_ext, v_ext, k_glo, v_glo, bias, mask_rows, num_heads, mode):
    _offset(mode)
    check_operands(q, k_ext, v_ext, k_glo, v_glo, bias, mask_rows, num_heads, span=2,
                   halo=True)


def vil_mode_attention_halo_fwd(q: torch.Tensor, k_ext: torch.Tensor, v_ext: torch.Tensor,
                                k_glo: Optional[torch.Tensor], v_glo: Optional[torch.Tensor],
                                bias: Optional[torch.Tensor], mask_rows: torch.Tensor,
                                num_heads: int, mode: int, with_lse: bool = False):
    """Sampled-neighbour halo attention forward. On a CUDA device this
    launches the hand-written kernel (or raises); on the CPU it runs the
    plain version. With ``with_lse`` it returns (out, lse). It records no
    gradient: the differentiable form is :func:`vil_mode_attention_halo`."""
    _check(q, k_ext, v_ext, k_glo, v_glo, bias, mask_rows, num_heads, mode)
    if q.device.type == "cpu":
        with torch.no_grad():
            return vil_mode_attention_halo_reference(q, k_ext, v_ext, k_glo, v_glo, bias,
                                                     mask_rows, num_heads, mode, with_lse)
    if q.dtype == torch.bfloat16:  # the tensor-core kernel
        _check_aligned(q, k_ext, v_ext, k_glo, v_glo)
    out, lse = launch_fwd("vil_mode_attention_halo_fwd", q, k_ext, v_ext, k_glo, v_glo, bias,
                          mask_rows, num_heads, with_lse, *_offset(mode))
    vil_mode_attention_halo_fwd.launches += 1
    return (out, lse) if with_lse else out


vil_mode_attention_halo_fwd.launches = 0


def vil_mode_attention_halo_bwd(q, k_ext, v_ext, k_glo, v_glo, bias, g, out, mask_rows, lse,
                                num_heads: int, mode: int):
    """Sampled-neighbour halo attention backward from the forward's ``out``
    and ``lse``: returns (dq, dk_ext, dv_ext, dk_glo, dv_glo, dbias), None
    where the operand is; dk_ext and dv_ext have the halo rows. On a CUDA
    device this launches the hand-written kernels (or raises); the bf16 ones
    take δ = rowsum(g ∘ out). On the CPU it runs the plain version, which
    recomputes the softmax and reads neither ``out`` nor ``lse``."""
    _check(q, k_ext, v_ext, k_glo, v_glo, bias, mask_rows, num_heads, mode)
    check_grad_operands(q, g, lse, num_heads, out, takes_out=True)
    if q.device.type == "cpu":
        return vil_mode_attention_halo_bwd_reference(q, k_ext, v_ext, k_glo, v_glo, bias, g,
                                                     mask_rows, num_heads, mode)
    if q.dtype == torch.bfloat16:  # the tensor-core kernels
        _check_aligned(q, k_ext, v_ext, k_glo, v_glo, g, out)
    grads = launch_bwd("vil_mode_attention_halo_bwd", 2, q, k_ext, v_ext, k_glo, v_glo, bias, g,
                       mask_rows, lse, num_heads, *_offset(mode), out=out)
    vil_mode_attention_halo_bwd.launches += 1
    return grads


vil_mode_attention_halo_bwd.launches = 0


class VilModeAttentionHaloFunction(torch.autograd.Function):
    """Sampled-neighbour halo attention with the hand-written backward: the
    forward keeps its output and per-row log-sum-exp, the backward launches
    :func:`vil_mode_attention_halo_bwd` from them and returns dk_ext, dv_ext
    with the halo rows."""

    @staticmethod
    def forward(ctx, q, k_ext, v_ext, k_glo, v_glo, bias, mask_rows, num_heads, mode):
        out, lse = vil_mode_attention_halo_fwd(q, k_ext, v_ext, k_glo, v_glo, bias, mask_rows,
                                               num_heads, mode, with_lse=True)
        ctx.save_for_backward(q, k_ext, v_ext, k_glo, v_glo, bias, mask_rows, out, lse)
        ctx.num_heads, ctx.mode = num_heads, mode
        return out

    @staticmethod
    def backward(ctx, g):
        q, k_ext, v_ext, k_glo, v_glo, bias, mask_rows, out, lse = ctx.saved_tensors
        grads = vil_mode_attention_halo_bwd(q, k_ext, v_ext, k_glo, v_glo, bias, g.contiguous(),
                                            out, mask_rows, lse, ctx.num_heads, ctx.mode)
        return (*grads, None, None, None)


def vil_mode_attention_halo(q, k_ext, v_ext, k_glo, v_glo, bias, mask_rows, num_heads: int,
                            mode: int) -> torch.Tensor:
    """Sampled-neighbour halo attention through the kernels: the forward
    alone where no gradient is needed, else
    :class:`VilModeAttentionHaloFunction`."""
    operands = (q, k_ext, v_ext, k_glo, v_glo, bias)
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in operands):
        return VilModeAttentionHaloFunction.apply(q, k_ext, v_ext, k_glo, v_glo, bias,
                                                  mask_rows, num_heads, mode)
    return vil_mode_attention_halo_fwd(q, k_ext, v_ext, k_glo, v_glo, bias, mask_rows,
                                       num_heads, mode)
