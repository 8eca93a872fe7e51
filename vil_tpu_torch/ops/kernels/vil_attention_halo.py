"""Halo-input sliding-chunk attention: the Hopper kernels of spatial
parallelism and their plain versions.

Counterpart of ``vil_tpu/ops/pallas/vil_kernel.py::_pallas_forward_halo``
(the forward kernel B7a, ``csrc/vil_attention_halo_fwd.cu``: in bf16 on the
tensor cores, B1's body over the halo rows), of
``vil_tpu/ops/pallas/vil_backward.py::backward_whole_image_halo`` (the
backward kernels B7b, ``csrc/vil_attention_halo_bwd.cu``: in bf16 on the
tensor cores, from the forward's ``out``), of
``make_fused_vil_attention_halo`` (:class:`VilAttentionHaloFunction`) and of
``_xla_reference_ext_mh`` (the plain version,
:func:`vil_attention_halo_reference`).

A spatial shard (``parallel/spatial.py``) holds ``mxs`` chunk rows of q and
``mxs + 2`` rows of K and V: its own rows between the previous shard's last
row and the next shard's first, cyclic over the ranks. Neighbour (dx, dy) of
query chunk (i, j) is K/V chunk (i + dx + 1, (j + dy) mod my): rows come from
static slices of the extended K/V, with no wrap, and columns keep the cyclic
roll over ``my``. Per query chunk and head:

    S   = q · [K_glo ‖ K of the 3×3 halo neighbourhood]ᵀ + bias + mask
    out = softmax(S) · [V_glo ‖ V_nbh],    lse = log Σ exp(S)

Layouts: q, out (B, mxs, my, W², C); k_ext, v_ext (B, mxs+2, my, W², C);
k_glo, v_glo (B, Nglo, C); bias (H, W², Nglo+9W²) f32 or None; lse
(B, H, mxs, my, W²) f32. The gradients dk_ext and dv_ext have mxs + 2 rows;
``parallel.spatial.halo_rows`` returns the halo rows' share to the shards
that own them.

Not carried over: the TPU kernel's mask-class indirection (``classes_host``
with a traced ``row_class``, ``spatial.halo_tables``, ``tail_mask_classes``),
which exists to save VMEM and SMEM. These kernels take **this shard's rows**
``mask_rows`` (mxs, my, Wq, Nglo+9W²) of the whole image's additive table,
sliced along dim 0 together with the data, as the XLA tier's
``spatial_local_attention`` takes them.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..masks import NEIGHBOR_OFFSETS
from .vil_attention import (
    _check_aligned,
    check_grad_operands,
    check_operands,
    grads_by_autograd,
    launch_bwd,
    launch_fwd,
    neighbourhood_attention,
)


def halo_neighborhood(t_ext: torch.Tensor) -> torch.Tensor:
    """(B, mxs+2, my, W², M) halo-extended rows → (B, mxs, my, 9W², M): the
    3×3 neighbourhood of every chunk of the shard, in the order of
    ``masks.NEIGHBOR_OFFSETS``."""
    mxs = t_ext.shape[1] - 2
    return torch.cat([torch.roll(t_ext[:, 1 + dx:1 + dx + mxs], -dy, dims=2)
                      for dx, dy in NEIGHBOR_OFFSETS], dim=3)


def vil_attention_halo_reference(q, k_ext, v_ext, k_glo, v_glo, bias, mask_rows,
                                 num_heads: int, with_lse: bool = False):
    """Plain PyTorch version: the same function in f32 through the
    neighbourhood-concat matmuls over static row slices of the extended K/V;
    the output is rounded to q's dtype. With ``with_lse`` it returns
    (out, lse)."""
    return neighbourhood_attention(q, k_ext, v_ext, k_glo, v_glo, bias, mask_rows, num_heads,
                                   halo_neighborhood, with_lse)


def vil_attention_halo_bwd_reference(q, k_ext, v_ext, k_glo, v_glo, bias, g, mask_rows,
                                     num_heads: int):
    """Plain PyTorch version of the backward: autograd through
    :func:`vil_attention_halo_reference` in f32. Returns (dq, dk_ext,
    dv_ext, dk_glo, dv_glo, dbias), each in its operand's dtype, None where
    the operand is."""
    return grads_by_autograd(
        lambda *ops: vil_attention_halo_reference(*ops, mask_rows, num_heads),
        (q, k_ext, v_ext, k_glo, v_glo, bias), g)


def vil_attention_halo_fwd(q: torch.Tensor, k_ext: torch.Tensor, v_ext: torch.Tensor,
                           k_glo: Optional[torch.Tensor], v_glo: Optional[torch.Tensor],
                           bias: Optional[torch.Tensor], mask_rows: torch.Tensor,
                           num_heads: int, with_lse: bool = False):
    """Halo-input attention forward. On a CUDA device this launches the
    hand-written kernel (or raises); on the CPU it runs the plain version.
    With ``with_lse`` it returns (out, lse). It records no gradient: the
    differentiable form is :func:`vil_attention_halo`."""
    check_operands(q, k_ext, v_ext, k_glo, v_glo, bias, mask_rows, num_heads, halo=True)
    if q.device.type == "cpu":
        with torch.no_grad():
            return vil_attention_halo_reference(q, k_ext, v_ext, k_glo, v_glo, bias,
                                                mask_rows, num_heads, with_lse)
    if q.dtype == torch.bfloat16:  # the tensor-core kernel
        _check_aligned(q, k_ext, v_ext, k_glo, v_glo)
    out, lse = launch_fwd("vil_attention_halo_fwd", q, k_ext, v_ext, k_glo, v_glo, bias,
                          mask_rows, num_heads, with_lse)
    vil_attention_halo_fwd.launches += 1
    return (out, lse) if with_lse else out


vil_attention_halo_fwd.launches = 0


def vil_attention_halo_bwd(q, k_ext, v_ext, k_glo, v_glo, bias, g, out, mask_rows, lse,
                           num_heads: int):
    """Halo-input attention backward from the forward's ``out`` and ``lse``:
    returns (dq, dk_ext, dv_ext, dk_glo, dv_glo, dbias), None where the
    operand is; dk_ext and dv_ext have the halo rows. On a CUDA device this
    launches the hand-written kernels (or raises); the bf16 ones take
    δ = rowsum(g ∘ out). On the CPU it runs the plain version, which
    recomputes the softmax and reads neither ``out`` nor ``lse``."""
    check_operands(q, k_ext, v_ext, k_glo, v_glo, bias, mask_rows, num_heads, halo=True)
    check_grad_operands(q, g, lse, num_heads, out, takes_out=True)
    if q.device.type == "cpu":
        return vil_attention_halo_bwd_reference(q, k_ext, v_ext, k_glo, v_glo, bias, g,
                                                mask_rows, num_heads)
    if q.dtype == torch.bfloat16:  # the tensor-core kernels
        _check_aligned(q, k_ext, v_ext, k_glo, v_glo, g, out)
    grads = launch_bwd("vil_attention_halo_bwd", 9, q, k_ext, v_ext, k_glo, v_glo, bias, g,
                       mask_rows, lse, num_heads, out=out)
    vil_attention_halo_bwd.launches += 1
    return grads


vil_attention_halo_bwd.launches = 0


class VilAttentionHaloFunction(torch.autograd.Function):
    """Halo-input attention with the hand-written backward: the forward keeps
    its output and per-row log-sum-exp, the backward launches
    :func:`vil_attention_halo_bwd` from them and returns dk_ext, dv_ext with
    the halo rows."""

    @staticmethod
    def forward(ctx, q, k_ext, v_ext, k_glo, v_glo, bias, mask_rows, num_heads):
        out, lse = vil_attention_halo_fwd(q, k_ext, v_ext, k_glo, v_glo, bias, mask_rows,
                                          num_heads, with_lse=True)
        ctx.save_for_backward(q, k_ext, v_ext, k_glo, v_glo, bias, mask_rows, out, lse)
        ctx.num_heads = num_heads
        return out

    @staticmethod
    def backward(ctx, g):
        q, k_ext, v_ext, k_glo, v_glo, bias, mask_rows, out, lse = ctx.saved_tensors
        grads = vil_attention_halo_bwd(q, k_ext, v_ext, k_glo, v_glo, bias, g.contiguous(),
                                       out, mask_rows, lse, ctx.num_heads)
        return (*grads, None, None)


def vil_attention_halo(q, k_ext, v_ext, k_glo, v_glo, bias, mask_rows,
                       num_heads: int) -> torch.Tensor:
    """Halo-input attention through the kernels: the forward alone where no
    gradient is needed, else :class:`VilAttentionHaloFunction`."""
    operands = (q, k_ext, v_ext, k_glo, v_glo, bias)
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in operands):
        return VilAttentionHaloFunction.apply(q, k_ext, v_ext, k_glo, v_glo, bias, mask_rows,
                                              num_heads)
    return vil_attention_halo_fwd(q, k_ext, v_ext, k_glo, v_glo, bias, mask_rows, num_heads)
