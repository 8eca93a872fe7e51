"""Spatial (chunk-row) parallelism of the 2-D sliding-chunk attention.

Counterpart of ``vil_tpu/parallel/spatial.py``. The chunk-row axis ``mx`` of
the stage-resident (B, mx, my, W², C) layout is split over the ranks of a
process group (the *spatial* group): rank r of D holds rows
[r·mxs, (r+1)·mxs), mxs = mx / D. The unsharded tier gathers each chunk's
3×3 neighbours by cyclic rolls and kills wrapped-around neighbours with the
mask tables; under the split the same gather is a cyclic exchange of
one-chunk-row halos with the neighbouring ranks (:func:`halo_rows`),
followed by the same local math with this rank's rows of the mask table.
Global-token queries attend to every token, so their softmax is spread over
the ranks: a maximum, the denominators and the P·V partials are reduced over
the group (:func:`spatial_global_branch`).

The JAX functions run inside ``shard_map``; here each function runs on every
rank of the group, on that rank's shard, and communicates through
``torch.distributed``. With no initialised process group it acts as one rank
of one and communicates nothing. A group of one still communicates: its
halos, its own last and first rows as ``jax.lax.axis_size == 1`` gives them,
go through the exchange (sent to itself under NCCL), and its reductions
through the collectives.

Gradients follow ``shard_map``'s rules, written out by hand. A value that is
the same on every rank and meets sharded data enters through
:func:`replicated` (identity forward; the backward sums the ranks' partial
gradients). Partial sums leave through :func:`reduce_sum` (the sum forward;
identity backward, as every rank holds the same result and the same
gradient of it). The halo exchange's backward sends each halo's gradient back
to the rank that owns the row, the transpose of JAX's ``ppermute``. So a loss
computed alike on every rank from replicated outputs, or summed over the
ranks from sharded ones, gives every rank the unsharded gradient of what it
holds: whole for a replicated operand, its rows for a sharded one.
``torch.distributed.nn.functional.all_reduce`` is not used: its backward sums
the upstream gradients over the ranks, which counts a replicated loss D
times.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
import torch.distributed as dist

from ..ops import sliding_chunk as sc
from ..ops.kernels.vil_attention import neighbourhood_attention
from ..ops.kernels.vil_attention_halo import halo_neighborhood, vil_attention_halo
from .collectives import get_rank, get_world_size, is_distributed


@dataclass(frozen=True)
class SpatialContext:
    """This rank's place in a spatial group: rank ``rank`` of ``size`` holds
    the ``rank``-th of ``size`` equal row blocks of every split tensor."""

    group: Optional[dist.ProcessGroup]
    size: int
    rank: int

    @classmethod
    def of(cls, group=None) -> "SpatialContext":
        return cls(group, get_world_size(group), get_rank(group))

    def rows(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """This rank's block of ``t`` along ``dim``."""
        n = t.shape[dim] // self.size
        if n * self.size != t.shape[dim]:
            raise ValueError(f"{t.shape[dim]} rows do not split over {self.size} ranks")
        return t.narrow(dim, self.rank * n, n)

    def gather_rows(self, t: torch.Tensor, dim: int = 1) -> torch.Tensor:
        """Every rank's block of ``t`` along ``dim``, in rank order."""
        if not is_distributed():
            return t
        return _GatherRows.apply(t, dim, self.group)


# ---------------------------------------------------------------- collectives

class _Replicated(torch.autograd.Function):
    """Identity forward; the backward sums the gradient over the group."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceSum(torch.autograd.Function):
    """Sum over the group forward; identity backward."""

    @staticmethod
    def forward(ctx, t, group):
        out = t.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherRows(torch.autograd.Function):
    """All-gather along ``dim`` forward; the backward keeps this rank's block
    of the (replicated) gradient."""

    @staticmethod
    def forward(ctx, t, dim, group):
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, t, group=group)
        ctx.dim, ctx.rows, ctx.rank = dim, t.shape[dim], dist.get_rank(group)
        return torch.cat(parts, dim=dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.rank * ctx.rows, ctx.rows), None, None


def _local(ctx: Optional[SpatialContext]) -> bool:
    """No split: the unsharded model (``ctx`` None), or no process group."""
    return ctx is None or not is_distributed()


def replicated(t: Optional[torch.Tensor], ctx: Optional[SpatialContext]):
    """``t``, the same on every rank, where it meets sharded data."""
    if t is None or _local(ctx):
        return t
    return _Replicated.apply(t, ctx.group)


def reduce_sum(t: torch.Tensor, ctx: Optional[SpatialContext]) -> torch.Tensor:
    """The sum of every rank's partial ``t``, on every rank."""
    return t if _local(ctx) else _ReduceSum.apply(t, ctx.group)


def reduce_max(t: torch.Tensor, ctx: Optional[SpatialContext]) -> torch.Tensor:
    """The elementwise maximum over the ranks, without a gradient."""
    t = t.detach()
    if _local(ctx):
        return t
    out = t.contiguous().clone()
    dist.all_reduce(out, op=dist.ReduceOp.MAX, group=ctx.group)
    return out


def _shift(to_next: torch.Tensor, to_prev: torch.Tensor, group):
    """Send ``to_next`` to the next rank and ``to_prev`` to the previous one
    (cyclic); returns (what the previous rank sent on, what the next rank sent
    back). Tags tell the two messages apart where next and previous are one
    rank; NCCL, which ignores tags, pairs them in the order posted. A group
    of one sends to itself under NCCL; gloo has no pair to its own rank, so
    there the exchange is a copy."""
    d, r = dist.get_world_size(group), dist.get_rank(group)
    if d == 1 and dist.get_backend(group) != "nccl":
        return to_next.clone(), to_prev.clone()
    g = dist.group.WORLD if group is None else group
    nxt, prv = (dist.get_global_rank(g, (r + 1) % d), dist.get_global_rank(g, (r - 1) % d))
    to_next, to_prev = to_next.contiguous(), to_prev.contiguous()
    from_prev, from_next = torch.empty_like(to_next), torch.empty_like(to_prev)
    ops = [dist.P2POp(dist.isend, to_next, nxt, group, 0),
           dist.P2POp(dist.isend, to_prev, prv, group, 1),
           dist.P2POp(dist.irecv, from_prev, prv, group, 0),
           dist.P2POp(dist.irecv, from_next, nxt, group, 1)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return from_prev, from_next


class _HaloExchange(torch.autograd.Function):
    """(top, bot) halos forward; the backward returns each halo's gradient
    to the rank that owns the row and adds it there."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group, ctx.shape = group, t.shape
        return _shift(t[:, -1:], t[:, :1], group)

    @staticmethod
    def backward(ctx, g_top, g_bot):
        # g_top belongs to the previous rank's last row, g_bot to the next
        # rank's first
        g_first, g_last = _shift(g_bot, g_top, ctx.group)
        grad = g_top.new_zeros(ctx.shape)
        grad[:, :1] += g_first
        grad[:, -1:] += g_last
        return grad, None


def halo_rows(t: torch.Tensor, group=None):
    """Cyclic one-chunk-row halos over the spatial group.

    t: (B, mxs, my, W², C) this rank's rows. Returns (top, bot), each
    (B, 1, my, W², C): ``top`` is the previous rank's last row, ``bot`` the
    next rank's first row (cyclic, as the unsharded tier's rolls are; the
    masks kill the wrap at the image's edges either way). On a group of one
    they are this rank's own last and first rows, exchanged all the same;
    without a process group, slices."""
    if not is_distributed():
        return t[:, -1:], t[:, :1]
    return _HaloExchange.apply(t, group)


# --------------------------------------------------------------- attention

def neighborhood_spatial(t: torch.Tensor, group=None, mode: int = 0) -> torch.Tensor:
    """``ops.sliding_chunk.neighborhood`` under the row split.

    t: (B, mxs, my, W², M) this rank's rows → (B, mxs, my, K·W², M),
    K ∈ {9, 1, 2} for mode 0, −1, 1..8. Row offsets read from the
    halo-extended rows; column offsets stay local rolls (my is not split)."""
    mode = sc.check_mode(mode)
    if mode == -1:
        return t
    mxs = t.shape[1]
    top, bot = halo_rows(t, group)
    ext = torch.cat([top, t, bot], dim=1)  # (B, mxs+2, my, W², M)
    if mode == 0:
        return halo_neighborhood(ext)
    sx, sy = (int(s) for s in sc.MODE_ROLL_SHIFTS[mode])
    return torch.cat([t, torch.roll(ext[:, 1 - sx:1 - sx + mxs], sy, dims=2)], dim=3)


def spatial_local_attention(q, k, v, k_glo, v_glo, bias, mask_add, num_heads: int,
                            group=None, mode: int = 0) -> torch.Tensor:
    """The local branch under the row split, plain PyTorch: the unsharded
    ``vil_attention_reference`` (at ``mode``) on this rank's rows.

    q, k, v: (B, mxs, my, W², C) this rank's rows; k_glo, v_glo (B, Nglo, C)
    and bias (H, W², Nglo+K·W²) the same on every rank; mask_add this rank's
    rows (mxs, my, Wq, Nglo+K·W²) of the additive mask table. After the halo
    exchange every query's keys are on the rank, so the softmax needs no
    further communication."""
    ctx = SpatialContext.of(group)
    return neighbourhood_attention(
        q, k, v, replicated(k_glo, ctx), replicated(v_glo, ctx),
        replicated(bias, ctx), mask_add, num_heads,
        lambda t: neighborhood_spatial(t, group, mode))


def spatial_local_attention_kernel(q, k, v, k_glo, v_glo, bias, mask_rows, num_heads: int,
                                   group=None) -> torch.Tensor:
    """The local branch under the row split through the halo kernels (B7a,
    B7b; their plain versions on the CPU), mode 0: exchange the ±1 chunk-row
    halos of k and v, then :func:`vil_attention_halo` on this rank's rows.
    Operands as :func:`spatial_local_attention`. The gradients of the halo
    rows go back through the exchange to the ranks that own them."""
    ctx = SpatialContext.of(group)
    top_k, bot_k = halo_rows(k, group)
    top_v, bot_v = halo_rows(v, group)
    k_ext = torch.cat([top_k, k, bot_k], dim=1)
    v_ext = torch.cat([top_v, v, bot_v], dim=1)
    return vil_attention_halo(q, k_ext, v_ext, replicated(k_glo, ctx),
                              replicated(v_glo, ctx), replicated(bias, ctx), mask_rows,
                              num_heads)


def spatial_global_branch(qg, k_img, v_img, k_glo, v_glo, g2g=None, g2l0=None, valid=None,
                          group=None) -> torch.Tensor:
    """:func:`global_branch` with the image's rows split over ``group``
    (the default group when None)."""
    return global_branch(qg, k_img, v_img, k_glo, v_glo, g2g, g2l0, valid,
                         SpatialContext.of(group))


def global_branch(qg, k_img, v_img, k_glo, v_glo, g2g=None, g2l0=None, valid=None,
                  spatial: Optional[SpatialContext] = None) -> torch.Tensor:
    """Global-token queries attending densely over all tokens (the global
    branch of ``models/attention.py``). The local keys stay in chunk order
    (softmax over keys does not care about their order) and the softmax over
    [glo ‖ local] is taken in two parts that share one maximum and one
    denominator; the maximum is a constant to autograd, as under the JAX
    package's stop_gradient. With a ``spatial`` context the image's rows are
    split over its group and the softmax is spread over the ranks: the
    maximum, the denominators and the P·V partials are reduced over the
    group. Without one nothing is reduced, even where a process group
    exists for another purpose.

    qg: (B, H, Nglo, M) and k_glo, v_glo (B, Nglo, C), the same on every
    rank; k_img, v_img (B, mxs, my, W², C) this rank's rows; g2g
    (H, Nglo, Nglo) and g2l0 (H, Nglo) relative-position biases or None;
    valid: this rank's rows (mxs, my, W²) of the real-token mask, or None
    when the grid has no pad. Returns (B, H, Nglo, M) f32, the same on every
    rank."""
    B, mxs, my, w2, C = k_img.shape
    H, nglo, M = qg.shape[1], qg.shape[2], qg.shape[3]
    f32, dt = torch.float32, k_img.dtype
    k6, v6 = k_img.reshape(B, mxs, my, w2, H, M), v_img.reshape(B, mxs, my, w2, H, M)
    kg4, vg4 = k_glo.reshape(B, nglo, H, M), v_glo.reshape(B, nglo, H, M)
    # this rank's key columns, and the global ones every rank holds
    s_loc = torch.einsum("bxylhm,bhgm->bxylhg", k6, replicated(qg, spatial)).to(f32)
    s_glo = torch.einsum("bthm,bhgm->bthg", kg4, qg).to(f32)  # (B, Nglo_k, H, Nglo)
    if g2g is not None:
        s_glo = s_glo + g2g.permute(2, 0, 1)[None]
        s_loc = s_loc + replicated(g2l0, spatial)[None, None, None, None]
    if valid is not None:
        s_loc = s_loc.masked_fill(~valid[None, :, :, :, None, None], float("-inf"))
    # the running maximum and denominator: this rank's partials, reduced
    m0 = torch.maximum(reduce_max(s_loc.amax(dim=(1, 2, 3)), spatial),
                       s_glo.detach().amax(dim=1))  # (B, H, Nglo)
    e_loc = torch.exp(s_loc - m0[:, None, None, None])
    e_glo = torch.exp(s_glo - m0[:, None])  # the same on every rank: added once
    den = reduce_sum(e_loc.sum(dim=(1, 2, 3)), spatial) + e_glo.sum(dim=1)
    p_loc = e_loc / replicated(den, spatial)[:, None, None, None]
    p_glo = e_glo / den[:, None]
    x_loc = torch.einsum("bxylhg,bxylhm->bhgm", p_loc.to(dt), v6).to(f32)
    x_glo = torch.einsum("bthg,bthm->bhgm", p_glo.to(dt), vg4).to(f32)
    return reduce_sum(x_loc, spatial) + x_glo
