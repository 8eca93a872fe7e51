"""Spatial (chunk-row) parallelism of the 2-D sliding-chunk attention.

Counterpart of ``vil_tpu/parallel/spatial.py``. The chunk-row axis ``mx`` of
the stage-resident (B, mx, my, W², C) layout is split over the ranks of a
process group (the *spatial* group): rank r holds rows [lo_r, hi_r). The
whole model's split is chunk-aligned (:func:`row_split`): the image is cut
at multiples of one chunk row of every chunked stage, so each rank holds
whole chunk rows at every stage, and a rank count that does not divide the
chunk rows gives the first ranks one block more; the chunk grid's pad rows
lie at the bottom of the last rank's rows. The unsharded tier gathers each
chunk's 3×3 neighbours by cyclic rolls and kills wrapped-around neighbours
with the mask tables; under the split the same gather is a cyclic exchange
of one-chunk-row halos with the neighbouring ranks (:func:`halo_rows`),
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

Gradients: every rank holds a *partial* gradient of every value that is the
same on every rank (a parameter, a global token, the logits), and the whole
gradient of what it alone holds (its rows). The ranks' partials sum to the
unsharded gradient. One parameter meets both kinds of data: in a chunked
stage the same weights act on the global tokens, alike on every rank, and
on this rank's rows, so its gradient is a share of the first and the rows'
part of the second, and one sum over the group makes it whole. The
collectives are written to keep this:

* a loss computed alike on every rank is seeded with 1/D
  (``train.engine.TrainStep``); a loss summed over the ranks from their
  rows needs no scale;
* a replicated value meets this rank's rows as it is: identity both ways;
* :func:`reduce_sum` (partial sums → their total on every rank) sums the
  partial gradients of the total back over the group;
* the gather of the rows (the first dense stage) sums the partial gradient
  of the gathered tensor over the group and keeps this rank's rows;
* the halo exchange's backward sends each halo's gradient back to the rank
  that owns the row, the transpose of JAX's ``ppermute``.

After the backward, one all-reduce of the parameters' gradients over the
group (with the data replicas: ``parallel.mesh.average_gradients``) gives
every rank the unsharded gradient. :func:`reduce_sum` computes what
``torch.distributed.nn.functional.all_reduce`` computes, backward included;
the port keeps its own, so that every collective's rule stands in this
file.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from ..ops import sliding_chunk as sc
from ..ops.kernels.vil_attention import neighbourhood_attention
from ..ops.kernels.vil_attention_halo import halo_neighborhood, vil_attention_halo
from ..ops.kernels.vil_mode_attention import vil_mode_attention
from ..ops.kernels.vil_mode_attention_halo import (
    halo_sampled_neighborhood,
    vil_mode_attention_halo,
)
from .collectives import get_rank, get_world_size, is_distributed

Span = tuple[int, int]  # [first, last) rows along the split axis


@dataclass(frozen=True)
class RowSplit:
    """A chunk-aligned split of an image's rows over the ranks of a group
    (:func:`row_split`). ``image[r]`` is rank r's [first, last) input rows;
    for each chunked stage s (0-based, in order) ``tokens[s][r]`` its token
    rows and ``chunks[s][r]`` its chunk rows, the last rank's holding the
    chunk grid's pad rows."""

    image: tuple[Span, ...]
    tokens: tuple[tuple[Span, ...], ...]
    chunks: tuple[tuple[Span, ...], ...]


def row_split(img_rows: int, patches: Sequence[int], windows: Sequence[int],
              size: int) -> RowSplit:
    """Split ``img_rows`` input rows over ``size`` ranks so that every rank
    holds whole chunk rows at every chunked stage: stage s has patch
    ``patches[s]`` (on the previous stage's grid) and window ``windows[s]``,
    for the stages from the first to the last chunked one. The cuts fall at
    multiples of the least common multiple of the stages' chunk rows in input
    rows (W_s · the product of the patches up to s), and the blocks go as
    evenly as they can, the first ranks taking one more: ViL-Small 1024²
    (patches 4, 2; W 7, 7: a block of 56 rows, 19 blocks) over 4 ranks holds
    5, 5, 5, 4 blocks, 280, 280, 280, 184 rows. Raises ``ValueError``,
    naming the stage, when a rank would hold no token row of some stage."""
    unit, cum, cums = 1, 1, []
    for p, w in zip(patches, windows):
        cum *= p
        cums.append(cum)
        unit = math.lcm(unit, w * cum)
    blocks = -(-img_rows // unit)
    base, extra = divmod(blocks, size)
    starts = [r * base + min(r, extra) for r in range(size + 1)]
    image = tuple((starts[r] * unit, min(starts[r + 1] * unit, img_rows)) for r in range(size))
    tokens, chunks = [], []
    for s, (cum, w) in enumerate(zip(cums, windows)):
        rows = tuple((lo // cum, hi // cum) for lo, hi in image)
        for r, (lo, hi) in enumerate(rows):
            if hi <= lo:
                raise ValueError(
                    f"spatial parallelism over {size} ranks leaves rank {r} no row of stage "
                    f"{s + 1}: the image's {img_rows} rows split into {blocks} blocks of "
                    f"{unit} (a whole chunk row of every chunked stage), fewer than the ranks")
        tokens.append(rows)
        chunks.append(tuple((lo // w, -(-hi // w)) for lo, hi in rows))
    return RowSplit(image, tuple(tokens), tuple(chunks))


@dataclass(frozen=True)
class SpatialContext:
    """This rank's place in a spatial group: rank ``rank`` of ``size``.
    ``span`` is this rank's [first, last) rows of the layout at hand (a
    chunked stage's chunk rows of the model's :func:`row_split`, set by the
    model for each stage with :meth:`at`)."""

    group: Optional[dist.ProcessGroup]
    size: int
    rank: int
    span: Optional[Span] = None

    @classmethod
    def of(cls, group=None) -> "SpatialContext":
        return cls(group, get_world_size(group), get_rank(group))

    def at(self, span: Span) -> "SpatialContext":
        """This context with this rank's rows of another layout."""
        return replace(self, span=tuple(span))

    def rows(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """This rank's rows of ``t`` along ``dim``: its ``span``."""
        lo, hi = self.span
        return t.narrow(dim, lo, hi - lo)

    def gather_rows(self, t: torch.Tensor, counts: Sequence[int], dim: int = 1) -> torch.Tensor:
        """Every rank's rows of ``t`` along ``dim``, in rank order; rank r
        holds ``counts[r]`` of them."""
        if not is_distributed():
            return t
        return _GatherRows.apply(t, tuple(counts), dim, self.group)


# ---------------------------------------------------------------- collectives

def _all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    out = t.contiguous().clone()
    dist.all_reduce(out, group=group)
    return out


class _ReduceSum(torch.autograd.Function):
    """Sum over the group forward; the backward sums the partial gradients
    of the total over the group."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return _all_reduce(t, group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _GatherRows(torch.autograd.Function):
    """All-gather of unequal row blocks along ``dim`` forward: each block
    padded to the largest, gathered, trimmed. The backward sums the partial
    gradient of the gathered tensor over the group and keeps this rank's
    rows."""

    @staticmethod
    def forward(ctx, t, counts, dim, group):
        rank, most = dist.get_rank(group), max(counts)
        if t.shape[dim] != counts[rank]:
            raise ValueError(f"rank {rank} holds {t.shape[dim]} rows, the split says "
                             f"{counts[rank]}")
        pad = list(t.shape)
        pad[dim] = most - counts[rank]
        block = torch.cat([t, t.new_zeros(pad)], dim=dim).contiguous()
        parts = [torch.empty_like(block) for _ in counts]
        dist.all_gather(parts, block, group=group)
        ctx.dim, ctx.group = dim, group
        ctx.first, ctx.count = sum(counts[:rank]), counts[rank]
        return torch.cat([p.narrow(dim, 0, n) for p, n in zip(parts, counts)], dim=dim)

    @staticmethod
    def backward(ctx, g):
        whole = _all_reduce(g, ctx.group)
        return whole.narrow(ctx.dim, ctx.first, ctx.count), None, None, None


def _local(ctx: Optional[SpatialContext]) -> bool:
    """No split: the unsharded model (``ctx`` None), or no process group."""
    return ctx is None or not is_distributed()


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
    there the exchange is a copy. Gloo's point-to-point reads and writes host
    memory, so card tensors (ranks sharing a card over gloo) pass through the
    host."""
    d, r = dist.get_world_size(group), dist.get_rank(group)
    if d == 1 and dist.get_backend(group) != "nccl":
        return to_next.clone(), to_prev.clone()
    g = dist.group.WORLD if group is None else group
    nxt, prv = (dist.get_global_rank(g, (r + 1) % d), dist.get_global_rank(g, (r - 1) % d))
    device = to_next.device
    staged = device.type != "cpu" and dist.get_backend(group) == "gloo"
    if staged:
        to_next, to_prev = to_next.cpu(), to_prev.cpu()
    to_next, to_prev = to_next.contiguous(), to_prev.contiguous()
    from_prev, from_next = torch.empty_like(to_next), torch.empty_like(to_prev)
    ops = [dist.P2POp(dist.isend, to_next, nxt, group, 0),
           dist.P2POp(dist.isend, to_prev, prv, group, 1),
           dist.P2POp(dist.irecv, from_prev, prv, group, 0),
           dist.P2POp(dist.irecv, from_next, nxt, group, 1)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    if staged:
        return from_prev.to(device), from_next.to(device)
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

    t: (B, mxs, my, W², C) this rank's rows (any count of one or more; the
    ranks of a ragged split hold different counts). Returns (top, bot), each
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
    top, bot = halo_rows(t, group)
    ext = torch.cat([top, t, bot], dim=1)  # (B, mxs+2, my, W², M)
    return halo_neighborhood(ext) if mode == 0 else halo_sampled_neighborhood(ext, mode)


def spatial_local_attention(q, k, v, k_glo, v_glo, bias, mask_add, num_heads: int,
                            group=None, mode: int = 0) -> torch.Tensor:
    """The local branch under the row split, plain PyTorch: the unsharded
    ``vil_attention_reference`` (at ``mode``) on this rank's rows.

    q, k, v: (B, mxs, my, W², C) this rank's rows; k_glo, v_glo (B, Nglo, C)
    and bias (H, W², Nglo+K·W²) the same on every rank; mask_add this rank's
    rows (mxs, my, Wq, Nglo+K·W²) of the additive mask table. After the halo
    exchange every query's keys are on the rank, so the softmax needs no
    further communication."""
    return neighbourhood_attention(q, k, v, k_glo, v_glo, bias, mask_add, num_heads,
                                   lambda t: neighborhood_spatial(t, group, mode))


def spatial_local_attention_kernel(q, k, v, k_glo, v_glo, bias, mask_rows, num_heads: int,
                                   group=None, mode: int = 0) -> torch.Tensor:
    """The local branch under the row split through the kernels (their
    plain versions on the CPU). Mode 0: exchange the ±1 chunk-row halos of
    k and v, then the halo kernels B7a/B7b (:func:`vil_attention_halo`) on
    this rank's rows; modes 1..8 (random shift): the same exchange, then the
    sampled-neighbour halo kernels B5h/B6h (:func:`vil_mode_attention_halo`);
    mode −1 (the self chunk alone): no exchange, the self-only B5/B6 on this
    rank's rows as they are. Operands as :func:`spatial_local_attention`.
    The gradients of the halo rows go back through the exchange to the ranks
    that own them. Both halo rows are exchanged at every mode, cyclic as in
    ``vil_tpu``, though a sampled neighbour reads one of them or none."""
    mode = sc.check_mode(mode)
    if mode == -1:
        return vil_mode_attention(q, k, v, k_glo, v_glo, bias, mask_rows, num_heads, -1)
    top_k, bot_k = halo_rows(k, group)
    top_v, bot_v = halo_rows(v, group)
    k_ext = torch.cat([top_k, k, bot_k], dim=1)
    v_ext = torch.cat([top_v, v, bot_v], dim=1)
    if mode == 0:
        return vil_attention_halo(q, k_ext, v_ext, k_glo, v_glo, bias, mask_rows, num_heads)
    return vil_mode_attention_halo(q, k_ext, v_ext, k_glo, v_glo, bias, mask_rows, num_heads,
                                   mode)


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
    s_loc = torch.einsum("bxylhm,bhgm->bxylhg", k6, qg).to(f32)
    s_glo = torch.einsum("bthm,bhgm->bthg", kg4, qg).to(f32)  # (B, Nglo_k, H, Nglo)
    if g2g is not None:
        s_glo = s_glo + g2g.permute(2, 0, 1)[None]
        s_loc = s_loc + g2l0[None, None, None, None]
    if valid is not None:
        s_loc = s_loc.masked_fill(~valid[None, :, :, :, None, None], float("-inf"))
    # the running maximum and denominator: this rank's partials, reduced
    m0 = torch.maximum(reduce_max(s_loc.amax(dim=(1, 2, 3)), spatial),
                       s_glo.detach().amax(dim=1))  # (B, H, Nglo)
    e_loc = torch.exp(s_loc - m0[:, None, None, None])
    e_glo = torch.exp(s_glo - m0[:, None])  # the same on every rank: added once
    den = reduce_sum(e_loc.sum(dim=(1, 2, 3)), spatial) + e_glo.sum(dim=1)
    p_loc = e_loc / den[:, None, None, None]
    p_glo = e_glo / den[:, None]
    x_loc = torch.einsum("bxylhg,bxylhm->bhgm", p_loc.to(dt), v6).to(f32)
    x_glo = torch.einsum("bthg,bthm->bhgm", p_glo.to(dt), vg4).to(f32)
    return reduce_sum(x_loc, spatial) + x_glo
