"""Spatial parallelism: the chunk rows of the 2-D sliding-chunk attention,
and the row blocks of a convolutional net.

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

A convolutional net (the ResNet zoo) is split in whole blocks of its total
stride (:func:`block_split`, ``ResNet.spatial_split``); each convolution and
pooling layer reads the rows above and below its own that its kernel
reaches (:class:`ConvRows`): a counted, non-cyclic exchange with the
neighbouring ranks, the padding value at the image's edges, where
``vil_tpu`` lets GSPMD split the height of the same XLA convolutions.

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

* a loss computed alike on every rank gives D times its gradient when the
  ranks' partials are summed: the training step divides the sum by D
  (``train.engine.TrainStep``; dividing the sum rather than seeding 1/D
  keeps the scale exact in the gradients' type); a loss summed over the
  ranks from their rows needs no scale;
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


def block_split(rows: int, unit: int, size: int) -> tuple[Span, ...]:
    """``rows`` cut into blocks of ``unit`` (the last one short when
    ``unit`` does not divide them), spread over ``size`` ranks as evenly as
    they go, the first ranks taking one block more: every rank's [first,
    last) rows. A rank may be left none; the callers raise for it."""
    blocks = -(-rows // unit)
    base, extra = divmod(blocks, size)
    starts = [r * base + min(r, extra) for r in range(size + 1)]
    return tuple((starts[r] * unit, min(starts[r + 1] * unit, rows)) for r in range(size))


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
    image = block_split(img_rows, unit, size)
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


def reduce_max(t: torch.Tensor, ctx) -> torch.Tensor:
    """The elementwise maximum over the ranks of ``ctx``'s group (a
    :class:`SpatialContext` or a ``TensorParallel``), without a gradient."""
    t = t.detach()
    if _local(ctx):
        return t
    out = t.contiguous().clone()
    dist.all_reduce(out, op=dist.ReduceOp.MAX, group=ctx.group)
    return out


def _exchange(to_prev: torch.Tensor, to_next: torch.Tensor, n_prev: int, n_next: int,
              dim: int, group, cyclic: bool = False):
    """Point-to-point exchange along ``dim``: send ``to_prev`` to the
    previous rank and ``to_next`` to the next one, receive ``n_prev`` rows
    from the previous rank and ``n_next`` from the next. Returns (from_prev,
    from_next). Not ``cyclic``, the first rank has no previous and the last
    no next, and a message of no rows is not sent (both sides know it: the
    counts come from the split, which every rank holds); ``cyclic``, the
    first rank's previous is the last. Tags tell the directions apart (down
    0, up 1) where next and previous are one rank; NCCL, which ignores
    tags, pairs them in the order posted. A group of one sends to itself
    under NCCL; gloo has no pair to its own rank, so there the cyclic
    exchange is a copy. Gloo's point-to-point reads and writes host memory,
    so card tensors (ranks sharing a card over gloo) pass through the
    host."""
    d, r = dist.get_world_size(group), dist.get_rank(group)
    if cyclic and d == 1 and dist.get_backend(group) != "nccl":
        return to_next.clone(), to_prev.clone()
    g = dist.group.WORLD if group is None else group
    prv = dist.get_global_rank(g, (r - 1) % d) if cyclic or r > 0 else None
    nxt = dist.get_global_rank(g, (r + 1) % d) if cyclic or r + 1 < d else None
    device = to_prev.device
    staged = device.type != "cpu" and dist.get_backend(group) == "gloo"
    host = (lambda t: t.cpu()) if staged else (lambda t: t)

    def empty(n):
        shape = list(to_prev.shape)
        shape[dim] = n
        return torch.empty(shape, dtype=to_prev.dtype, device="cpu" if staged else device)

    from_prev, from_next = empty(n_prev), empty(n_next)
    ops = []
    if nxt is not None and to_next.shape[dim]:
        ops.append(dist.P2POp(dist.isend, host(to_next).contiguous(), nxt, group, 0))
    if prv is not None and to_prev.shape[dim]:
        ops.append(dist.P2POp(dist.isend, host(to_prev).contiguous(), prv, group, 1))
    if prv is not None and n_prev:
        ops.append(dist.P2POp(dist.irecv, from_prev, prv, group, 0))
    if nxt is not None and n_next:
        ops.append(dist.P2POp(dist.irecv, from_next, nxt, group, 1))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return from_prev.to(device), from_next.to(device)


class _HaloExchange(torch.autograd.Function):
    """(top, bot) halos forward; the backward returns each halo's gradient
    to the rank that owns the row and adds it there."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group, ctx.shape = group, t.shape
        return _exchange(t[:, :1], t[:, -1:], 1, 1, 1, group, cyclic=True)

    @staticmethod
    def backward(ctx, g_top, g_bot):
        # g_top belongs to the previous rank's last row, g_bot to the next
        # rank's first
        g_first, g_last = _exchange(g_top, g_bot, 1, 1, 1, ctx.group, cyclic=True)
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


# ------------------------------------------------- convolutions and pooling

def _pad(t: torch.Tensor, n: int, fill: float, dim: int) -> torch.Tensor:
    """``n`` rows of ``fill`` shaped as t's along ``dim``."""
    shape = list(t.shape)
    shape[dim] = n
    return t.new_full(shape, fill)


def _join(pieces: list, t: torch.Tensor, dim: int) -> torch.Tensor:
    """The pieces' concatenation along ``dim`` in t's memory layout: a
    channels-last t (the ResNet's activations) keeps its layout only when
    every piece has it, and an empty piece would drop it."""
    pieces = [p for p in pieces if p.shape[dim]]
    if t.dim() == 4 and not t.is_contiguous() and t.is_contiguous(
            memory_format=torch.channels_last):
        pieces = [p.contiguous(memory_format=torch.channels_last) for p in pieces]
    return torch.cat(pieces, dim=dim)


@dataclass(frozen=True)
class _Halo:
    """What one rank's window of a layer takes: ``pad_top`` rows of the
    padding value, ``take_prev`` rows from the previous rank, its own first
    ``keep`` rows, ``take_next`` rows from the next rank, ``pad_bot`` rows of
    padding; and what it gives: its first ``give_prev`` rows to the previous
    rank, its last ``give_next`` to the next."""

    pad_top: int
    take_prev: int
    keep: int
    take_next: int
    pad_bot: int
    give_prev: int
    give_next: int


class _HaloWindow(torch.autograd.Function):
    """A rank's rows → the window its layer reads (:class:`_Halo`); the
    backward returns each neighbour row's gradient to the rank that owns
    it, added there, and drops the padding's."""

    @staticmethod
    def forward(ctx, t, halo: _Halo, fill: float, dim: int, group):
        ctx.halo, ctx.dim, ctx.group, ctx.rows = halo, dim, group, t.shape[dim]
        n = t.shape[dim]
        from_prev, from_next = _exchange(t.narrow(dim, 0, halo.give_prev),
                                         t.narrow(dim, n - halo.give_next, halo.give_next),
                                         halo.take_prev, halo.take_next, dim, group)
        return _join([_pad(t, halo.pad_top, fill, dim), from_prev, t.narrow(dim, 0, halo.keep),
                      from_next, _pad(t, halo.pad_bot, fill, dim)], t, dim)

    @staticmethod
    def backward(ctx, g):
        h, dim = ctx.halo, ctx.dim
        _, g_prev, g_own, g_next, _ = g.split(
            [h.pad_top, h.take_prev, h.keep, h.take_next, h.pad_bot], dim=dim)
        # the previous rank's rows go back up, the next rank's down; the
        # gradients of this rank's first and last rows come back
        g_first, g_last = _exchange(g_prev, g_next, h.give_prev, h.give_next, dim, ctx.group)
        shape = list(g.shape)
        shape[dim] = ctx.rows
        grad = g.new_zeros(shape)
        grad.narrow(dim, 0, h.keep).add_(g_own)
        grad.narrow(dim, 0, h.give_prev).add_(g_first)
        grad.narrow(dim, ctx.rows - h.give_next, h.give_next).add_(g_last)
        return grad, None, None, None, None


@dataclass(frozen=True)
class ConvRows:
    """The rows of one resolution of a convolutional net whose image is
    split by rows over a spatial group: ``spans[r]`` rank r's [first, last)
    rows of the ``total``, ``ctx`` this rank's place in the group.

    A layer of kernel k, stride s and padding p along the rows computes
    output row o from input rows [o·s − p, o·s − p + k). Rank r computes the
    output rows of its own input rows: [first/s, last/s), the last rank up to
    the whole output's (total + 2p − k)/s + 1 (the first row of every rank
    lies on the stride, as it does when the image is cut at multiples of
    the net's total stride). So its layer reads input rows [first − p,
    last − s − p + k): p rows above its own and k − s − p below, taken from
    the neighbouring ranks, and outside the image the padding value (0 for
    a convolution, −inf for max-pooling), exactly as the unsplit layer pads.
    :meth:`window` builds those rows; the layer then runs with no padding
    along the rows."""

    spans: tuple[Span, ...]
    total: int
    ctx: SpatialContext

    def after(self, k: int, s: int, p: int) -> "ConvRows":
        """Every rank's output rows of a layer (k, s, p). Raises
        ``ValueError`` when a rank's first row is not on the stride."""
        if any(lo % s for lo, _ in self.spans):
            raise ValueError(f"rows {self.spans} are not cut on the stride {s}")
        out = (self.total + 2 * p - k) // s + 1
        last = len(self.spans) - 1
        spans = tuple((lo // s, out if r == last else hi // s)
                      for r, (lo, hi) in enumerate(self.spans))
        return ConvRows(spans, out, self.ctx)

    def _halo(self, r: int, k: int, s: int, p: int) -> tuple[int, int, int, int, int]:
        """Rank r's (pad_top, take_prev, keep, take_next, pad_bot)."""
        (a, b), (o_lo, o_hi) = self.spans[r], self.after(k, s, p).spans[r]
        lo, hi = o_lo * s - p, (o_hi - 1) * s - p + k
        take_prev = a - max(lo, 0)
        take_next = max(0, min(hi, self.total) - b)
        return (max(0, -lo), take_prev, min(b, hi) - a, take_next,
                max(0, hi - max(b, self.total)))

    def window(self, t: torch.Tensor, k: int, s: int, p: int, fill: float = 0.0,
               dim: int = 2) -> torch.Tensor:
        """This rank's rows ``t`` (along ``dim``) → the input rows its
        outputs of the layer (k, s, p) read, the neighbours' halo rows
        exchanged (their gradients sent back in the backward) and the
        image's edges padded with ``fill``. Raises ``ValueError`` when a
        halo is larger than the neighbour's rows."""
        D, r = len(self.spans), self.ctx.rank
        halos = [self._halo(q, k, s, p) for q in range(D)]
        rows = [hi - lo for lo, hi in self.spans]
        for q, (_, above, _, below, _) in enumerate(halos):
            if (q > 0 and above > rows[q - 1]) or (q + 1 < D and below > rows[q + 1]):
                raise ValueError(f"a layer (kernel {k}, stride {s}, padding {p}) on rows "
                                 f"{self.spans} of {self.total} needs more halo rows than a "
                                 f"neighbour of rank {q} holds")
        if t.shape[dim] != rows[r]:
            raise ValueError(f"rank {r} holds {t.shape[dim]} rows, the split says {rows[r]}")
        halo = _Halo(*halos[r], give_prev=halos[r - 1][3] if r > 0 else 0,
                     give_next=halos[r + 1][1] if r + 1 < D else 0)
        if _local(self.ctx) or D == 1 or not any(h[1] or h[3] for h in halos):
            # no neighbour's row (a 1×1 layer reads none): padding alone
            if not (halo.pad_top or halo.pad_bot):
                return t.narrow(dim, 0, halo.keep)
            return _join([_pad(t, halo.pad_top, fill, dim), t.narrow(dim, 0, halo.keep),
                          _pad(t, halo.pad_bot, fill, dim)], t, dim)
        return _HaloWindow.apply(t, halo, fill, dim, self.ctx.group)


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
