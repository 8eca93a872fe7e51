"""Attention modules for MsViT.

Counterpart of ``vil_tpu/models/attention.py`` for the ported path:

* ``FullAttention`` — dense multi-head self-attention, through the dense
  attention kernels (``ops/kernels/full_attention.py``).
* ``VilAttention``  — 2-D sliding-chunk local attention with global tokens,
  on the stage-resident chunked layout. At neighbour mode 0 the
  local branch runs the sliding-chunk kernels (``ops/kernels/vil_attention.py``);
  at modes 1..8 (random-shift training: self + one sampled neighbour chunk)
  the sampled-neighbour kernels (``ops/kernels/vil_mode_attention.py``), and
  at mode -1 (the self chunk alone, ``MsViT(..., mode=-1)``) their self-only
  instances, each mode with its own mask table and relative-position index.
  With ``fused_block`` (the JAX package's ``VIL_TPU_FUSED_BLOCK=1``), mode 0
  runs the query/key/value projections, the attention and the output
  projection as one fused block (``ops/kernels/vil_block.py``) instead. The
  global tokens' dense attention over all tokens is plain PyTorch and does
  not depend on the mode; it takes its gradient from autograd, as the JAX
  package's takes it from XLA.

  Under spatial parallelism (a ``parallel.spatial.SpatialContext``, from
  ``parallel.spatial_forward``) the module holds its rank's chunk rows: the
  local branch exchanges halos and runs the halo-input kernels
  (``ops/kernels/vil_attention_halo.py``; the plain spatial tier with
  ``use_kernels=False``) at mode 0, their sampled-neighbour halo form
  (``ops/kernels/vil_mode_attention_halo.py``) at modes 1..8, and the
  self-only kernels on its rows without an exchange at mode -1; the global
  branch spreads its softmax over the ranks, with shared or unshared
  weights. The fused block has no halo form: a module built with
  ``fused_block`` raises under a spatial context. A module split over a
  model axis as well takes the split's route on its heads: the
  column-parallel projections, the halo exchange of its heads' K and V with
  the same model rank of the neighbouring spatial ranks, the halo kernels
  at its H/n heads, the global branch reduced over the spatial group per
  head, then the row-parallel output projection reduced over the model
  group.

With ``rpe`` (an ``a0`` stage) each module holds the JAX package's
relative-position-bias tables under its names: the local table, and with
global tokens ``g2l`` (2, H, Nglo) and ``g2g`` (H, Nglo, Nglo). The bias is
assembled from them in plain PyTorch, as the JAX package assembles it outside
its kernels, and passed to every kernel as its f32 bias operand: (H, N, N)
for the dense kernels, (H, W², Nglo+9W²) for the sliding-chunk ones and the
fused block, (H, W², Nglo+2W²) for the sampled-neighbour ones, all in front
column order [g2l ‖ local]; g2g and g2l[0] go to the global branch. The
kernels return the bias gradient and autograd carries it back to the tables.
The small sliding-chunk biases are gathered (``table[index]``, whose backward
is ``index_put_(accumulate=True)``: each table row sums its terms in one
fixed order, so two runs give the same bits). The dense bias is built by the
skew assembly (:func:`full_rpe_bias_skew`, the JAX package's default
``_assemble_full_rpe_bias``): the same values as the gather
(:func:`full_rpe_bias`, its plain version) from flips, broadcasts, pads,
reshapes and slices, whose backward is slices and sums, no scatter. In
training it is built inside the dense kernels' autograd Function
(``FullAttentionRPEFunction``), which saves the tables and rebuilds the bias
in the backward instead of saving it: 403 MB a block at ViL-Small 1024²'s
stage 3. :meth:`cache_rpe_bias`
(``models.precompute_rpe_cache``) keeps the mode-0 bias for serving; it is
read only in eval mode where no gradient reaches the tables, and dropped as
soon as a table has changed (a new version or storage: an in-place write,
an optimizer step, a load, ``.to()``). A write through ``.data`` bypasses
the version counter and is not seen.

Tensor parallelism (a ``parallel.TensorParallel`` context of n ranks, the
model's ``tp``): a module whose heads divide by n holds this rank's H/n
heads, with the query/key/value projections column-parallel and the output
projection row-parallel (``parallel/tensor.py``), and calls the same kernels
at H/n heads on C/n channels; its relative-position tables stay whole and it
reads its heads' columns (bias (H/n, ...)). With unshared global weights
(SHARE_W False) ``query_global`` and ``kv_global`` are column-parallel and
``proj_global`` row-parallel too, and the only-global mode runs on the
rank's heads in token layout. One whose heads do not divide computes whole
on every rank. The fused block runs only unsplit: a split module takes the
classic B1/B2 path, as ``vil_tpu`` does on a model axis.

q is scaled by M^-½ before either kernel. With a gradient to take, the
kernels run through their autograd Functions (forward with the log-sum-exp,
then the backward kernel); ``use_kernels=False`` calls the plain versions
directly instead, and autograd differentiates them.
"""
from __future__ import annotations

import logging

import numpy as np
import torch
from torch import nn

from ..ops import masks as masks_lib
from ..ops import rpe as rpe_lib
from ..ops import sliding_chunk as sc
from ..ops.kernels.full_attention import (
    full_attention,
    full_attention_reference,
    full_attention_rpe,
)
from ..ops.kernels.vil_attention import (
    mask_to_additive,
    vil_attention,
    vil_attention_reference,
)
from ..ops.kernels.vil_block import vil_block
from ..ops.kernels.vil_mode_attention import vil_mode_attention, vil_mode_attention_reference
from ..parallel.spatial import (
    global_branch,
    spatial_local_attention,
    spatial_local_attention_kernel,
)
from .layers import Dropout, Linear, check_eval_only


def split_heads(t: torch.Tensor, num_heads: int) -> torch.Tensor:
    """(B, N, C) → (B, H, N, M)."""
    b, n, c = t.shape
    return t.reshape(b, n, num_heads, c // num_heads).transpose(1, 2)


def merge_heads(t: torch.Tensor) -> torch.Tensor:
    """(B, H, N, M) → (B, N, C)."""
    b, h, n, m = t.shape
    return t.transpose(1, 2).reshape(b, n, h * m)


def softmax_max_sub(scores: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Softmax in f32 with the maximum subtracted as a constant to autograd
    (``vil_tpu.models.attention._softmax_max_sub``)."""
    scores = scores.float()
    return torch.softmax(scores - scores.amax(dim=dim, keepdim=True).detach(), dim=dim)


def scores_f32(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """q·kᵀ over the last axis, (..., n, m) × (..., t, m) → (..., n, t) f32:
    the JAX einsum with ``preferred_element_type=float32``."""
    return torch.matmul(q.float(), k.float().transpose(-1, -2))


_INDEX: dict = {}  # (key, device) → int64 index tensor


def _index(device, key: tuple, make) -> torch.Tensor:
    """The index table ``make()`` (numpy) as an int64 tensor on ``device``,
    built once per ``key`` and device, outside inference mode (the gather
    saves it for its backward)."""
    if (key, str(device)) not in _INDEX:
        with torch.inference_mode(False):
            _INDEX[key, str(device)] = torch.from_numpy(make().astype(np.int64)).to(device)
    return _INDEX[key, str(device)]


def gather_table(table: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """table (rows, H) at ``index`` (n, m) → (H, n, m) f32."""
    return table.float()[index].permute(2, 0, 1)


def _with_global(local, g2l, g2g) -> torch.Tensor:
    """The (H, N, N) dense bias from its (H, wx·wy, wx·wy) local part: rows
    of the global queries [g2g ‖ g2l[0]·1], rows of the local ones
    [g2l[1]·1 ‖ local]."""
    if g2l is None:
        return local.contiguous()
    H, nglo, n = g2g.shape[0], g2g.shape[1], local.shape[1]
    g2l = g2l.float()
    glo_rows = torch.cat([g2g.float(), g2l[0][:, :, None].expand(H, nglo, n)], dim=-1)
    loc_rows = torch.cat([g2l[1][:, None, :].expand(H, n, nglo), local], dim=-1)
    return torch.cat([glo_rows, loc_rows], dim=1)


def full_rpe_bias(table, g2l, g2g, wx: int, wy: int) -> torch.Tensor:
    """(H, N, N) f32 dense bias, N = Nglo + wx·wy, by the gather: the plain
    version of :func:`full_rpe_bias_skew` (the JAX package's
    ``RPE_ASSEMBLY=gather``)."""
    local = gather_table(table, _index(table.device, ("full", wx, wy),
                                       lambda: rpe_lib.full_rpe_index(wx, wy)))
    return _with_global(local, g2l, g2g)


def _skew(t: torch.Tensor, n: int) -> torch.Tensor:
    """(..., 2n−1) → (..., n, n) with out[..., i, j] = t[..., i−j+n−1]
    (``vil_tpu.models.attention._skew``): reverse, broadcast to n rows, pad
    one column, reflow the rows with a stride of 2n−1, slice. Its backward
    is slices, pads and a sum over the broadcast rows: no gather, no
    scatter."""
    lead = t.shape[:-1]
    tiled = t.flip(-1).unsqueeze(-2).expand(*lead, n, 2 * n - 1)
    padded = torch.nn.functional.pad(tiled, (0, 1))  # (..., n, 2n)
    flat = padded.reshape(*lead, n * 2 * n)[..., :n * (2 * n - 1)]
    return flat.reshape(*lead, n, 2 * n - 1)[..., n - 1:]


def skew_local_bias(table: torch.Tensor, wx: int, wy: int) -> torch.Tensor:
    """(H, wx·wy, wx·wy) f32 local dense bias from the ((2wx−1)(2wy−1), H)
    table by two nested skews, x then y
    (``vil_tpu.models.attention._skew_local_bias``):
    bias[h, (xi, yi), (xj, yj)] = table[(xi−xj+wx−1)(2wy−1) + yi−yj+wy−1, h],
    the values of the gather."""
    H = table.shape[1]
    t2d = table.float().reshape(2 * wx - 1, 2 * wy - 1, H)
    ax = _skew(t2d.permute(2, 1, 0), wx)  # (H, Y, wx, wx): [h, y, xi, xj]
    ay = _skew(ax.permute(0, 2, 3, 1), wy)  # (H, wx, wx, wy, wy): [h, xi, xj, yi, yj]
    return ay.permute(0, 1, 3, 2, 4).reshape(H, wx * wy, wx * wy)


def full_rpe_bias_skew(table, g2l, g2g, wx: int, wy: int) -> torch.Tensor:
    """(H, N, N) f32 dense bias, N = Nglo + wx·wy, by the skew assembly
    (``vil_tpu.models.attention._assemble_full_rpe_bias``, its default):
    equal to :func:`full_rpe_bias` bit for bit."""
    return _with_global(skew_local_bias(table, wx, wy), g2l, g2g)


def sliding_chunk_rpe_bias(table, g2l, w: int, mode: int = 0) -> torch.Tensor:
    """(H, W², Nglo + K·W²) f32 sliding-chunk bias in the kernels' front
    column order [g2l[1]·1 ‖ local]: K = 9 key chunks at mode 0, the self
    chunk alone at mode -1, [self ‖ sampled] at modes 1..8 (the JAX mode
    kernels take [self ‖ sampled ‖ glo]). Each mode's index is its own
    slice of the 3×3 neighbourhood's (``rpe.sliding_chunk_rpe_index_mode``)."""
    index = _index(table.device, ("chunk", w, sc.check_mode(mode)),
                   lambda: rpe_lib.sliding_chunk_rpe_index_mode(w, mode))
    local = gather_table(table, index)
    if g2l is None:
        return local.contiguous()
    H, w2, nglo = local.shape[0], local.shape[1], g2l.shape[2]
    return torch.cat([g2l[1].float()[:, None, :].expand(H, w2, nglo), local], dim=-1)


class RelativePositionBias:
    """Mixin of the attention modules: the relative-position-bias tables,
    named and shaped as the JAX package's leaves, and the serving cache of
    the mode-0 bias. The host class defines ``_assemble_rpe(mode)``."""

    def _init_rpe(self, rpe: bool, rows: int, num_heads: int, nglo: int, device,
                  param_dtype: torch.dtype, heads: slice = None) -> None:
        self.rpe = rpe
        self.rpe_heads = heads  # this model rank's heads of the tables, or None: all
        self._rpe_cache = None  # (fingerprint of the tables, mode-0 bias)
        new = lambda *shape: nn.Parameter(torch.zeros(*shape, device=device, dtype=param_dtype))
        self.local_relative_position_bias_table = new(rows, num_heads) if rpe else None
        self.g2l_relative_position_bias = new(2, num_heads, nglo) if rpe and nglo else None
        self.g2g_relative_position_bias = new(num_heads, nglo, nglo) if rpe and nglo else None

    def rpe_tables(self) -> list:
        """The tables that exist: the local one, then g2l and g2g."""
        return [t for t in (self.local_relative_position_bias_table,
                            self.g2l_relative_position_bias,
                            self.g2g_relative_position_bias) if t is not None]

    def local_tables(self) -> list:
        """The tables at this model rank's heads (all of them unsplit):
        the local table's columns, g2l's and g2g's head rows."""
        h = self.rpe_heads
        if h is None:
            return self.rpe_tables()
        table, g2l, g2g = (self.local_relative_position_bias_table,
                           self.g2l_relative_position_bias, self.g2g_relative_position_bias)
        return [t for t in (table[:, h] if table is not None else None,
                            g2l[:, h] if g2l is not None else None,
                            g2g[h] if g2g is not None else None) if t is not None]

    def _rpe_fingerprint(self) -> tuple:
        """Each table's storage and version. The cache keeps the storage
        alive, so a new table cannot come to lie at the old address."""
        return tuple((t.detach(), t._version) for t in self.rpe_tables())

    def _rpe_unchanged(self, fingerprint) -> bool:
        tables = self.rpe_tables()
        return len(tables) == len(fingerprint) and all(
            t.data_ptr() == old.data_ptr() and t._version == version and t.dtype == old.dtype
            and t.device == old.device for t, (old, version) in zip(tables, fingerprint))

    @torch.no_grad()
    def cache_rpe_bias(self) -> None:
        """Assemble the mode-0 bias once for serving (no-op without RPE)."""
        if self.rpe:
            with torch.inference_mode(False):
                self._rpe_cache = (self._rpe_fingerprint(), self._assemble_rpe(0))

    def _rpe_served(self, mode: int = 0):
        """The cached bias where it may be served, else None. A cache whose
        tables have changed since it was built is dropped, never served."""
        if self._rpe_cache is None:
            return None
        fingerprint, bias = self._rpe_cache
        if not self._rpe_unchanged(fingerprint):
            self._rpe_cache = None
        elif (mode == 0 and not self.training and not (
                torch.is_grad_enabled() and any(t.requires_grad for t in self.rpe_tables()))):
            return bias
        return None

    def _rpe_bias(self, mode: int = 0):
        """The bias at ``mode``, or None without RPE: the cache where it may
        be served, else assembled from the tables."""
        if not self.rpe:
            return None
        bias = self._rpe_served(mode)
        return self._assemble_rpe(mode) if bias is None else bias


class FullAttention(RelativePositionBias, nn.Module):
    """Dense multi-head self-attention, with ``rpe`` over a wx×wy grid after
    ``nglo`` global tokens. It attends to every token, so it takes the
    neighbour mode of the sliding-chunk blocks and ignores it. With ``rpe``
    and the kernels, the bias is assembled inside
    :func:`full_attention_rpe` (rebuilt in the backward, not saved) unless
    the serving cache applies, as in ``vil_tpu``'s FullAttention."""

    def __init__(self, dim: int, num_heads: int, attn_drop: float = 0.0,
                 proj_drop: float = 0.0, rpe: bool = False, wx: int = 14, wy: int = 14,
                 nglo: int = 1, use_kernels: bool = True, device=None,
                 dtype: torch.dtype = torch.float32,
                 param_dtype: torch.dtype = torch.float32, tp=None, name: str = "FullAttention"):
        super().__init__()
        kw = dict(device=device, dtype=dtype, param_dtype=param_dtype)
        self.tp = tp if tp is not None and tp.splits(num_heads, name) else None
        self.dim, self.head_dim = dim, dim // num_heads
        self.num_heads = num_heads if self.tp is None else num_heads // self.tp.size  # local
        self.attn_drop, self.proj_drop = attn_drop, Dropout(proj_drop)
        self.wx, self.wy, self.nglo = wx, wy, nglo
        self.use_kernels = use_kernels
        self.qkv = Linear(dim, 3 * dim, tp=self.tp, cut="column", pack=3, **kw)
        self.proj = Linear(dim, dim, tp=self.tp, cut="row", **kw)
        self._init_rpe(rpe, (2 * wx - 1) * (2 * wy - 1), num_heads, nglo, device, param_dtype,
                       None if self.tp is None else self.tp.heads(num_heads))

    def _assemble_rpe(self, mode: int) -> torch.Tensor:
        return self._assemble_from(*self.local_tables())

    def _assemble_from(self, table, g2l=None, g2g=None) -> torch.Tensor:
        """The dense bias from the tables ``rpe_tables()`` lists."""
        return full_rpe_bias_skew(table, g2l, g2g, self.wx, self.wy)

    def forward(self, x: torch.Tensor, nx: int, ny: int, mode: int = 0,
                generator=None) -> torch.Tensor:
        check_eval_only(self, self.attn_drop, "attention dropout")
        H = self.num_heads
        if self.rpe and x.shape[1] != self.nglo + self.wx * self.wy:
            raise ValueError("For relative position, N != nglo + wx*wy")
        scale = self.head_dim ** -0.5
        if self.tp is not None:
            x = self.tp.copy(x)
        q = self.qkv.part(x, 0, 3) * scale
        k = self.qkv.part(x, 1, 3)
        v = self.qkv.part(x, 2, 3)
        bias = self._rpe_served() if self.rpe else None
        if self.rpe and bias is None and self.use_kernels:
            # the bias assembled inside the kernels' autograd Function
            out = full_attention_rpe(q, k, v, self._assemble_from, self.local_tables(), H)
        else:
            if self.rpe and bias is None:
                bias = self._assemble_rpe(0)
            attend = full_attention if self.use_kernels else full_attention_reference
            out = attend(q, k, v, bias, H)
        return self.proj_drop(self.proj(out), generator)


class VilAttention(RelativePositionBias, nn.Module):
    """2-D sliding-chunk self-attention with global tokens and shared
    local/global weights, with ``rpe`` over the 3×3 chunk neighbourhood.

    ``forward`` takes and returns the stage-resident chunked pair
    ``(x_glo (B, Nglo, C) | None, x_img (B, mx, my, W², C))``.
    ``exact`` selects the mask semantics (SW_EXACT 1, 0 or -1). The
    neighbour ``mode`` is 0 (the 3×3 chunk neighbourhood), -1 (the self
    chunk alone) or 1..8 (self and the sampled neighbour of random-shift
    training); SW_EXACT 1 has tables for mode 0 alone and raises at the
    others, as in the JAX package. With a ``spatial`` context x_img holds
    this rank's chunk rows of the (nx, ny) grid (the context's ``span``), at
    any mode: modes 0 and 1..8 exchange one-chunk-row halos with the
    neighbouring ranks, mode -1 needs none; with unshared weights
    (SHARE_W False) the global branch's keys and values are projected from
    this rank's rows and reduced over the group as the shared ones are. The
    projection dropout (MODEL.VIT.DROP) follows the output projections of
    both branches, each with its own draw from ``generator``: under the
    split the local branch keeps its rows of the whole grid's mask, and
    both draw whole masks under 'tp', after the model group's reduce. Split
    over a model axis too, the module runs the spatial route at its heads.
    """

    def __init__(self, dim: int, num_heads: int, w: int = 7,
                 attn_drop: float = 0.0, proj_drop: float = 0.0, nglo: int = 1,
                 exact: int = 0, rpe: bool = False, sharew: bool = True,
                 only_glo: bool = False, use_kernels: bool = True,
                 fused_block: bool = False, device=None, dtype: torch.dtype = torch.float32,
                 param_dtype: torch.dtype = torch.float32, tp=None, name: str = "VilAttention"):
        super().__init__()
        kw = dict(device=device, dtype=dtype, param_dtype=param_dtype)
        if only_glo and nglo < 1:
            raise ValueError("Nglo == 0 in the only global mode!")
        self.tp = tp if tp is not None and tp.splits(num_heads, name) else None
        if self.tp is not None and fused_block and use_kernels:
            logging.getLogger(__name__).warning(
                "%s: the fused attention block has no head-split form; a split block runs "
                "the sliding-chunk kernels B1/B2 at its heads", name)
        self.dim, self.w, self.nglo = dim, w, nglo
        self.head_dim = dim // num_heads
        self.num_heads = num_heads if self.tp is None else num_heads // self.tp.size  # local
        self.exact = exact
        self.attn_drop, self.proj_drop = attn_drop, Dropout(proj_drop)
        self.sharew, self.only_glo = sharew, only_glo
        self.use_kernels = use_kernels
        self.fused_block = fused_block and self.tp is None
        tp_kw = dict(tp=self.tp)
        self.query = Linear(dim, dim, cut="column", **tp_kw, **kw)
        self.kv = Linear(dim, 2 * dim, cut="column", pack=2, **tp_kw, **kw)
        self.proj = Linear(dim, dim, cut="row", **tp_kw, **kw)
        if not sharew:  # the global branch's own weights, cut as the shared ones
            self.query_global = Linear(dim, dim, cut="column", **tp_kw, **kw)
            self.kv_global = Linear(dim, 2 * dim, cut="column", pack=2, **tp_kw, **kw)
            self.proj_global = Linear(dim, dim, cut="row", **tp_kw, **kw)
        self._masks: dict = {}  # (nx, ny, mode 0, -1 or 1, device) → additive tables
        self._init_rpe(rpe, (4 * w - 1) ** 2, num_heads, nglo, device, param_dtype,
                       None if self.tp is None else self.tp.heads(num_heads))

    def _assemble_rpe(self, mode: int) -> torch.Tensor:
        table, *rest = self.local_tables()
        return sliding_chunk_rpe_bias(table, rest[0] if rest else None, self.w, mode)

    def _mask(self, nx: int, ny: int, mode: int, device) -> torch.Tensor:
        """Additive f32 mask of ``mode``: (mx, my, Wq, Nglo+9W²) for mode 0,
        (mx, my, 1, Nglo+W²) for mode -1 (the self chunk alone),
        (mx, my, 1, Nglo+2W²) for modes 1..8. Built once per grid and device
        (the model may be cast to bf16; the tables stay f32); the eight
        sampled-neighbour tables are built together, as one stack, and a
        mode ≤ 0 has a table of its own. They are built outside inference
        mode, so that tables first built while serving can be saved for a
        backward later."""
        kind = min(sc.check_mode(mode), 1)  # 0, -1, or 1 for the stack of 1..8
        key = (nx, ny, kind, str(device))
        if key not in self._masks:
            W = self.w
            padx, pady, mx, my = sc.chunk_grid(nx, ny, W)
            if kind <= 0:
                tables = [masks_lib.invalid_mask(mx, my, padx, pady, W, self.exact, mode)]
            else:  # (8, mx·my, 2W²): modes 1..8
                tables = masks_lib.all_mode_masks(mx, my, padx, pady, W, self.exact)
            with torch.inference_mode(False):
                self._masks[key] = [
                    torch.from_numpy(mask_to_additive(t, mx, my, W * W, self.nglo)).to(device)
                    for t in tables
                ]
        return self._masks[key][mode - 1 if kind == 1 else 0]

    def forward(self, x, nx: int, ny: int, mode: int = 0, spatial=None, generator=None,
                part=None):
        """``part``: the ``layers.Part`` of the whole chunk grid that x_img
        holds under the spatial split (its chunk rows), for the local
        branch's projection dropout; the global branch's output is whole on
        every rank."""
        mode = sc.check_mode(mode)
        if self.only_glo:
            return self._forward_only_global(x, nx, ny, generator)
        if spatial is not None and self.fused_block and self.use_kernels:
            raise NotImplementedError("the fused attention block has no halo form: build "
                                      "the model without fused_block for spatial parallelism "
                                      "(ROADMAP.md §A, A12)")
        if mode != 0 and self.exact == 1:
            raise ValueError("SW_EXACT 1 has no mask tables for the sampled-neighbour "
                             "modes 1..8 or the self-only mode -1 (only mode 0)")
        check_eval_only(self, self.attn_drop, "attention dropout")
        x_glo, x_img = x
        if self.tp is not None:  # the input of the column-parallel projections
            x_glo, x_img = self.tp.copy(x_glo), self.tp.copy(x_img)
        B, mx, my, W2, C = x_img.shape
        H, Nglo = self.num_heads, self.nglo
        if (0 if x_glo is None else x_glo.shape[1]) != Nglo:
            raise ValueError(f"expected {Nglo} global tokens")
        scale = self.head_dim ** -0.5

        kg = vg = None
        if Nglo >= 1:
            kg = self.kv.part(x_glo, 0, 2)  # (B, Nglo, C)
            vg = self.kv.part(x_glo, 1, 2)
        mask = self._mask(nx, ny, mode, x_img.device)
        bias = self._rpe_bias(mode)
        if spatial is not None:
            mask = spatial.rows(mask)  # this rank's chunk rows of the table
        if self.fused_block and self.use_kernels and mode == 0:
            # the fused block: projections, attention and output projection
            # from the raw weights, in (in, out) layout and the compute type
            # (wq and bq scale-folded); it returns k and v for the global
            # branch below. Modes -1 and 1..8 take the classic projections,
            # as vil_tpu's use_fused_block needs mode 0
            cd, f32 = self.query.compute_dtype, torch.float32
            w_in = lambda w: w.t().to(cd).contiguous()
            b = lambda t: t.to(f32)
            wkv, bkv = self.kv.weight, self.kv.bias
            x1, k_img, v_img = vil_block(
                x_img.to(cd).contiguous(), w_in(self.query.weight * scale),
                b(self.query.bias * scale), w_in(wkv[:C]), b(bkv[:C]), w_in(wkv[C:]),
                b(bkv[C:]), w_in(self.proj.weight), b(self.proj.bias), kg, vg, bias, mask, H)
        else:
            q_img = self.query(x_img) * scale  # (B, mx, my, W², C)
            k_img = self.kv.part(x_img, 0, 2)
            v_img = self.kv.part(x_img, 1, 2)
            if spatial is not None:
                attend = (spatial_local_attention_kernel if self.use_kernels
                          else spatial_local_attention)
                x1 = attend(q_img, k_img, v_img, kg, vg, bias, mask, H, spatial.group, mode)
            elif mode == 0:
                attend = vil_attention if self.use_kernels else vil_attention_reference
                x1 = attend(q_img, k_img, v_img, kg, vg, bias, mask, H)
            else:  # the self chunk alone (-1) or a sampled neighbour (1..8)
                attend = vil_mode_attention if self.use_kernels else vil_mode_attention_reference
                x1 = attend(q_img, k_img, v_img, kg, vg, bias, mask, H, mode)
            x1 = self.proj(x1)
        x1 = self.proj_drop(x1, generator, part=part)  # after B9a's output projection too
        if Nglo == 0:
            return None, x1

        # global branch: the global queries attend densely over all tokens,
        # their softmax spread over the ranks under the split; pad positions
        # of a padded chunk grid are masked. Unshared weights project the
        # tokens again (the fused block's k and v are the local branch's)
        if not self.sharew:
            kg, vg = self.kv_global.part(x_glo, 0, 2), self.kv_global.part(x_glo, 1, 2)
            k_img, v_img = self.kv_global.part(x_img, 0, 2), self.kv_global.part(x_img, 1, 2)
        valid = None
        if any(sc.chunk_grid(nx, ny, self.w)[:2]):  # the whole grid has pad positions
            valid = torch.from_numpy(masks_lib.chunk_valid(nx, ny, self.w)).to(x_img.device)
            if spatial is not None:
                valid = spatial.rows(valid)
        x0 = self._global(x_glo, k_img, v_img, kg, vg, valid, spatial)
        return self.proj_drop(x0, generator), x1

    def _global(self, x_glo, k_img, v_img, kg, vg, valid=None, spatial=None) -> torch.Tensor:
        """The global branch's output (B, Nglo, C): the queries of
        ``x_glo`` over the keys and values of the global tokens (kg, vg) and
        of the local ones in chunks (k_img, v_img), through the shared
        weights or the ``*_global`` ones."""
        B, Nglo, _ = x_glo.shape
        H, M = self.num_heads, self.head_dim  # this model rank's heads
        query, proj = ((self.query, self.proj) if self.sharew else
                       (self.query_global, self.proj_global))
        qg = (query(x_glo) * M ** -0.5).reshape(B, Nglo, H, M).transpose(1, 2)
        g2g = g2l = None
        if self.g2g_relative_position_bias is not None:
            _, g2l, g2g = self.local_tables()
        x0 = global_branch(qg, k_img, v_img, kg, vg, g2g, None if g2l is None else g2l[0],
                           valid, spatial)
        return proj(x0.transpose(1, 2).to(k_img.dtype).reshape(B, Nglo, H * M))

    def _forward_only_global(self, x: torch.Tensor, nx: int, ny: int,
                             generator=None) -> torch.Tensor:
        """The only-global mode (ONLY_GLOBAL), in token layout (B, Nglo +
        nx·ny, C): the local queries attend to the global keys alone, with
        no relative-position bias (the reference bypasses it there), and the
        global queries densely to every token, through :meth:`_global` with
        the local tokens as one chunk of nx·ny and no pad."""
        check_eval_only(self, self.attn_drop, "attention dropout")
        if isinstance(x, tuple):
            raise ValueError("the only-global mode runs in token layout, not on chunks")
        B, N, _ = x.shape
        H, Nglo = self.num_heads, self.nglo
        if N != Nglo + nx * ny:
            raise ValueError("Global dimension does not match!")
        if self.tp is not None:  # the input of the column-parallel projections
            x = self.tp.copy(x)
        q = split_heads(self.query(x[:, Nglo:]) * self.head_dim ** -0.5, H)
        k, v = self.kv.part(x, 0, 2), self.kv.part(x, 1, 2)  # (B, N, C)
        probs = softmax_max_sub(scores_f32(q, split_heads(k[:, :Nglo], H)))  # (B, H, Nloc, Nglo)
        x1 = self.proj(merge_heads(torch.matmul(probs.to(k.dtype), split_heads(v[:, :Nglo], H))))
        if not self.sharew:
            k, v = self.kv_global.part(x, 0, 2), self.kv_global.part(x, 1, 2)
        loc = lambda t: t[:, Nglo:].reshape(B, 1, 1, N - Nglo, t.shape[-1])
        x0 = self._global(x[:, :Nglo], loc(k), loc(v), k[:, :Nglo], v[:, :Nglo])
        return self.proj_drop(torch.cat([x0, x1], dim=1), generator)
