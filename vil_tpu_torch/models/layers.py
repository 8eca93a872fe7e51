"""Common model layers: typed Linear/Conv/LayerNorm, the kernels' LayerNorm,
Mlp, stochastic depth, patch embedding.

Counterpart of ``vil_tpu/models/layers.py``. Images are NHWC, as in the JAX
package; parameter names follow its flax tree (``proj``, ``norm_embed``,
``cls_token``, ``fc1`` ...), so ``utils.jax_import`` maps one onto the other.

Every layer takes flax's pair of types: its parameters are kept in
``param_dtype`` and cast to ``dtype`` where they are used, and it computes
in ``dtype``. Training keeps f32 parameters under bf16 compute; serving may
store them in bf16, which computes the same function.

Linear and Mlp take a tensor-parallel context (``parallel.TensorParallel``):
the Megatron cut, column- and row-parallel, of ``parallel/tensor.py``.

Stochastic depth (one draw per sample) and dropout (one draw per element,
MODEL.VIT.DROP: :class:`Dropout`) draw from the explicit ``torch.Generator``
that the model's forward is given, the training step's, keyed by its seed
and step. Attention dropout (on the softmax probabilities) is not ported:
a module with a nonzero ``attn_drop`` raises in training mode instead of
running as in eval (:func:`check_eval_only`).

Dropout on a split model draws alike. ``vil_tpu`` draws one mask for the
whole tensor and GSPMD shards it, so a rank that holds a :class:`Part` of a
value (its chunk rows under the spatial split, its hidden features under
'tp') draws the whole tensor's mask from the same generator state as the
one-rank model and keeps its part of it; a value that every rank holds
whole (the global tokens, an output after the model group's reduce) takes
the whole mask. Either way the generator ends where the one-rank step
leaves it.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.kernels.layer_norm import layer_norm


def check_eval_only(module: nn.Module, rate: float, what: str) -> None:
    """Raise if ``module`` would have to draw random numbers for attention
    dropout: a nonzero ``rate`` in training mode. No config of ``vil_tpu``
    sets it (its ``build_model`` passes no ``attn_drop_rate``), and its own
    XLA tier is the only one that takes it."""
    if rate and module.training:
        raise NotImplementedError(
            f"{what} (rate {rate}) in training mode is not ported (ROADMAP.md §A, A18)"
        )


@dataclass(frozen=True)
class Part:
    """Where a tensor lies in the whole one that the unsplit model holds:
    for each cut (dim, total, spans), the whole tensor has ``total`` entries
    along ``dim`` and this one holds the [first, last) ``spans`` of them,
    concatenated in order. No cut: the whole tensor."""

    cuts: tuple = ()

    def along(self, dim: int, total: int, *spans: tuple) -> "Part":
        """This part, cut again along ``dim`` (empty spans left out)."""
        return Part(self.cuts + ((dim, total, tuple(s for s in spans if s[1] > s[0])),))

    def whole_shape(self, shape) -> tuple:
        """The shape of the whole tensor of which one of ``shape`` is this part."""
        shape = list(shape)
        for dim, total, spans in self.cuts:
            if sum(hi - lo for lo, hi in spans) != shape[dim]:
                raise ValueError(f"a part of {shape[dim]} along dim {dim}, spans {spans}")
            shape[dim] = total
        return tuple(shape)

    def of(self, whole: torch.Tensor) -> torch.Tensor:
        """This part of the ``whole`` tensor."""
        for dim, total, spans in self.cuts:
            if spans == ((0, total),):
                continue
            pieces = [whole.narrow(dim, lo, hi - lo) for lo, hi in spans]
            whole = pieces[0] if len(pieces) == 1 else torch.cat(pieces, dim)
        return whole


def dropout(x: torch.Tensor, rate: float, generator: Optional[torch.Generator],
            part: Optional[Part] = None) -> torch.Tensor:
    """Inverted dropout, flax's ``nn.Dropout``: each element kept with
    probability 1 - ``rate`` (one uniform draw from ``generator``, on x's
    device) and scaled by 1 / (1 - rate), the others set to 0. With a
    ``part``, x is that part of a whole tensor: the whole tensor's mask is
    drawn, as the unsplit model draws it, and x takes its part."""
    keep = 1.0 - rate
    shape = x.shape if part is None else part.whole_shape(x.shape)
    kept = torch.rand(shape, generator=generator, device=x.device) < keep
    if part is not None:
        kept = part.of(kept)
    return torch.where(kept, x / keep, torch.zeros_like(x))


class Dropout(nn.Module):
    """MODEL.VIT.DROP at one site (``vil_tpu``'s ``nn.Dropout(drop)``):
    :func:`dropout` in training mode at a nonzero rate, the identity
    otherwise. Its forward takes the step's ``generator`` and the
    :class:`Part` of the whole value that x is, on a split model."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None,
                part: Optional[Part] = None):
        if self.rate == 0.0 or not self.training:
            return x
        return dropout(x, self.rate, generator, part)


def _cast(t: Optional[torch.Tensor], dtype: torch.dtype) -> Optional[torch.Tensor]:
    return None if t is None else t.to(dtype)


class Linear(nn.Linear):
    """``nn.Linear`` with parameters in ``param_dtype``, computed in ``dtype``.

    With a tensor-parallel context ``tp`` (``parallel.TensorParallel``) of n
    ranks and a ``cut``, it holds this rank's part of the whole layer: a
    ``"column"`` layer its 1/n of the output features (of each of ``pack``
    packed blocks: q, k, v), a ``"row"`` layer its 1/n of the input features,
    whose partial products are summed over the model group before the bias
    is added once. ``in_features`` and ``out_features`` are the whole
    layer's; :meth:`shards` gives the cut of each parameter."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 device=None, dtype: torch.dtype = torch.float32,
                 param_dtype: torch.dtype = torch.float32, tp=None, cut: str = "",
                 pack: int = 1):
        self.tp, self.cut, self.pack = (tp, cut, pack) if tp is not None else (None, "", 1)
        n = 1 if tp is None else tp.size
        if cut == "column":
            out_features //= n
        elif cut == "row":
            in_features //= n
        elif tp is not None:
            raise ValueError(f"a tensor-parallel Linear is cut 'column' or 'row', not {cut!r}")
        super().__init__(in_features, out_features, bias, device=device, dtype=param_dtype)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if self.cut == "row":  # the partial products summed, then the bias
            y = self.tp.reduce(F.linear(x.to(dt), self.weight.to(dt)))
            return (y if self.bias is None else y + self.bias.float()).to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), _cast(self.bias, dt))

    def shards(self) -> dict:
        """{"weight" / "bias": its ``parallel.tensor.Shard``} of the cut
        parameters (a row layer's bias is whole)."""
        from ..parallel.tensor import Shard

        if self.tp is None:
            return {}
        tp = self.tp
        if self.cut == "row":
            return {"weight": Shard(1, tp.size, tp.rank, tp.group)}
        out = {"weight": Shard(0, tp.size, tp.rank, tp.group, self.pack)}
        if self.bias is not None:
            out["bias"] = Shard(0, tp.size, tp.rank, tp.group, self.pack)
        return out

    def part(self, x: torch.Tensor, part: int, n_parts: int) -> torch.Tensor:
        """Output slice ``part`` of ``n_parts`` equal slices, computed alone so
        that it comes out contiguous (the kernels take contiguous q, k, v)."""
        rows = slice(part * self.out_features // n_parts,
                     (part + 1) * self.out_features // n_parts)
        dt = self.compute_dtype
        return F.linear(x.to(dt), self.weight[rows].to(dt), _cast(self.bias[rows], dt))


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` with parameters in ``param_dtype``, computed in ``dtype``."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, bias: bool = True, device=None,
                 dtype: torch.dtype = torch.float32,
                 param_dtype: torch.dtype = torch.float32, padding: int = 0, groups: int = 1):
        super().__init__(in_channels, out_channels, kernel_size, stride=stride, padding=padding,
                         groups=groups, bias=bias, device=device, dtype=param_dtype)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return self._conv_forward(x.to(dt), self.weight.to(dt), _cast(self.bias, dt))


class LayerNorm(nn.LayerNorm):
    """``nn.LayerNorm`` with parameters in ``param_dtype``, computed in ``dtype``."""

    def __init__(self, dim: int, eps: float = 1e-6, device=None,
                 dtype: torch.dtype = torch.float32,
                 param_dtype: torch.dtype = torch.float32):
        super().__init__(dim, eps=eps, device=device, dtype=param_dtype)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return F.layer_norm(x.to(dt), self.normalized_shape, self.weight.to(dt),
                            self.bias.to(dt), self.eps)


class FusedLayerNorm(LayerNorm):
    """LayerNorm through the hand-written kernels (``ops/kernels/layer_norm``),
    the counterpart of ``vil_tpu``'s ``FusedLayerNorm`` (TPU.FUSED_LN). Its
    parameters are LayerNorm's (``weight``/``bias``, flax's ``scale``/``bias``),
    but it rounds otherwise: γ and β take part in f32, where
    :class:`LayerNorm` casts them to ``dtype`` first, and the result is
    rounded to ``dtype`` once."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x.to(self.compute_dtype).contiguous(), self.weight, self.bias,
                          self.eps)


def make_layer_norm(fused: bool, dim: int, eps: float = 1e-6, device=None,
                    dtype: torch.dtype = torch.float32,
                    param_dtype: torch.dtype = torch.float32) -> LayerNorm:
    """:class:`FusedLayerNorm` when ``fused``, else :class:`LayerNorm`."""
    cls = FusedLayerNorm if fused else LayerNorm
    return cls(dim, eps=eps, device=device, dtype=dtype, param_dtype=param_dtype)


class DropPath(nn.Module):
    """Per-sample stochastic depth; identity in eval or at rate 0.

    Accepts a tensor or the chunked stage pair (x_glo | None, x_img). One
    Bernoulli(1 - rate) draw per sample, from ``generator``, covers every
    part of the pair, so a sample's whole residual branch is kept (and
    scaled by 1/(1 - rate)) or dropped together, as in the JAX package."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def forward(self, x, generator: Optional[torch.Generator] = None):
        if self.rate == 0.0 or not self.training:
            return x
        keep = 1.0 - self.rate
        parts = x if isinstance(x, tuple) else (x,)
        first = next(t for t in parts if t is not None)
        batch = first.shape[0]
        kept = torch.rand(batch, generator=generator, device=first.device) < keep

        def apply(t):
            if t is None:
                return None
            m = kept.reshape((batch,) + (1,) * (t.dim() - 1))
            return torch.where(m, t / keep, torch.zeros_like(t))

        out = tuple(apply(t) for t in parts)
        return out if isinstance(x, tuple) else out[0]


class Mlp(nn.Module):
    """fc1 → GELU → fc2. The GELU follows the input's dtype, as the JAX
    package's follows its compute dtype: tanh-approximate in bf16, exact
    (erf) otherwise. Under 'tp' the hidden features are this rank's columns
    of the whole layer's, and their dropout keeps those columns of the
    whole mask; fc2's output, reduced over the model group, takes it
    whole."""

    def __init__(self, in_features: int, hidden_features: int,
                 out_features: Optional[int] = None, drop: float = 0.0,
                 device=None, dtype: torch.dtype = torch.float32,
                 param_dtype: torch.dtype = torch.float32, tp=None, name: str = "Mlp"):
        super().__init__()
        kw = dict(device=device, dtype=dtype, param_dtype=param_dtype)
        # under a tensor-parallel context: fc1 column-, fc2 row-parallel
        # where the hidden features divide over the model axis
        self.tp = tp if tp is not None and tp.splits(hidden_features, name) else None
        self.fc1 = Linear(in_features, hidden_features, tp=self.tp, cut="column", **kw)
        self.fc2 = Linear(hidden_features, out_features or in_features, tp=self.tp, cut="row",
                          **kw)
        self.drop = Dropout(drop)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None,
                part: Optional[Part] = None) -> torch.Tensor:
        """``part``: the :class:`Part` of the whole tokens that x is (a
        rank's chunk rows under the spatial split), None for all of them."""
        hidden = part
        if self.tp is not None:
            x = self.tp.copy(x)
            h, r = self.fc1.out_features, self.tp.rank  # this rank's columns
            hidden = (part or Part()).along(-1, h * self.tp.size, (r * h, (r + 1) * h))
        x = self.fc1(x)
        x = F.gelu(x, approximate="tanh" if x.dtype == torch.bfloat16 else "none")
        return self.drop(self.fc2(self.drop(x, generator, part=hidden)), generator, part=part)


class PatchEmbed(nn.Module):
    """Strided-conv patch embedding + global (cls) tokens + factorised APE.

    Input NHWC (B, H, W, in_chans), float or uint8; uint8 images are
    normalised on the device with ``input_mean``/``input_std``. Output is
    (B, nglo + nx·ny, C) tokens. The absolute position embedding is split into
    x- and y-halves of the channels, broadcast over the grid.
    """

    def __init__(self, patch_size: int, nx: int, ny: int, in_chans: int,
                 embed_dim: int, nglo: int = 1, norm_embed: bool = True,
                 ape: bool = True, drop_rate: float = 0.0, ln_eps: float = 1e-6,
                 input_mean=(0.485, 0.456, 0.406),
                 input_std=(0.229, 0.224, 0.225), device=None,
                 dtype: torch.dtype = torch.float32,
                 param_dtype: torch.dtype = torch.float32):
        super().__init__()
        kw = dict(device=device, dtype=dtype, param_dtype=param_dtype)
        pkw = dict(device=device, dtype=param_dtype)
        self.patch_size, self.nx, self.ny = patch_size, nx, ny
        self.embed_dim, self.nglo = embed_dim, nglo
        self.pos_drop = Dropout(drop_rate)
        self.compute_dtype = dtype
        self.proj = Conv2d(in_chans, embed_dim, patch_size, stride=patch_size, **kw)
        self.norm_embed = LayerNorm(embed_dim, eps=ln_eps, **kw) if norm_embed else None
        if nglo >= 1:
            self.cls_token = nn.Parameter(torch.zeros(1, nglo, embed_dim, **pkw))
        self.ape = ape
        if ape:
            half = embed_dim // 2
            # (1, 0, C) when nglo is 0, as the flax tree has it
            self.cls_pos_embed = nn.Parameter(torch.zeros(1, nglo, embed_dim, **pkw))
            self.x_pos_embed = nn.Parameter(torch.zeros(1, nx, half, **pkw))
            self.y_pos_embed = nn.Parameter(torch.zeros(1, ny, half, **pkw))
        mean = np.asarray(input_mean, np.float32)
        std = np.asarray(input_std, np.float32)
        self._u8_scale = (1.0 / (255.0 * std)).tolist()
        self._u8_offset = (-mean / std).tolist()

    def forward(self, x: torch.Tensor, rows: Optional[tuple[int, int]] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``rows`` = (first row, row count) of the patch grid that x covers,
        for a row block of the image (spatial parallelism); the whole grid
        by default. The position embedding adds those rows. Dropout after
        it draws from ``generator`` the whole grid's mask and keeps the
        global tokens' and those rows' part."""
        B = x.shape[0]
        dt = self.compute_dtype
        row0, nrows = (0, self.nx) if rows is None else rows
        if x.dtype == torch.uint8:
            scale = torch.tensor(self._u8_scale, dtype=dt, device=x.device)
            offset = torch.tensor(self._u8_offset, dtype=dt, device=x.device)
            x = x.to(dt) * scale + offset
        x = self.proj(x.permute(0, 3, 1, 2))  # NHWC viewed as NCHW
        if tuple(x.shape[2:]) != (nrows, self.ny) or row0 + nrows > self.nx:
            raise ValueError(
                f"Fix input size! patch grid {tuple(x.shape[2:])} != "
                f"{(nrows, self.ny)} (rows {row0}..{row0 + nrows} of {self.nx})"
            )
        x = x.flatten(2).transpose(1, 2)  # (B, nx·ny, C), row-major grid
        if self.norm_embed is not None:
            x = self.norm_embed(x)
        if self.nglo >= 1:
            x = torch.cat([self.cls_token.to(dt).expand(B, -1, -1), x], dim=1)
        if self.ape:
            half = self.embed_dim // 2
            grid = (1, nrows, self.ny, half)
            pos2d = torch.cat(
                [self.x_pos_embed[:, row0:row0 + nrows, None, :].expand(grid),
                 self.y_pos_embed[:, None, :, :].expand(grid)],
                dim=-1,
            ).reshape(1, nrows * self.ny, self.embed_dim)
            x = x + torch.cat([self.cls_pos_embed, pos2d], dim=1).to(dt)
        g, first = self.nglo, self.nglo + row0 * self.ny
        part = None if rows is None else Part().along(
            1, g + self.nx * self.ny, (0, g), (first, first + nrows * self.ny))
        return self.pos_drop(x, generator, part=part)
