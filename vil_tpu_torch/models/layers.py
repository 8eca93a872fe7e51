"""Common model layers: typed Linear/Conv/LayerNorm, the kernels' LayerNorm,
Mlp, stochastic depth, patch embedding.

Counterpart of ``vil_tpu/models/layers.py``. Images are NHWC, as in the JAX
package; parameter names follow its flax tree (``proj``, ``norm_embed``,
``cls_token``, ``fc1`` ...), so ``utils.jax_import`` maps one onto the other.

Every layer takes flax's pair of types: its parameters are kept in
``param_dtype`` and cast to ``dtype`` where they are used, and it computes
in ``dtype``. Training keeps f32 parameters under bf16 compute; serving may
store them in bf16, which computes the same function.

Stochastic depth is ported (one draw per sample from an explicit
``torch.Generator``). Dropout is not: a module with a nonzero dropout rate
raises in training mode instead of running as in eval.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.kernels.layer_norm import layer_norm


def check_eval_only(module: nn.Module, rate: float, what: str) -> None:
    """Raise if ``module`` would have to draw random numbers for dropout: a
    nonzero ``rate`` in training mode."""
    if rate and module.training:
        raise NotImplementedError(
            f"{what} (rate {rate}) in training mode is not ported yet"
        )


def _cast(t: Optional[torch.Tensor], dtype: torch.dtype) -> Optional[torch.Tensor]:
    return None if t is None else t.to(dtype)


class Linear(nn.Linear):
    """``nn.Linear`` with parameters in ``param_dtype``, computed in ``dtype``."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 device=None, dtype: torch.dtype = torch.float32,
                 param_dtype: torch.dtype = torch.float32):
        super().__init__(in_features, out_features, bias, device=device, dtype=param_dtype)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return F.linear(x.to(dt), self.weight.to(dt), _cast(self.bias, dt))

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
                 param_dtype: torch.dtype = torch.float32):
        super().__init__(in_channels, out_channels, kernel_size, stride=stride, bias=bias,
                         device=device, dtype=param_dtype)
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
    (erf) otherwise."""

    def __init__(self, in_features: int, hidden_features: int,
                 out_features: Optional[int] = None, drop: float = 0.0,
                 device=None, dtype: torch.dtype = torch.float32,
                 param_dtype: torch.dtype = torch.float32):
        super().__init__()
        kw = dict(device=device, dtype=dtype, param_dtype=param_dtype)
        self.fc1 = Linear(in_features, hidden_features, **kw)
        self.fc2 = Linear(hidden_features, out_features or in_features, **kw)
        self.drop = drop

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        check_eval_only(self, self.drop, "Mlp dropout")
        x = self.fc1(x)
        x = F.gelu(x, approximate="tanh" if x.dtype == torch.bfloat16 else "none")
        return self.fc2(x)


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
        self.embed_dim, self.nglo, self.drop_rate = embed_dim, nglo, drop_rate
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

    def forward(self, x: torch.Tensor, rows: Optional[tuple[int, int]] = None) -> torch.Tensor:
        """``rows`` = (first row, row count) of the patch grid that x covers,
        for a row block of the image (spatial parallelism); the whole grid
        by default. The position embedding adds those rows."""
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
        check_eval_only(self, self.drop_rate, "patch-embedding dropout")
        return x
