"""Common model layers: Mlp, stochastic depth, patch embedding.

Counterpart of ``vil_tpu/models/layers.py``. Images are NHWC, as in the JAX
package; parameter names follow its flax tree (``proj``, ``norm_embed``,
``cls_token``, ``fc1`` ...), so ``utils.jax_import`` maps one onto the other.

This slice is inference only: dropout and stochastic depth are not ported, and
a module with a nonzero rate raises in training mode instead of running as in
eval.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


def check_eval_only(module: nn.Module, rate: float, what: str) -> None:
    """Raise if ``module`` would have to draw random numbers: a nonzero
    ``rate`` of dropout or stochastic depth in training mode."""
    if rate and module.training:
        raise NotImplementedError(
            f"{what} (rate {rate}) in training mode is not ported yet"
        )


class DropPath(nn.Module):
    """Per-sample stochastic depth; identity in eval. Accepts a tensor or a
    (x_glo | None, x_img) pair, as the chunked stage layout carries."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def forward(self, x):
        check_eval_only(self, self.rate, "stochastic depth")
        return x


class Mlp(nn.Module):
    """fc1 → GELU → fc2. The GELU follows the input's dtype, as the JAX
    package's follows its compute dtype: tanh-approximate in bf16, exact
    (erf) otherwise."""

    def __init__(self, in_features: int, hidden_features: int,
                 out_features: Optional[int] = None, drop: float = 0.0,
                 device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.fc1 = nn.Linear(in_features, hidden_features, **kw)
        self.fc2 = nn.Linear(hidden_features, out_features or in_features, **kw)
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
                 input_std=(0.229, 0.224, 0.225), device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.patch_size, self.nx, self.ny = patch_size, nx, ny
        self.embed_dim, self.nglo, self.drop_rate = embed_dim, nglo, drop_rate
        self.proj = nn.Conv2d(in_chans, embed_dim, patch_size, stride=patch_size, **kw)
        self.norm_embed = nn.LayerNorm(embed_dim, eps=ln_eps, **kw) if norm_embed else None
        if nglo >= 1:
            self.cls_token = nn.Parameter(torch.zeros(1, nglo, embed_dim, **kw))
        self.ape = ape
        if ape:
            half = embed_dim // 2
            # (1, 0, C) when nglo is 0, as the flax tree has it
            self.cls_pos_embed = nn.Parameter(torch.zeros(1, nglo, embed_dim, **kw))
            self.x_pos_embed = nn.Parameter(torch.zeros(1, nx, half, **kw))
            self.y_pos_embed = nn.Parameter(torch.zeros(1, ny, half, **kw))
        mean = np.asarray(input_mean, np.float32)
        std = np.asarray(input_std, np.float32)
        self._u8_scale = (1.0 / (255.0 * std)).tolist()
        self._u8_offset = (-mean / std).tolist()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B = x.shape[0]
        w = self.proj.weight
        if x.dtype == torch.uint8:
            scale = torch.tensor(self._u8_scale, dtype=w.dtype, device=x.device)
            offset = torch.tensor(self._u8_offset, dtype=w.dtype, device=x.device)
            x = x.to(w.dtype) * scale + offset
        x = self.proj(x.to(w.dtype).permute(0, 3, 1, 2))  # NHWC viewed as NCHW
        if tuple(x.shape[2:]) != (self.nx, self.ny):
            raise ValueError(
                f"Fix input size! patch grid {tuple(x.shape[2:])} != "
                f"{(self.nx, self.ny)}"
            )
        x = x.flatten(2).transpose(1, 2)  # (B, nx·ny, C), row-major grid
        if self.norm_embed is not None:
            x = self.norm_embed(x)
        if self.nglo >= 1:
            x = torch.cat([self.cls_token.expand(B, -1, -1), x], dim=1)
        if self.ape:
            half = self.embed_dim // 2
            grid = (1, self.nx, self.ny, half)
            pos2d = torch.cat(
                [self.x_pos_embed[:, :, None, :].expand(grid),
                 self.y_pos_embed[:, None, :, :].expand(grid)],
                dim=-1,
            ).reshape(1, self.nx * self.ny, self.embed_dim)
            x = x + torch.cat([self.cls_pos_embed, pos2d], dim=1)
        check_eval_only(self, self.drop_rate, "patch-embedding dropout")
        return x
