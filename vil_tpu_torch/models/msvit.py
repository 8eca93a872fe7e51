"""MsViT: multi-stage vision transformer, inference slice.

Counterpart of ``vil_tpu/models/msvit.py``. Stages of conv patch embedding
(factorised APE, global tokens) followed by pre-LN attention and MLP blocks,
selected per stage by the ARCH string. Images are NHWC.

Ported: ``longformerhand`` (and its aliases) at neighbour mode 0 with shared
weights and any SW_EXACT, ``full`` attention, APE. Not ported yet, and
refused at construction: RPE (``a0``), MODE≠0, ``only_glo``, ``sharew=False``
and the other attention families. Dropout and stochastic depth raise in
training mode.

Sub-modules carry the flax module names (``stage1_patch_embed``,
``stage3_block0_attn``, ``stage2_block1_mlp``, ``norm``, ``head``), so the
parameters of ``vil_tpu``'s MsViT load with ``utils.jax_import``.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
from torch import nn

from ..ops import sliding_chunk as sc
from .arch import StageCfg, parse_arch
from .attention import FullAttention, VilAttention
from .layers import DropPath, Mlp, PatchEmbed

LONGFORMER_TYPES = ("longformerhand", "longformerauto", "longformer_cuda")


class AttnBlock(nn.Module):
    """Pre-LN attention block with a DropPath residual. Takes a (B, N, C)
    token tensor, or the chunked pair (x_glo | None, x_img)."""

    def __init__(self, dim: int, num_heads: int, attn_type: str, nglo: int = 1,
                 w: int = 7, drop: float = 0.0,
                 attn_drop: float = 0.0, drop_path: float = 0.0,
                 sw_exact: int = 0, ln_eps: float = 1e-6,
                 use_kernels: bool = True, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.norm = nn.LayerNorm(dim, eps=ln_eps, **kw)
        common = dict(dim=dim, num_heads=num_heads,
                      attn_drop=attn_drop, proj_drop=drop,
                      use_kernels=use_kernels, **kw)
        if attn_type == "full":
            self.attn = FullAttention(**common)
        elif attn_type in LONGFORMER_TYPES:
            self.attn = VilAttention(w=w, nglo=nglo, exact=sw_exact, **common)
        else:
            raise NotImplementedError(f"attention type {attn_type!r} is not ported")
        self.droppath = DropPath(drop_path)

    def forward(self, x, nx: int, ny: int):
        if isinstance(x, tuple):
            x_glo, x_img = x
            y_glo, y_img = self.droppath(self.attn(
                (None if x_glo is None else self.norm(x_glo), self.norm(x_img)),
                nx, ny,
            ))
            return None if x_glo is None else x_glo + y_glo, x_img + y_img
        return x + self.droppath(self.attn(self.norm(x), nx, ny))


class MlpBlock(nn.Module):
    """Pre-LN MLP block with a DropPath residual; per token, so it takes a
    token tensor or the chunked pair alike."""

    def __init__(self, dim: int, mlp_ratio: float = 4.0, drop: float = 0.0,
                 drop_path: float = 0.0, ln_eps: float = 1e-6, device=None,
                 dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.norm = nn.LayerNorm(dim, eps=ln_eps, **kw)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), drop=drop, **kw)
        self.droppath = DropPath(drop_path)

    def forward(self, x):
        if isinstance(x, tuple):
            x_glo, x_img = x
            y_glo = None if x_glo is None else self.mlp(self.norm(x_glo))
            y_glo, y_img = self.droppath((y_glo, self.mlp(self.norm(x_img))))
            return None if x_glo is None else x_glo + y_glo, x_img + y_img
        return x + self.droppath(self.mlp(self.norm(x)))


class MsViT(nn.Module):
    """Multi-stage ViT. NHWC RGB images (B, H, W, 3) → (B, num_classes)
    logits (features when ``num_classes`` is 0).

    ``dtype`` is the type of the parameters and of the computation (the JAX
    package keeps f32 parameters and casts them to its compute dtype at use,
    which rounds them the same way). ``use_kernels`` is the twin of
    ``use_pallas``. Weights are drawn by :meth:`init_weights` from
    ``generator``.
    """

    def __init__(self, arch: str, img_size: int = 512, num_classes: int = 1000,
                 drop_rate: float = 0.0, attn_drop_rate: float = 0.0,
                 drop_path_rate: float = 0.0, norm_embed: bool = False,
                 sharew: bool = False, only_glo: bool = False,
                 attn_type: str = "longformerhand", sw_exact: int = 0,
                 mode: int = 0, ln_eps: float = 1e-6, avg_pool: bool = False,
                 input_mean: tuple = (0.485, 0.456, 0.406),
                 input_std: tuple = (0.229, 0.224, 0.225),
                 use_kernels: bool = True, device=None,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        cfgs = parse_arch(arch)
        self.layer_cfgs: list[StageCfg] = cfgs
        self.img_size, self.avg_pool = img_size, avg_pool
        if mode != 0:
            raise NotImplementedError(f"MODE {mode} is not ported (only 0)")
        if only_glo:
            raise NotImplementedError("only_glo is not ported")
        if any(c.rpe for c in cfgs):
            raise NotImplementedError("relative position bias (a0) is not ported")

        depth = sum(c.num_blocks for c in cfgs)
        dprs = np.linspace(0, drop_path_rate, depth)
        self.stage_blocks: list[list[tuple[str, str]]] = []
        self.stage_chunked: list[bool] = []
        i_block = 0
        # 'full' is sticky: every stage after the first s=0 stage is full
        # attention even if it declares s=1 (the reference mutates a shared
        # argument dict)
        sticky_full = False
        for sid, (c, (nx, ny)) in enumerate(zip(cfgs, self.grid_sizes())):
            setattr(self, f"stage{sid + 1}_patch_embed", PatchEmbed(
                patch_size=c.patch_size, nx=nx, ny=ny,
                in_chans=3 if sid == 0 else cfgs[sid - 1].dim,
                embed_dim=c.dim, nglo=c.nglo, norm_embed=norm_embed,
                ape=bool(c.ape), drop_rate=drop_rate, ln_eps=ln_eps,
                input_mean=tuple(input_mean), input_std=tuple(input_std), **kw,
            ))
            sticky_full = sticky_full or not c.is_sparse_attn
            stage_type = "full" if sticky_full else attn_type
            if stage_type in LONGFORMER_TYPES and not sharew:
                raise NotImplementedError("sharew=False is not ported")
            # VIL stages chunkify once at stage entry and keep the
            # (x_glo, x_img chunks) pair through all their blocks
            self.stage_chunked.append(stage_type in LONGFORMER_TYPES and c.num_blocks > 0)
            names = []
            for bid in range(c.num_blocks):
                dpr = float(dprs[i_block])
                i_block += 1
                attn_name = f"stage{sid + 1}_block{bid}_attn"
                mlp_name = f"stage{sid + 1}_block{bid}_mlp"
                setattr(self, attn_name, AttnBlock(
                    dim=c.dim, num_heads=c.num_heads, attn_type=stage_type,
                    nglo=c.nglo, w=c.num_feats, drop=drop_rate,
                    attn_drop=attn_drop_rate, drop_path=dpr, sw_exact=sw_exact,
                    ln_eps=ln_eps, use_kernels=use_kernels, **kw,
                ))
                setattr(self, mlp_name, MlpBlock(
                    dim=c.dim, drop=drop_rate, drop_path=dpr, ln_eps=ln_eps, **kw,
                ))
                names.append((attn_name, mlp_name))
            self.stage_blocks.append(names)
        self.norm = nn.LayerNorm(cfgs[-1].dim, eps=ln_eps, **kw)
        self.head = nn.Linear(cfgs[-1].dim, num_classes, **kw) if num_classes > 0 else None
        self.init_weights(generator)

    def grid_sizes(self) -> list[tuple[int, int]]:
        """(nx, ny) token grid of each stage."""
        sizes = []
        nx = ny = self.img_size
        for c in self.layer_cfgs:
            nx //= c.patch_size
            ny //= c.patch_size
            sizes.append((nx, ny))
        return sizes

    @torch.no_grad()
    def init_weights(self, generator: Optional[torch.Generator] = None) -> None:
        """Draw every parameter as the flax modules initialise theirs: dense
        weights, global tokens and position embeddings truncated-normal with
        σ = 0.02 (cut at ±2σ), conv weights LeCun-normal, biases 0, LayerNorm
        scales 1. Values are drawn in f32 on the CPU from ``generator`` and
        then copied, so one seed gives the same weights on any device."""

        def trunc_normal_(p, std):
            t = torch.empty(p.shape, dtype=torch.float32)
            nn.init.trunc_normal_(t, std=std, a=-2 * std, b=2 * std, generator=generator)
            p.copy_(t)

        for mod in self.modules():
            if isinstance(mod, nn.Linear):
                trunc_normal_(mod.weight, 0.02)
            elif isinstance(mod, nn.Conv2d):
                fan_in = mod.in_channels * math.prod(mod.kernel_size)
                # flax lecun_normal: unit variance after truncation at ±2σ
                trunc_normal_(mod.weight, math.sqrt(1.0 / fan_in) / 0.87962566103423978)
            elif isinstance(mod, nn.LayerNorm):
                mod.weight.fill_(1.0)
            elif isinstance(mod, PatchEmbed):
                for name in ("cls_token", "cls_pos_embed", "x_pos_embed", "y_pos_embed"):
                    if hasattr(mod, name):
                        trunc_normal_(getattr(mod, name), 0.02)
            if isinstance(mod, (nn.Linear, nn.Conv2d, nn.LayerNorm)) and mod.bias is not None:
                mod.bias.zero_()

    def forward_features(self, x: torch.Tensor) -> torch.Tensor:
        B = x.shape[0]
        grids = self.grid_sizes()
        nglos = [c.nglo for c in self.layer_cfgs]
        for sid, names in enumerate(self.stage_blocks):
            nx, ny = grids[sid]
            if sid > 0:
                # strip the global tokens, tokens → image grid (NHWC)
                prev_nx, prev_ny = grids[sid - 1]
                x = x[:, nglos[sid - 1]:].reshape(B, prev_nx, prev_ny, -1)
            x = getattr(self, f"stage{sid + 1}_patch_embed")(x)
            chunked = self.stage_chunked[sid]
            if chunked:
                g, w_s = nglos[sid], self.layer_cfgs[sid].num_feats
                x = (x[:, :g] if g > 0 else None,
                     sc.chunkify(x[:, g:], nx, ny, w_s))
            for attn_name, mlp_name in names:
                x = getattr(self, attn_name)(x, nx, ny)
                x = getattr(self, mlp_name)(x)
            if chunked:
                x_glo, x_img = x
                loc = sc.unchunkify(x_img, nx, ny, w_s)
                x = loc if x_glo is None else torch.cat([x_glo, loc], dim=1)
        x = self.norm(x)
        if nglos[-1] > 0 and not self.avg_pool:
            return x[:, 0]
        return x.mean(dim=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, H, W, C) NHWC images → (B, num_classes) logits."""
        feats = self.forward_features(x)
        return feats if self.head is None else self.head(feats)
