"""MsViT: multi-stage vision transformer, inference and training.

Counterpart of ``vil_tpu/models/msvit.py``. Stages of conv patch embedding
(factorised APE, global tokens) followed by pre-LN attention and MLP blocks,
selected per stage by the ARCH string. Images are NHWC.

Ported: ``longformerhand`` (and its aliases) with shared or unshared
(``sharew=False``) global weights, at neighbour mode 0 with any SW_EXACT and
at the sampled-neighbour modes 1..8 of random-shift training (SW_EXACT 0 or
-1), its only-global mode (``only_glo``, in token layout), ``full``
attention, the efficient families of the paper's ablation (``linformer``
with ``share_kv``, ``srformer``, ``performer``: ``models/attention_efficient``),
APE and relative position bias (``a0``: the tables of each block, their bias
passed to the kernels; ``models.precompute_rpe_cache`` for serving),
stochastic depth, and the fused-kernel switches of the JAX package
(``fused_ln``: the block pre-norms through the LayerNorm kernels;
``fused_block``: each sliding-chunk attention at mode 0 as one fused
attention-block kernel pair). Not ported yet: mode -1, which raises when it
is run, and dropout, which raises in training mode.

Spatial (chunk-row) parallelism: ``forward(x, spatial=ctx)``, through
``parallel.spatial_forward``, runs the eval forward with the image's rows
split over a process group. The chunked stages keep their rank's chunk rows
(patch embedding with its rows of the position table, sliding-chunk
attention with halo exchange); the first dense stage gathers the rows, and
it and the stages after it run whole on every rank.

Sub-modules carry the flax module names (``stage1_patch_embed``,
``stage3_block0_attn``, ``stage2_block1_mlp``, ``norm``, ``head``), so the
parameters of ``vil_tpu``'s MsViT load with ``utils.jax_import``.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Union

import numpy as np
import torch
from torch import nn

from ..ops import sliding_chunk as sc
from ..utils.device import resolve_device
from .arch import StageCfg, parse_arch
from .attention import FullAttention, VilAttention
from .attention_efficient import (
    LinformerAttention,
    PerformerAttention,
    SRAttention,
    gaussian_orthogonal_random_matrix,
)
from .layers import DropPath, LayerNorm, Linear, Mlp, PatchEmbed, make_layer_norm

LONGFORMER_TYPES = ("longformerhand", "longformerauto", "longformer_cuda")

# parameter-name substrings excluded from weight decay (vil_tpu/models/msvit.py
# NO_WEIGHT_DECAY_SUBSTRINGS, there matched against '/'-joined flax paths; the
# port's names are the same paths joined by '.'). 'norm' covers norm_embed,
# every block norm and the final norm.
NO_WEIGHT_DECAY_SUBSTRINGS = (
    "pos_embed",
    "cls_token",
    "norm",
    "relative_position",
    "head.bias",
)


class AttnBlock(nn.Module):
    """Pre-LN attention block with a DropPath residual. Takes a (B, N, C)
    token tensor, or the chunked pair (x_glo | None, x_img). ``fused_ln`` takes
    the kernels' LayerNorm for the pre-norm, ``fused_block`` the fused
    attention block for a sliding-chunk attention at mode 0. ``num_feats``,
    the stage's ``f``, is the window of the sliding-chunk attention, the
    feature count of the linformer and the performer and the reduction
    ratio of the srformer, as in the JAX package."""

    def __init__(self, dim: int, num_heads: int, attn_type: str, nglo: int = 1,
                 num_feats: int = 7, rpe: bool = False, wx: int = 14, wy: int = 14,
                 drop: float = 0.0, attn_drop: float = 0.0, drop_path: float = 0.0,
                 sw_exact: int = 0, sharew: bool = True, only_glo: bool = False,
                 share_kv: bool = True, ln_eps: float = 1e-6,
                 use_kernels: bool = True, fused_ln: bool = False,
                 fused_block: bool = False, device=None,
                 dtype: torch.dtype = torch.float32,
                 param_dtype: torch.dtype = torch.float32):
        super().__init__()
        kw = dict(device=device, dtype=dtype, param_dtype=param_dtype)
        self.norm = make_layer_norm(fused_ln, dim, eps=ln_eps, **kw)
        common = dict(dim=dim, num_heads=num_heads, attn_drop=attn_drop, proj_drop=drop, **kw)
        kernels = dict(rpe=rpe, use_kernels=use_kernels)
        if attn_type == "full":
            self.attn = FullAttention(wx=wx, wy=wy, nglo=nglo, **kernels, **common)
        elif attn_type in LONGFORMER_TYPES:
            self.attn = VilAttention(w=num_feats, nglo=nglo, exact=sw_exact, sharew=sharew,
                                     only_glo=only_glo, fused_block=fused_block, **kernels,
                                     **common)
        elif attn_type == "linformer":
            self.attn = LinformerAttention(seq_len=wx * wy + nglo, num_feats=num_feats,
                                           share_kv=share_kv, **common)
        elif attn_type == "srformer":
            self.attn = SRAttention(rratio=num_feats, **common)
        elif attn_type == "performer":
            self.attn = PerformerAttention(nb_features=num_feats, **common)
        else:
            raise ValueError(f"Not supported attention type {attn_type}")
        self.droppath = DropPath(drop_path)

    def forward(self, x, nx: int, ny: int, generator: Optional[torch.Generator] = None,
                mode: int = 0, spatial=None):
        if isinstance(x, tuple):  # sliding-chunk attention, maybe on a rank's rows
            x_glo, x_img = x
            y_glo, y_img = self.droppath(self.attn(
                (None if x_glo is None else self.norm(x_glo), self.norm(x_img)),
                nx, ny, mode, spatial,
            ), generator)
            return None if x_glo is None else x_glo + y_glo, x_img + y_img
        return x + self.droppath(self.attn(self.norm(x), nx, ny, mode), generator)


class MlpBlock(nn.Module):
    """Pre-LN MLP block with a DropPath residual; per token, so it takes a
    token tensor or the chunked pair alike."""

    def __init__(self, dim: int, mlp_ratio: float = 4.0, drop: float = 0.0,
                 drop_path: float = 0.0, ln_eps: float = 1e-6, fused_ln: bool = False,
                 device=None, dtype: torch.dtype = torch.float32,
                 param_dtype: torch.dtype = torch.float32):
        super().__init__()
        kw = dict(device=device, dtype=dtype, param_dtype=param_dtype)
        self.norm = make_layer_norm(fused_ln, dim, eps=ln_eps, **kw)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), drop=drop, **kw)
        self.droppath = DropPath(drop_path)

    def forward(self, x, generator: Optional[torch.Generator] = None):
        if isinstance(x, tuple):
            x_glo, x_img = x
            y_glo = None if x_glo is None else self.mlp(self.norm(x_glo))
            y_glo, y_img = self.droppath((y_glo, self.mlp(self.norm(x_img))), generator)
            return None if x_glo is None else x_glo + y_glo, x_img + y_img
        return x + self.droppath(self.mlp(self.norm(x)), generator)


class MsViT(nn.Module):
    """Multi-stage ViT. NHWC RGB images (B, H, W, 3) → (B, num_classes)
    logits (features when ``num_classes`` is 0).

    ``dtype`` is the type of the computation and of the residual stream,
    ``param_dtype`` that of the parameters, which are cast to ``dtype`` where
    they are used (flax's pair; f32 parameters for training). The model is
    built on ``device``, the CUDA card unless the caller names another
    (``device="cpu"``). ``use_kernels`` is the twin of ``use_pallas``;
    ``fused_ln`` (TPU.FUSED_LN) puts the kernels' LayerNorm in the block
    pre-norms (the patch-embedding and final norms stay plain, as in the JAX
    package), and ``fused_block`` (``VIL_TPU_FUSED_BLOCK=1`` in the JAX
    package) runs each sliding-chunk attention at mode 0 as one fused block:
    projections, attention and output projection.
    Weights are drawn by :meth:`init_weights` from ``generator``. ``mode``
    (MODEL.VIT.MSVIT.MODE) is carried as the flax field is and not read at
    call time: the neighbour mode is an argument of :meth:`forward`.
    """

    def __init__(self, arch: str, img_size: int = 512, num_classes: int = 1000,
                 drop_rate: float = 0.0, attn_drop_rate: float = 0.0,
                 drop_path_rate: float = 0.0, norm_embed: bool = False,
                 sharew: bool = False, only_glo: bool = False,
                 attn_type: str = "longformerhand", share_kv: bool = False, sw_exact: int = 0,
                 mode: int = 0, ln_eps: float = 1e-6, avg_pool: bool = False,
                 input_mean: tuple = (0.485, 0.456, 0.406),
                 input_std: tuple = (0.229, 0.224, 0.225),
                 use_kernels: bool = True, fused_ln: bool = False,
                 fused_block: bool = False, device=None,
                 dtype: torch.dtype = torch.float32,
                 param_dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = dict(device=resolve_device(device), dtype=dtype, param_dtype=param_dtype)
        self.dtype = dtype
        cfgs = parse_arch(arch)
        self.layer_cfgs: list[StageCfg] = cfgs
        self.img_size, self.avg_pool = img_size, avg_pool
        self.mode = mode

        dprs = np.linspace(0, drop_path_rate, self.depth)
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
            # VIL stages chunkify once at stage entry and keep the
            # (x_glo, x_img chunks) pair through all their blocks; the
            # only-global mode runs in token layout
            self.stage_chunked.append(stage_type in LONGFORMER_TYPES and not only_glo
                                      and c.num_blocks > 0)
            names = []
            for bid in range(c.num_blocks):
                dpr = float(dprs[i_block])
                i_block += 1
                attn_name = f"stage{sid + 1}_block{bid}_attn"
                mlp_name = f"stage{sid + 1}_block{bid}_mlp"
                setattr(self, attn_name, AttnBlock(
                    dim=c.dim, num_heads=c.num_heads, attn_type=stage_type,
                    nglo=c.nglo, num_feats=c.num_feats, rpe=c.rpe, wx=nx, wy=ny,
                    drop=drop_rate, attn_drop=attn_drop_rate, drop_path=dpr,
                    sw_exact=sw_exact, sharew=sharew, only_glo=only_glo, share_kv=share_kv,
                    ln_eps=ln_eps, use_kernels=use_kernels, fused_ln=fused_ln,
                    fused_block=fused_block, **kw,
                ))
                setattr(self, mlp_name, MlpBlock(
                    dim=c.dim, drop=drop_rate, drop_path=dpr, ln_eps=ln_eps,
                    fused_ln=fused_ln, **kw,
                ))
                names.append((attn_name, mlp_name))
            self.stage_blocks.append(names)
        self.norm = LayerNorm(cfgs[-1].dim, eps=ln_eps, **kw)
        self.head = Linear(cfgs[-1].dim, num_classes, **kw) if num_classes > 0 else None
        self.init_weights(generator)

    @property
    def depth(self) -> int:
        """Number of attention blocks, dense ones included: the length of a
        per-layer mode vector."""
        return sum(c.num_blocks for c in self.layer_cfgs)

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
        weights, global tokens, position embeddings and relative-position
        tables truncated-normal with σ = 0.02 (cut at ±2σ), conv weights
        LeCun-normal, biases 0, LayerNorm scales 1. Values are drawn in f32 on the CPU from ``generator`` and
        then copied, so one seed gives the same weights on any device. The
        linformer's sequence projections are drawn uniform in ±1/√f, the
        performer's projection buffers anew."""

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
            elif isinstance(mod, (FullAttention, VilAttention)):
                for table in mod.rpe_tables():
                    trunc_normal_(table, 0.02)
            elif isinstance(mod, LinformerAttention):
                bound = mod.num_feats ** -0.5
                for p in (mod.proj_k, mod.proj_v):
                    if p is not None:
                        p.copy_(torch.rand(p.shape, generator=generator) * (2 * bound) - bound)
            elif isinstance(mod, PerformerAttention):
                mod.projection_matrix.copy_(gaussian_orthogonal_random_matrix(
                    *mod.projection_matrix.shape, generator=generator))
            elif isinstance(mod, PatchEmbed):
                for name in ("cls_token", "cls_pos_embed", "x_pos_embed", "y_pos_embed"):
                    if hasattr(mod, name):
                        trunc_normal_(getattr(mod, name), 0.02)
            if isinstance(mod, (nn.Linear, nn.Conv2d, nn.LayerNorm)) and mod.bias is not None:
                mod.bias.zero_()

    def _block_modes(self, mode: Union[int, Sequence[int]]) -> list[int]:
        """The neighbour mode of each attention block, in order: ``mode``
        itself for all of them, or its entries when it is a sequence of
        ``depth`` host ints (one per block, the dense blocks included, which
        ignore theirs). In eval mode every block runs at mode 0."""
        if isinstance(mode, (int, np.integer)):
            modes = [int(mode)] * self.depth
        else:
            modes = [int(m) for m in mode]
            if len(modes) != self.depth:
                raise ValueError(f"expected {self.depth} per-layer modes, got {len(modes)}")
        return modes if self.training else [0] * self.depth

    def check_spatial_split(self, size: int) -> None:
        """Raise unless ``size`` ranks can split the image's rows so that
        every chunked stage gets whole chunk rows: ``size`` must divide the
        chunk rows (mx) of each, with no padded row (the JAX package pads
        under GSPMD; the port does not)."""
        rows = self.img_size  # input rows of the stage
        for sid, (c, (nx, _)) in enumerate(zip(self.layer_cfgs, self.grid_sizes())):
            if not self.stage_chunked[sid]:
                break
            w = c.num_feats
            if rows % (size * c.patch_size) or nx % (size * w):
                raise ValueError(
                    f"spatial parallelism over {size} ranks needs whole chunk rows on every "
                    f"rank: stage {sid + 1} has {nx} token rows in {-(-nx // w)} chunk rows of "
                    f"{w} ({rows} input rows, patch {c.patch_size}); the rank count must "
                    f"divide the chunk rows of every chunked stage, with no padded row")
            rows = nx

    def forward_features(self, x: torch.Tensor,
                         generator: Optional[torch.Generator] = None,
                         mode: Union[int, Sequence[int]] = 0, spatial=None) -> torch.Tensor:
        B = x.shape[0]
        if spatial is not None and self.training:
            raise NotImplementedError("the spatial training step is not ported: spatial "
                                      "parallelism runs the eval forward")
        modes = iter(self._block_modes(mode))
        grids = self.grid_sizes()
        nglos = [c.nglo for c in self.layer_cfgs]
        split = spatial is not None  # x holds this rank's rows of the image
        for sid, names in enumerate(self.stage_blocks):
            nx, ny = grids[sid]
            if sid > 0:
                # strip the global tokens, tokens → image grid (NHWC)
                prev_nx, prev_ny = grids[sid - 1]
                prev_rows = prev_nx // spatial.size if split else prev_nx
                x = x[:, nglos[sid - 1]:].reshape(B, prev_rows, prev_ny, -1)
            chunked = self.stage_chunked[sid]
            if split and not chunked:  # the first dense stage runs whole
                x = spatial.gather_rows(x, dim=1)
                split = False
            rows = (spatial.rank * nx // spatial.size, nx // spatial.size) if split else None
            x = getattr(self, f"stage{sid + 1}_patch_embed")(x, rows)
            nx_here = rows[1] if split else nx
            if chunked:
                g, w_s = nglos[sid], self.layer_cfgs[sid].num_feats
                x = (x[:, :g] if g > 0 else None,
                     sc.chunkify(x[:, g:], nx_here, ny, w_s))
            for attn_name, mlp_name in names:
                x = getattr(self, attn_name)(x, nx, ny, generator, next(modes),
                                             spatial if split else None)
                x = getattr(self, mlp_name)(x, generator)
            if chunked:
                x_glo, x_img = x
                loc = sc.unchunkify(x_img, nx_here, ny, w_s)
                x = loc if x_glo is None else torch.cat([x_glo, loc], dim=1)
        x = self.norm(x)
        if nglos[-1] > 0 and not self.avg_pool:
            return x[:, 0]
        return x.mean(dim=1)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None,
                mode: Union[int, Sequence[int]] = 0, spatial=None) -> torch.Tensor:
        """x: (B, H, W, C) NHWC images → (B, num_classes) logits. In training
        mode stochastic depth draws from ``generator`` (on x's device), and
        ``mode`` is the neighbour mode of every attention block, or a
        sequence of ``depth`` host ints, one per block in order (the dense
        blocks included, which ignore theirs). In eval mode every block runs
        at mode 0. With a ``spatial`` context (``parallel.spatial_forward``)
        x holds this rank's rows of the images (eval only)."""
        feats = self.forward_features(x, generator, mode, spatial)
        return feats if self.head is None else self.head(feats)
