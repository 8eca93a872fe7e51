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
stochastic depth and dropout (MODEL.VIT.DROP: after the position embedding,
in the MLPs and after the attention's output projections), the self-only
neighbour mode -1 (``forward(x, mode=-1)``), rematerialisation of the
blocks in training (TPU.REMAT, ``remat``), and the fused-kernel switches of
the JAX package (``fused_ln``: the block pre-norms through the LayerNorm
kernels; ``fused_block``: each sliding-chunk attention at mode 0 as one fused
attention-block kernel pair). Not ported: attention dropout (on the softmax
probabilities, ``attn_drop_rate``), which raises in training mode.

Rematerialisation (TPU.REMAT, ``vil_tpu``'s ``nn.remat`` of each attention
and MLP block): ``'full'`` keeps a block's input alone and recomputes the
block in the backward (``torch.utils.checkpoint``, non-reentrant);
``'minimal'`` keeps the products' outputs too (``aten.mm``, ``addmm``,
``bmm``: a selective-checkpoint policy, ``jax.checkpoint_policies.dots_saveable``'s
counterpart) and recomputes the rest, the kernels' autograd Functions
included, as JAX recomputes ``pallas_call`` outputs. A block's recompute draws
its drop-path and dropout masks again from the generator's state at the
block's entry, so they come out the same (on a split model the same parts
of the whole masks). On a mesh the recompute re-issues the block's
collectives in the forward's order, the same on every rank: a spatial
block's halo exchanges and global-branch all-reduces, a 'tp' block's
model-group all-reduce. 'minimal' recomputes them too (c10d's collectives
write into their inputs in place, so a cached output would leave the
buffer the caller reads unreduced; and ``dots_saveable`` keeps products
alone). Under FSDP the recompute runs the block's gather hook again, which
finds the weights the forward gathered; they are let go only after the
backward. As in ``vil_tpu``, where ``nn.remat`` needs a static mode, a model
with ``remat`` refuses the sampled-neighbour modes 1..8 in training.

Spatial (chunk-row) parallelism: ``forward(x, spatial=ctx)`` runs the
forward, in eval (``parallel.spatial_forward``) or in training (the step of
``train.engine`` on a mesh with a spatial axis), with the image's rows split
over a process group at chunk-row boundaries (:meth:`MsViT.spatial_split`;
a rank count that does not divide the chunk rows gives the last ranks fewer
rows, the last one the pad). The chunked stages keep their rank's chunk rows
(patch embedding with its rows of the position table, sliding-chunk
attention with halo exchange); the first dense stage gathers the rows, and
it and the stages after it run whole on every rank.

Sub-modules carry the flax module names (``stage1_patch_embed``,
``stage3_block0_attn``, ``stage2_block1_mlp``, ``norm``, ``head``), so the
parameters of ``vil_tpu``'s MsViT load with ``utils.jax_import``.
"""
from __future__ import annotations

import math
from functools import partial
from typing import Callable, Optional, Sequence, Union

import numpy as np
import torch
from torch import nn
from torch.utils import checkpoint as torch_checkpoint

from ..ops import sliding_chunk as sc
from ..parallel.spatial import row_split
from ..utils.device import resolve_device
from .arch import StageCfg, parse_arch
from .attention import FullAttention, VilAttention
from .attention_efficient import (
    LinformerAttention,
    PerformerAttention,
    SRAttention,
    gaussian_orthogonal_random_matrix,
)
from .layers import DropPath, LayerNorm, Linear, Mlp, PatchEmbed, Part, make_layer_norm

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


REMAT_POLICIES = ("", "minimal", "full")
# the ops whose outputs TPU.REMAT 'minimal' keeps: the products
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default, torch.ops.aten.bmm.default)


def _dots_saveable(ctx, op, *args, **kwargs):
    """``jax.checkpoint_policies.dots_saveable``: keep the products' outputs,
    recompute everything else, the collectives (c10d's in-place ops) among
    it."""
    policy = torch_checkpoint.CheckpointPolicy
    return policy.MUST_SAVE if op in _DOTS else policy.PREFER_RECOMPUTE


def remat_block(run: Callable, x, remat: str, generator: Optional[torch.Generator]):
    """``run(x)`` (one attention or MLP block) under ``torch.utils.checkpoint``:
    ``remat`` 'full' recomputes the whole block in the backward, 'minimal'
    keeps the products' outputs (:func:`_dots_saveable`). The recompute
    starts ``generator`` from its state at the block's entry and gives it
    back its state after, so the block draws the same masks both times and
    the draws after it are not moved."""
    entry = None if generator is None else generator.get_state()
    calls = []

    def again(x):
        calls.append(None)
        if len(calls) == 1 or entry is None:
            return run(x)
        now = generator.get_state()
        generator.set_state(entry)
        try:
            return run(x)
        finally:
            generator.set_state(now)

    context = (lambda: torch_checkpoint.create_selective_checkpoint_contexts(_dots_saveable)) \
        if remat == "minimal" else torch_checkpoint.noop_context_fn
    return torch_checkpoint.checkpoint(again, x, use_reentrant=False, context_fn=context)


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
                 param_dtype: torch.dtype = torch.float32, tp=None, name: str = "attn"):
        super().__init__()
        kw = dict(device=device, dtype=dtype, param_dtype=param_dtype)
        self.norm = make_layer_norm(fused_ln, dim, eps=ln_eps, **kw)
        common = dict(dim=dim, num_heads=num_heads, attn_drop=attn_drop, proj_drop=drop, **kw)
        kernels = dict(rpe=rpe, use_kernels=use_kernels)
        split = dict(tp=tp, name=name)
        if attn_type == "full":
            self.attn = FullAttention(wx=wx, wy=wy, nglo=nglo, **kernels, **common, **split)
        elif attn_type in LONGFORMER_TYPES:
            self.attn = VilAttention(w=num_feats, nglo=nglo, exact=sw_exact, sharew=sharew,
                                     only_glo=only_glo, fused_block=fused_block, **kernels,
                                     **common, **split)
        elif attn_type == "linformer":
            self.attn = LinformerAttention(seq_len=wx * wy + nglo, num_feats=num_feats,
                                           share_kv=share_kv, **common, **split)
        elif attn_type == "srformer":
            self.attn = SRAttention(rratio=num_feats, **common, **split)
        elif attn_type == "performer":
            self.attn = PerformerAttention(nb_features=num_feats, **common, **split)
        else:
            raise ValueError(f"Not supported attention type {attn_type}")
        self.droppath = DropPath(drop_path)

    def forward(self, x, nx: int, ny: int, generator: Optional[torch.Generator] = None,
                mode: int = 0, spatial=None, part: Optional[Part] = None):
        """``part``: the chunk rows of the image that a rank holds under the
        spatial split (``spatial``), for the projection dropout."""
        if isinstance(x, tuple):  # sliding-chunk attention, maybe on a rank's rows
            x_glo, x_img = x
            y_glo, y_img = self.droppath(self.attn(
                (None if x_glo is None else self.norm(x_glo), self.norm(x_img)),
                nx, ny, mode, spatial, generator=generator, part=part,
            ), generator)
            return None if x_glo is None else x_glo + y_glo, x_img + y_img
        return x + self.droppath(self.attn(self.norm(x), nx, ny, mode, generator=generator),
                                 generator)


class MlpBlock(nn.Module):
    """Pre-LN MLP block with a DropPath residual; per token, so it takes a
    token tensor or the chunked pair alike."""

    def __init__(self, dim: int, mlp_ratio: float = 4.0, drop: float = 0.0,
                 drop_path: float = 0.0, ln_eps: float = 1e-6, fused_ln: bool = False,
                 device=None, dtype: torch.dtype = torch.float32,
                 param_dtype: torch.dtype = torch.float32, tp=None, name: str = "mlp"):
        super().__init__()
        kw = dict(device=device, dtype=dtype, param_dtype=param_dtype)
        self.norm = make_layer_norm(fused_ln, dim, eps=ln_eps, **kw)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), drop=drop, tp=tp, name=name, **kw)
        self.droppath = DropPath(drop_path)

    def forward(self, x, generator: Optional[torch.Generator] = None,
                part: Optional[Part] = None):
        """``part``: the :class:`~.layers.Part` of the whole image tokens
        that x (or the pair's x_img) holds on a split model, for the
        dropout; the global tokens are whole on every rank."""
        if isinstance(x, tuple):
            x_glo, x_img = x
            y_glo = None if x_glo is None else self.mlp(self.norm(x_glo), generator)
            y_glo, y_img = self.droppath((y_glo, self.mlp(self.norm(x_img), generator, part)),
                                         generator)
            return None if x_glo is None else x_glo + y_glo, x_img + y_img
        return x + self.droppath(self.mlp(self.norm(x), generator, part), generator)


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
    With ``tp`` (a ``parallel.TensorParallel`` context, TPU.PARAM_SHARDING
    'tp') the model is this model rank's shard: each attention and MLP
    block whose heads (hidden features) divide by the model axis holds its
    rank's part (``parallel/tensor.py``), in every attention family and
    mode; ``param_shards`` names each cut
    parameter's :class:`~vil_tpu_torch.parallel.tensor.Shard`, and the
    weights are those of the whole model from the same ``generator``.
    Weights are drawn by :meth:`init_weights` from ``generator``. ``mode``
    (MODEL.VIT.MSVIT.MODE) is carried as the flax field is and not read at
    call time: the neighbour mode is an argument of :meth:`forward`.
    ``remat`` (TPU.REMAT: '', 'minimal' or 'full') rematerialises each
    attention and MLP block in training (:func:`remat_block`).
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
                 generator: Optional[torch.Generator] = None, tp=None, remat: str = ""):
        super().__init__()
        if remat not in REMAT_POLICIES:
            raise ValueError(f"remat {remat!r}: one of {REMAT_POLICIES}")
        kw = dict(device=resolve_device(device), dtype=dtype, param_dtype=param_dtype)
        self.dtype = dtype
        self.tp = tp
        cfgs = parse_arch(arch)
        self.layer_cfgs: list[StageCfg] = cfgs
        self.img_size, self.avg_pool = img_size, avg_pool
        self.mode = mode
        self.remat, self.drop_rate = remat, drop_rate
        self._splits: dict = {}  # rank count → its spatial split

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
                    fused_block=fused_block, tp=tp, name=attn_name, **kw,
                ))
                setattr(self, mlp_name, MlpBlock(
                    dim=c.dim, drop=drop_rate, drop_path=dpr, ln_eps=ln_eps,
                    fused_ln=fused_ln, tp=tp, name=mlp_name, **kw,
                ))
                names.append((attn_name, mlp_name))
            self.stage_blocks.append(names)
        self.norm = LayerNorm(cfgs[-1].dim, eps=ln_eps, **kw)
        self.head = Linear(cfgs[-1].dim, num_classes, **kw) if num_classes > 0 else None
        # the plan: each cut parameter's shard (FSDP adds its own)
        self.param_shards = {f"{name}.{leaf}": shard for name, mod in self.named_modules()
                             if isinstance(mod, Linear) for leaf, shard in mod.shards().items()}
        self.init_weights(generator)

    def partial_over_model(self) -> list:
        """The parameters of which each model rank holds a part of the
        gradient: the relative-position tables of the split blocks (each
        rank's heads' columns) and the split linformers' sequence
        projections (each rank's heads' channels). The training step sums
        them over the model group (``parallel.average_gradients``)."""
        tables = [t for mod in self.modules()
                  if isinstance(mod, (FullAttention, VilAttention)) and mod.rpe_heads is not None
                  for t in mod.rpe_tables()]
        return tables + [p for mod in self.modules()
                         if isinstance(mod, LinformerAttention) and mod.tp is not None
                         for p in (mod.proj_k, mod.proj_v) if p is not None]

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

        def trunc_normal_(p, std, shard=None):
            # a cut weight takes its part of the whole layer's draw
            t = torch.empty(p.shape if shard is None else shard.full_shape(p.shape),
                            dtype=torch.float32)
            nn.init.trunc_normal_(t, std=std, a=-2 * std, b=2 * std, generator=generator)
            p.copy_(t if shard is None else shard.local(t))

        for mod in self.modules():
            if isinstance(mod, nn.Linear):
                trunc_normal_(mod.weight, 0.02,
                              mod.shards().get("weight") if isinstance(mod, Linear) else None)
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
        ignore theirs). In eval mode the sampled modes 1..8 of random-shift
        training run at mode 0; mode -1, the self chunk alone, is served as
        it is asked for, as in ``vil_tpu``. A model with ``remat`` refuses
        modes 1..8 in training, as ``vil_tpu``'s ``nn.remat`` of a static
        mode does."""
        if isinstance(mode, (int, np.integer)):
            modes = [int(mode)] * self.depth
        else:
            modes = [int(m) for m in mode]
            if len(modes) != self.depth:
                raise ValueError(f"expected {self.depth} per-layer modes, got {len(modes)}")
        if not self.training:
            return [m if m <= 0 else 0 for m in modes]
        if self.remat and any(m > 0 for m in modes):
            raise ValueError(f"TPU.REMAT {self.remat!r} needs a static neighbour mode: the "
                             f"sampled modes 1..8 of random-shift training are refused, as "
                             f"vil_tpu's nn.remat refuses its traced mode (build_model drops "
                             f"REMAT under MODE > 0)")
        return modes

    def spatial_split(self, size: int):
        """The chunk-aligned split of the image's rows over ``size`` ranks
        (``parallel.spatial.row_split``) for the chunked stages before the
        first dense one: every rank holds whole chunk rows at each, the last
        the chunk grid's pad rows. Raises ``ValueError``, naming the stage,
        when a rank would hold no row of one."""
        if size not in self._splits:
            n = next((i for i, c in enumerate(self.stage_chunked) if not c),
                     len(self.stage_chunked))
            cfgs = self.layer_cfgs[:n]
            self._splits[size] = row_split(self.img_size, [c.patch_size for c in cfgs],
                                           [c.num_feats for c in cfgs], size)
        return self._splits[size]

    def forward_features(self, x: torch.Tensor,
                         generator: Optional[torch.Generator] = None,
                         mode: Union[int, Sequence[int]] = 0, spatial=None) -> torch.Tensor:
        B = x.shape[0]
        modes = iter(self._block_modes(mode))
        grids = self.grid_sizes()
        nglos = [c.nglo for c in self.layer_cfgs]
        # under a spatial context x holds this rank's rows of the image, and
        # each chunked stage its rows of the split (None once gathered)
        split = None if spatial is None else self.spatial_split(spatial.size)
        for sid, names in enumerate(self.stage_blocks):
            nx, ny = grids[sid]
            if split is not None:
                held = split.tokens[sid - 1] if sid > 0 else split.image  # every rank's rows
                counts = [hi - lo for lo, hi in held]
            if sid > 0:
                # strip the global tokens, tokens → image grid (NHWC)
                prev_rows = grids[sid - 1][0] if split is None else counts[spatial.rank]
                x = x[:, nglos[sid - 1]:].reshape(B, prev_rows, grids[sid - 1][1], -1)
            chunked = self.stage_chunked[sid]
            if split is not None and not chunked:  # the first dense stage runs whole
                x = spatial.gather_rows(x, counts, dim=1)
                split = None
            rows = None
            if split is not None:
                lo, hi = split.tokens[sid][spatial.rank]
                rows = (lo, hi - lo)
            x = getattr(self, f"stage{sid + 1}_patch_embed")(x, rows, generator)
            nx_here = nx if rows is None else rows[1]
            ctx = part = None
            if split is not None:  # this rank's chunk rows, of the whole grid's
                ctx = spatial.at(split.chunks[sid][spatial.rank])
                part = Part().along(1, sc.chunk_grid(nx, ny, self.layer_cfgs[sid].num_feats)[2],
                                    ctx.span)
            if chunked:
                g, w_s = nglos[sid], self.layer_cfgs[sid].num_feats
                x = (x[:, :g] if g > 0 else None,
                     sc.chunkify(x[:, g:], nx_here, ny, w_s))
            for attn_name, mlp_name in names:
                # bound now: a rematerialised block runs again in the backward
                x = self._block(partial(getattr(self, attn_name), nx=nx, ny=ny,
                                        generator=generator, mode=next(modes), spatial=ctx,
                                        part=part),
                                x, generator)
                x = self._block(partial(getattr(self, mlp_name), generator=generator,
                                        part=part), x, generator)
            if chunked:
                x_glo, x_img = x
                loc = sc.unchunkify(x_img, nx_here, ny, w_s)
                x = loc if x_glo is None else torch.cat([x_glo, loc], dim=1)
        x = self.norm(x)
        if nglos[-1] > 0 and not self.avg_pool:
            return x[:, 0]
        return x.mean(dim=1)

    def _block(self, run: Callable, x, generator: Optional[torch.Generator]):
        """One block, rematerialised under ``remat`` where a training
        forward records a gradient."""
        if self.remat and self.training and torch.is_grad_enabled():
            return remat_block(run, x, self.remat, generator)
        return run(x)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None,
                mode: Union[int, Sequence[int]] = 0, spatial=None) -> torch.Tensor:
        """x: (B, H, W, C) NHWC images → (B, num_classes) logits. In training
        mode stochastic depth draws from ``generator`` (on x's device), and
        ``mode`` is the neighbour mode of every attention block, or a
        sequence of ``depth`` host ints, one per block in order (the dense
        blocks included, which ignore theirs). In eval mode every block runs
        at mode 0. With a ``spatial`` context (``parallel.spatial_forward``,
        and the training step on a mesh with a spatial axis) x holds this
        rank's rows of the images (``parallel.shard_image``) and the logits
        are the same on every rank of the group. Dropout draws each mask of
        the whole value and keeps this rank's part of it (``layers.Part``),
        so that the ranks of a split model, given generators in the same
        state, compute what the unsplit model computes from that state."""
        feats = self.forward_features(x, generator, mode, spatial)
        return feats if self.head is None else self.head(feats)
