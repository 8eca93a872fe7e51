"""Linear-complexity attention baselines of the paper's ablation: Performer,
Linformer, SRformer.

Counterpart of ``vil_tpu/models/attention_efficient.py``, with the flax
names (``qkv``, ``query``, ``kv``, ``proj``, ``proj_k``, ``proj_v``,
``proj_sr`` and the performer's ``projection_matrix`` buffer), so that
``utils.jax_import`` maps every leaf. None of them reaches a kernel in the
JAX package: they are XLA einsums there and plain PyTorch here, with the
same rounding points. A product the JAX package takes with
``preferred_element_type=float32`` and keeps in f32 is taken here on f32
copies of its operands (exact products, f32 sums); one it rounds to the
compute type at once is taken in the compute type.

Tensor parallelism (a ``parallel.TensorParallel`` context of n ranks,
TPU.PARAM_SHARDING 'tp'): a module whose heads divide by n holds this
rank's H/n heads, as the ViL's attention does. ``qkv``, ``query`` and
``kv`` are column-parallel (the packed ones cut per block), ``proj``
row-parallel, reduced over the model group. What acts along the sequence
or on the whole replicated input needs no cut of its own: the linformer's
``proj_k`` / ``proj_v`` (N → k, each channel alike) are whole on every rank,
which applies them to its heads' channels, so each rank holds a part of
their gradient (``MsViT.partial_over_model``); the SRformer's ``proj_sr``
and instance norm run whole on every rank on the replicated input, and
the reduced keys' input passes ``TensorParallel.copy`` after them, so
their gradient is whole there; the performer's projection is a buffer,
the same on every rank, and the keys' stabiliser, the maximum over every
image and head, is taken over the model group's heads.

The performer's projection is a persistent buffer, drawn on the host from an
explicit ``torch.Generator`` (one seed gives the same matrix on any device)
by ``MsViT.init_weights`` and redrawn in place by
``train.redraw.redraw_projections``; it rides in the model's ``state_dict``
as the JAX package's ``buffers`` collection rides in its checkpoints.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from ..parallel.spatial import reduce_max
from .attention import merge_heads, scores_f32, softmax_max_sub, split_heads
from .layers import Conv2d, Dropout, Linear, check_eval_only


def gaussian_orthogonal_random_matrix(nb_rows: int, nb_columns: int, scaling: int = 0,
                                      generator: Optional[torch.Generator] = None
                                      ) -> torch.Tensor:
    """(nb_rows, nb_columns) f32 random features with orthogonal blocks, on
    the host: each block of nb_columns rows is Qᵀ of the QR decomposition of
    a Gaussian matrix, the last block cut to the remainder; the rows are then
    scaled by χ-distributed norms (``scaling`` 0, the norms of Gaussian rows)
    or by √nb_columns (``scaling`` 1)."""
    nb_full_blocks = nb_rows // nb_columns
    blocks = []
    for _ in range(nb_full_blocks):
        q, _ = torch.linalg.qr(torch.randn(nb_columns, nb_columns, generator=generator))
        blocks.append(q.T)
    rem = nb_rows - nb_full_blocks * nb_columns
    if rem > 0:
        q, _ = torch.linalg.qr(torch.randn(nb_columns, nb_columns, generator=generator))
        blocks.append(q.T[:rem])
    mat = torch.cat(blocks, dim=0)
    if scaling == 0:
        multiplier = torch.linalg.norm(torch.randn(nb_rows, nb_columns, generator=generator),
                                       dim=1)
    elif scaling == 1:
        multiplier = torch.full((nb_rows,), math.sqrt(nb_columns))
    else:
        raise ValueError(f"Invalid scaling {scaling}")
    return multiplier[:, None] * mat


def softmax_kernel(data: torch.Tensor, projection: torch.Tensor, is_query: bool,
                   eps: float = 1e-4, tp=None) -> torch.Tensor:
    """FAVOR+ positive softmax features of data (B, H, N, M) under the
    projection (nb_features, M), in data's dtype. The exponent is f32; its
    stabiliser is a constant to autograd: the per-row maximum for the
    queries, the maximum over the whole tensor (every image and head) for
    the keys, over the heads of the model group ``tp`` where data holds a
    rank's heads."""
    normalizer = data.shape[-1] ** -0.25
    ratio = projection.shape[0] ** -0.5
    data_dash = torch.matmul((normalizer * data).float(),
                             projection.to(data.dtype).float().T)
    diag_data = ((data.square().sum(dim=-1) / 2.0 * normalizer ** 2)[..., None]).float()
    stab = data_dash.amax(dim=-1, keepdim=True) if is_query else data_dash.amax()
    if tp is not None and not is_query:
        stab = reduce_max(stab, tp)
    out = ratio * (torch.exp(data_dash - diag_data - stab.detach()) + eps)
    return out.to(data.dtype)


def linear_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Non-causal linear attention over the features q, k (B, H, N, F) and
    the values v (B, H, N, M); the context kᵀv is summed in f32 and rounded
    to q's dtype once."""
    k_cumsum = k.sum(dim=-2)
    d_inv = 1.0 / torch.matmul(q, k_cumsum[..., None])[..., 0]
    context = torch.matmul(k.transpose(-1, -2), v)
    return torch.matmul(q, context) * d_inv[..., None]


def _split(tp, num_heads: int, name: str):
    """The module's tensor-parallel context: ``tp`` where its heads divide
    over the model group, else None (whole on every rank, logged)."""
    return tp if tp is not None and tp.splits(num_heads, name) else None


class PerformerAttention(nn.Module):
    """FAVOR+ self-attention over all tokens, ``nb_features`` random
    features (``int(M·log M)`` when 0), its projection the buffer
    ``projection_matrix``. ``num_heads`` is the rank's under ``tp``."""

    def __init__(self, dim: int, num_heads: int, nb_features: int = 256,
                 attn_drop: float = 0.0, proj_drop: float = 0.0, device=None,
                 dtype: torch.dtype = torch.float32,
                 param_dtype: torch.dtype = torch.float32, tp=None,
                 name: str = "PerformerAttention"):
        super().__init__()
        kw = dict(device=device, dtype=dtype, param_dtype=param_dtype)
        self.tp = _split(tp, num_heads, name)
        self.dim = dim
        self.num_heads = num_heads if self.tp is None else num_heads // self.tp.size
        self.attn_drop, self.proj_drop = attn_drop, Dropout(proj_drop)
        m = dim // num_heads
        self.nb_features = nb_features or int(m * math.log(m))
        self.qkv = Linear(dim, 3 * dim, tp=self.tp, cut="column", pack=3, **kw)
        self.proj = Linear(dim, dim, tp=self.tp, cut="row", **kw)
        # f32 whatever param_dtype is: the JAX package keeps it out of the
        # parameters, in f32. A fixed draw: MsViT.init_weights,
        # redraw_projections and load_jax_params set it.
        self.register_buffer("projection_matrix", gaussian_orthogonal_random_matrix(
            self.nb_features, m, generator=torch.Generator().manual_seed(0)).to(device=device))

    def forward(self, x: torch.Tensor, nx: int = 0, ny: int = 0, mode: int = 0,
                generator=None) -> torch.Tensor:
        H = self.num_heads
        if self.tp is not None:
            x = self.tp.copy(x)
        q, k, v = (split_heads(self.qkv.part(x, i, 3), H) for i in range(3))
        q = softmax_kernel(q, self.projection_matrix, is_query=True)
        k = softmax_kernel(k, self.projection_matrix, is_query=False, tp=self.tp)
        return self.proj_drop(self.proj(merge_heads(linear_attention(q, k, v))), generator)


class LinformerAttention(nn.Module):
    """Linformer: keys and values projected along the sequence axis, from
    ``seq_len`` = Nglo + nx·ny tokens to ``num_feats`` (``proj_k``, and
    ``proj_v`` unless ``share_kv``), before the heads are split.
    ``num_heads`` is the rank's under ``tp``; the projections stay whole."""

    def __init__(self, dim: int, seq_len: int, num_feats: int = 256, num_heads: int = 8,
                 attn_drop: float = 0.0, proj_drop: float = 0.0, share_kv: bool = True,
                 device=None, dtype: torch.dtype = torch.float32,
                 param_dtype: torch.dtype = torch.float32, tp=None,
                 name: str = "LinformerAttention"):
        super().__init__()
        kw = dict(device=device, dtype=dtype, param_dtype=param_dtype)
        self.tp = _split(tp, num_heads, name)
        self.dim, self.seq_len, self.num_feats = dim, seq_len, num_feats
        self.head_dim = dim // num_heads
        self.num_heads = num_heads if self.tp is None else num_heads // self.tp.size
        self.attn_drop, self.proj_drop = attn_drop, Dropout(proj_drop)
        self.share_kv = share_kv
        self.compute_dtype = dtype
        self.query = Linear(dim, dim, tp=self.tp, cut="column", **kw)
        self.kv = Linear(dim, 2 * dim, tp=self.tp, cut="column", pack=2, **kw)
        self.proj = Linear(dim, dim, tp=self.tp, cut="row", **kw)
        new = lambda: nn.Parameter(torch.zeros(seq_len, num_feats, device=device,
                                               dtype=param_dtype))
        self.proj_k = new()
        self.proj_v = None if share_kv else new()

    def forward(self, x: torch.Tensor, nx: int = 0, ny: int = 0, mode: int = 0,
                generator=None) -> torch.Tensor:
        check_eval_only(self, self.attn_drop, "attention dropout")
        n, H, dt = x.shape[1], self.num_heads, self.compute_dtype
        if n != self.seq_len:
            raise ValueError(f"the sequence length of the key / values must be "
                             f"{self.seq_len} - {n} given")
        if self.tp is not None:
            x = self.tp.copy(x)
        q = split_heads(self.query(x), H) * self.head_dim ** -0.5
        proj_v = self.proj_k if self.share_kv else self.proj_v
        k = torch.einsum("bnd,nk->bkd", self.kv.part(x, 0, 2), self.proj_k.to(dt))
        v = torch.einsum("bnd,nk->bkd", self.kv.part(x, 1, 2), proj_v.to(dt))
        probs = softmax_max_sub(scores_f32(q, split_heads(k, H)))
        out = self.proj(merge_heads(torch.matmul(probs.to(dt), split_heads(v, H))))
        return self.proj_drop(out, generator)


def instance_norm_nchw(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """InstanceNorm2d without affine parameters: each (image, channel) over
    its spatial axes, with the population variance."""
    var, mean = torch.var_mean(x, dim=(2, 3), correction=0, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps)


class SRAttention(nn.Module):
    """Spatial-reduction attention (Pyramid Vision Transformer): every token
    attends to the global tokens and to the local grid reduced by an
    ``rratio``×``rratio`` stride-``rratio`` convolution (``proj_sr``, no
    bias, no padding) and an instance norm in f32. ``num_heads`` is the
    rank's under ``tp``; ``proj_sr`` and the norm stay whole."""

    def __init__(self, dim: int, rratio: int = 2, num_heads: int = 8,
                 attn_drop: float = 0.0, proj_drop: float = 0.0, device=None,
                 dtype: torch.dtype = torch.float32,
                 param_dtype: torch.dtype = torch.float32, tp=None, name: str = "SRAttention"):
        super().__init__()
        kw = dict(device=device, dtype=dtype, param_dtype=param_dtype)
        self.tp = _split(tp, num_heads, name)
        self.dim, self.rratio = dim, rratio
        self.head_dim = dim // num_heads
        self.num_heads = num_heads if self.tp is None else num_heads // self.tp.size
        self.attn_drop, self.proj_drop = attn_drop, Dropout(proj_drop)
        self.compute_dtype = dtype
        self.query = Linear(dim, dim, tp=self.tp, cut="column", **kw)
        self.proj_sr = Conv2d(dim, dim, rratio, stride=rratio, bias=False, **kw)
        self.kv = Linear(dim, 2 * dim, tp=self.tp, cut="column", pack=2, **kw)
        self.proj = Linear(dim, dim, tp=self.tp, cut="row", **kw)

    def forward(self, x: torch.Tensor, nx: int, ny: int, mode: int = 0,
                generator=None) -> torch.Tensor:
        check_eval_only(self, self.attn_drop, "attention dropout")
        b, n, d = x.shape
        H, dt = self.num_heads, self.compute_dtype
        copy = (lambda t: t) if self.tp is None else self.tp.copy
        q = split_heads(self.query(copy(x)), H) * self.head_dim ** -0.5
        nglo = n - nx * ny
        grid = x[:, nglo:].reshape(b, nx, ny, d).permute(0, 3, 1, 2)  # NHWC viewed as NCHW
        reduced = instance_norm_nchw(self.proj_sr(grid).float()).to(dt)
        # the reduced keys' input: whole on every rank, its gradient summed
        # over the model group's heads
        x_kv = copy(torch.cat([x[:, :nglo].to(dt), reduced.flatten(2).transpose(1, 2)], dim=1))
        k = split_heads(self.kv.part(x_kv, 0, 2), H)
        v = split_heads(self.kv.part(x_kv, 1, 2), H)
        probs = softmax_max_sub(scores_f32(q, k))
        return self.proj_drop(self.proj(merge_heads(torch.matmul(probs.to(dt), v))), generator)
