"""Sliding-chunk attention: the Hopper kernels and their plain versions.

Counterpart of ``vil_tpu/ops/pallas/vil_kernel.py::_pallas_forward_mh`` (the
forward kernel, ``csrc/vil_attention_fwd.cu``: in bf16 on the tensor cores,
in f32 on the CUDA cores), of
``vil_tpu/ops/pallas/vil_backward.py::vil_attention_backward`` (the backward
kernels, ``csrc/vil_attention_bwd.cu``: in bf16 on the tensor cores, in f32
on the CUDA cores), of ``make_fused_vil_attention_mh``
(:class:`VilAttentionFunction`) and of ``_xla_reference_mh`` (the plain
version, :func:`vil_attention_reference`). Per query chunk and head:

    S   = q · [K_glo ‖ K of the 3×3 cyclic chunk neighbourhood]ᵀ + bias + mask
    out = softmax(S) · [V_glo ‖ V_nbh],    lse = log Σ exp(S)

Layouts are the JAX package's: q, k, v, out (B, mx, my, W², C) with the heads
packed in C; k_glo, v_glo (B, Nglo, C); bias (H, W², Nglo+9W²) f32 or None;
mask (mx, my, Wq, Nglo+9W²) f32 with Wq ∈ {1, W²}; lse (B, H, mx, my, W²)
f32. Score columns are in front order [glo ‖ neighbour 0 … 8]. q arrives
scaled by M^-½; the gradient dq is with respect to that scaled q. The
backward takes the forward's ``out``: its bf16 kernels form
δ = rowsum(P ∘ dP) as rowsum(g ∘ out).

The operand checks, the launchers and the plain versions here take the
neighbourhood as a parameter: ``vil_mode_attention.py`` (the sampled
[self ‖ one neighbour] kernels of random-shift training) and
``vil_attention_halo.py`` (the halo-extended K/V of spatial parallelism)
share them.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from .. import sliding_chunk as sc
from . import build

# finite mask fill: exp(fill - max) underflows to 0, and a row whose keys are
# all masked stays finite (exp(-inf - -inf) would be NaN)
NEG_INF = float(np.finfo(np.float32).min) / 2

HEAD_DIMS = (8, 16, 32, 64, 128)  # head dims the kernel is compiled for
# the shared memory one block may use on an H100 (227 KB); the f32 CUDA-core
# bodies ask for W²(4M + 3) floats in the forward and W²(6M + 4) in the
# backward's pass 2, its larger pass (csrc/sliding_chunk.cuh: fwd_smem_bytes,
# pass2_smem_bytes); the bf16 tensor-core bodies size theirs by the 64-row
# tile and take every W
SMEM_PER_BLOCK = 232448


def bf16_exp() -> bool:
    """``vil_tpu``'s BF16_EXP (``vil_tpu/ops/pallas/vil_kernel.py``): whether
    the bf16 sliding-chunk kernels round the exponent's input to bf16, P =
    bf16(exp(bf16(S − L))) in the backward and exp(bf16(S − m)) against the
    running maximum in the forward, where without it they take the exponent
    of the f32 difference; the forward's LSE sums the same P. The
    environment variable ``VIL_TPU_BF16_EXP``,
    "1" (on) by default as in ``vil_tpu``, read at each launch; the f32
    kernels and the dense ones ignore it."""
    return os.environ.get("VIL_TPU_BF16_EXP", "1") == "1"


def mask_to_additive(mask_bool: np.ndarray, mx: int, my: int, w2: int,
                     nglo: int) -> np.ndarray:
    """Boolean invalid-mask table → additive f32 (mx, my, Wq, Nglo+9W²).

    Global-token columns are never masked. Accepts the (mx·my, 9W²)
    blockwise tables or the (mx·my, W², 9W²) exact table.
    """
    if mask_bool.ndim == 2:
        m = mask_bool.reshape(mx, my, 1, -1)
    else:
        m = mask_bool.reshape(mx, my, w2, -1)
    add = np.where(m, NEG_INF, 0.0).astype(np.float32)
    if nglo > 0:
        glo = np.zeros(add.shape[:3] + (nglo,), dtype=np.float32)
        add = np.concatenate([glo, add], axis=-1)
    return add


def _heads(t, H):
    """(B, mx, my, W², C) → (B·H, mx, my, W², M) f32."""
    B, mx, my, w2, C = t.shape
    return (t.float().reshape(B, mx, my, w2, H, C // H)
            .permute(0, 4, 1, 2, 3, 5).reshape(B * H, mx, my, w2, C // H))


def _glo_heads(t, H):
    """(B, Nglo, C) → (B·H, Nglo, M) f32."""
    B, nglo, C = t.shape
    return t.float().reshape(B, nglo, H, C // H).transpose(1, 2).reshape(B * H, nglo, C // H)


def neighbourhood_attention(q, k, v, k_glo, v_glo, bias, mask_add, num_heads: int,
                            neighbours, with_lse: bool = False):
    """Plain PyTorch sliding-chunk attention, in f32 through the
    neighbourhood-concat matmuls; the output is rounded to q's dtype. With
    ``with_lse`` it returns (out, lse). ``neighbours`` maps a K or V operand
    in heads layout (B·H, rows, my, W², M) to its concatenated neighbourhood
    (B·H, mx, my, K·W², M), in the column order of the mask."""
    B, mx, my, w2, C = q.shape
    H = num_heads
    nglo = 0 if k_glo is None else k_glo.shape[1]
    qh = _heads(q, H)
    scores = torch.matmul(qh, neighbours(_heads(k, H)).transpose(-1, -2))
    if k_glo is not None:  # (B·H, mx, my, W², Nglo + K·W²), front order
        s_glo = torch.einsum("bxylm,btm->bxylt", qh, _glo_heads(k_glo, H))
        scores = torch.cat([s_glo, scores], dim=-1)
    if bias is not None:  # row b·H + h takes bias[h]
        scores = scores + bias.float().repeat(B, 1, 1)[:, None, None]
    scores = scores + mask_add.float()[None]
    probs = torch.softmax(scores, dim=-1)
    out = torch.matmul(probs[..., nglo:], neighbours(_heads(v, H)))
    if nglo > 0:
        out = out + torch.einsum("bxylt,btm->bxylm", probs[..., :nglo],
                                 _glo_heads(v_glo, H))
    out = out.reshape(B, H, mx, my, w2, C // H).permute(0, 2, 3, 4, 1, 5)
    out = out.reshape(B, mx, my, w2, C).to(q.dtype)
    if not with_lse:
        return out
    return out, torch.logsumexp(scores, dim=-1).reshape(B, H, mx, my, w2)


def chunk_attention_reference(q, k, v, k_glo, v_glo, bias, mask_add, num_heads: int,
                              mode: int, with_lse: bool = False):
    """Plain PyTorch sliding-chunk attention over the cyclic neighbourhood of
    ``mode`` (``ops.sliding_chunk``), in f32 through the neighbourhood-concat
    matmuls; the output is rounded to q's dtype. With ``with_lse`` it
    returns (out, lse)."""
    return neighbourhood_attention(q, k, v, k_glo, v_glo, bias, mask_add, num_heads,
                                   lambda t: sc.neighborhood(t, mode), with_lse)


def grads_by_autograd(forward, operands, g):
    """Autograd through ``forward(*operands)`` in f32: the gradient of each
    operand against the upstream ``g``, in the operand's dtype, None where
    the operand is."""
    leaves = [None if t is None else t.detach().float().requires_grad_() for t in operands]
    with torch.enable_grad():
        out = forward(*leaves)
        present = [t for t in leaves if t is not None]
        grads = iter(torch.autograd.grad(out, present, g.float()))
    return tuple(None if t is None else next(grads).to(t.dtype) for t in operands)


def chunk_attention_bwd_reference(q, k, v, k_glo, v_glo, bias, g, mask_add, num_heads: int,
                                  mode: int):
    """Autograd through :func:`chunk_attention_reference` in f32: (dq, dk,
    dv, dk_glo, dv_glo, dbias), each in its operand's dtype, None where the
    operand is."""
    return grads_by_autograd(
        lambda *ops: chunk_attention_reference(*ops, mask_add, num_heads, mode),
        (q, k, v, k_glo, v_glo, bias), g)


def _bf16(t: torch.Tensor) -> torch.Tensor:
    """t rounded to bf16 (to nearest even), kept in f32."""
    return t.to(torch.bfloat16).float()


def _emulated_keys(k, v, k_glo, v_glo, num_heads: int, neighbours):
    """[glo ‖ neighbourhood] keys and values of every query chunk in heads
    layout, (B·H, mx, my, Nglo + K·W², M) f32, from the leaves they are cut
    of (autograd carries a gradient back through the gather)."""
    kn, vn = neighbours(_heads(k, num_heads)), neighbours(_heads(v, num_heads))
    if k_glo is None:
        return kn, vn
    glo = lambda t: _glo_heads(t, num_heads)[:, None, None].expand(
        -1, kn.shape[1], kn.shape[2], -1, -1)
    return torch.cat([glo(k_glo), kn], dim=3), torch.cat([glo(v_glo), vn], dim=3)


def _emulated_scores(q, kcat, bias, mask_add, num_heads: int) -> torch.Tensor:
    """S + bias + mask (B·H, mx, my, W², cols) f32, S from the operands'
    values with f32 sums."""
    scores = torch.matmul(_heads(q, num_heads), kcat.transpose(-1, -2))
    if bias is not None:
        scores = scores + bias.float().repeat(q.shape[0], 1, 1)[:, None, None]
    return scores + mask_add.float()[None]


KEY_TILE = 64  # the tensor-core forward's keys a tile (csrc/tensor_core.cuh, kTcRows)


def neighbourhood_attention_bf16(q, k, v, k_glo, v_glo, bias, mask_add, num_heads: int,
                                 neighbours, exp_bf16: bool, with_lse: bool = False):
    """The bf16 tensor-core forward's arithmetic, emulated in f32 (the plain
    version's operands and ``neighbours``): S with f32 sums, taken in tiles of
    ``KEY_TILE`` keys in the column order [glo ‖ neighbourhood] with a
    running maximum m, as the kernel's online softmax takes them: P =
    exp(S − m), the difference rounded to bf16 first when ``exp_bf16``
    (``vil_tpu``'s BF16_EXP, :func:`bf16_exp`), the denominator summed from
    the unrounded P and P rounded to bf16 for P·V, both rescaled when a
    later tile raises m; the output rounded to q's dtype, the LSE m + log Σ
    P. Used by the tests; :func:`neighbourhood_attention` stays the oracle
    of the kernels' limits. With ``with_lse`` it returns (out, lse)."""
    B, mx, my, w2, C = q.shape
    H = num_heads
    kcat, vcat = _emulated_keys(k, v, k_glo, v_glo, H, neighbours)
    scores = _emulated_scores(q, kcat, bias, mask_add, H)
    m = scores.new_full(scores.shape[:-1] + (1,), float("-inf"))
    den = torch.zeros_like(m)
    acc = scores.new_zeros(scores.shape[:-1] + (C // H,))
    for t in range(0, scores.shape[-1], KEY_TILE):
        tile = scores[..., t:t + KEY_TILE]
        m_new = torch.maximum(m, tile.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        z = tile - m_new
        p = torch.exp(_bf16(z) if exp_bf16 else z)
        den = den * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.matmul(_bf16(p), vcat[..., t:t + KEY_TILE, :])
        m = m_new
    out = (acc / den).reshape(B, H, mx, my, w2, C // H).permute(0, 2, 3, 4, 1, 5)
    out = out.reshape(B, mx, my, w2, C).to(q.dtype)
    if not with_lse:
        return out
    return out, (m + torch.log(den))[..., 0].reshape(B, H, mx, my, w2)


def neighbourhood_attention_bf16_bwd(q, k, v, k_glo, v_glo, bias, g, out, lse, mask_add,
                                     num_heads: int, neighbours, exp_bf16: bool):
    """The bf16 tensor-core backward's arithmetic, emulated in f32 from the
    forward's ``out`` and ``lse``: P = bf16(exp(S − L)), S − L rounded to
    bf16 first when ``exp_bf16``; dP = g·Vᵀ, δ = rowsum(g ∘ out), dS = P ∘
    (dP − δ); dbias and the global keys' dK from the unrounded dS, the rest
    from dS rounded to bf16; dV from the rounded P. Returns (dq, dk, dv,
    dk_glo, dv_glo, dbias) as the backward wrappers do."""
    B, mx, my, w2, C = q.shape
    H, M = num_heads, C // num_heads
    nglo = 0 if k_glo is None else k_glo.shape[1]
    leaves = [None if t is None else t.detach().float().requires_grad_()
              for t in (k, v, k_glo, v_glo)]
    with torch.enable_grad():
        kcat, vcat = _emulated_keys(*leaves, H, neighbours)
    scores = _emulated_scores(q, kcat.detach(), bias, mask_add, H)
    z = scores - lse.reshape(B * H, mx, my, w2)[..., None]
    p = _bf16(torch.exp(_bf16(z) if exp_bf16 else z))
    gh = _heads(g, H)
    dp = torch.matmul(gh, vcat.detach().transpose(-1, -2))
    ds = p * (dp - (gh * _heads(out, H)).sum(dim=-1, keepdim=True))
    dsb = _bf16(ds)
    qh = _heads(q, H)
    dq = torch.matmul(dsb, kcat.detach())
    dk_rows = torch.cat([ds[..., :nglo], dsb[..., nglo:]], dim=-1)
    dkcat = torch.matmul(dk_rows.transpose(-1, -2), qh)
    dvcat = torch.matmul(p.transpose(-1, -2), gh)
    present = [t for t in leaves if t is not None]
    grads = iter(torch.autograd.grad((kcat, vcat), present, (dkcat, dvcat)))
    dk, dv, dkg, dvg = (None if t is None else next(grads) for t in leaves)
    dq = dq.reshape(B, H, mx, my, w2, M).permute(0, 2, 3, 4, 1, 5).reshape(B, mx, my, w2, C)
    dbias = None
    if bias is not None:
        dbias = ds.reshape(B, H, mx, my, w2, -1).sum(dim=(0, 2, 3))
    cast = lambda t, like: None if t is None else t.to(like.dtype)
    return (dq.to(q.dtype), cast(dk, k), cast(dv, v), cast(dkg, k_glo), cast(dvg, v_glo),
            dbias)


def vil_attention_reference(q, k, v, k_glo, v_glo, bias, mask_add, num_heads: int,
                            with_lse: bool = False):
    """Plain PyTorch version: the same function in f32, through the
    neighbourhood-concat matmuls of ``ops.sliding_chunk``; the output is
    rounded to q's dtype. With ``with_lse`` it returns (out, lse)."""
    return chunk_attention_reference(q, k, v, k_glo, v_glo, bias, mask_add, num_heads, 0,
                                     with_lse)


def vil_attention_bwd_reference(q, k, v, k_glo, v_glo, bias, g, mask_add, num_heads: int):
    """Plain PyTorch version of the backward: autograd through
    :func:`vil_attention_reference` in f32. Returns (dq, dk, dv, dk_glo,
    dv_glo, dbias), each in its operand's dtype, None where the operand is."""
    return chunk_attention_bwd_reference(q, k, v, k_glo, v_glo, bias, g, mask_add,
                                         num_heads, 0)


def check_f32_shared_memory(w2: int, head_dim: int, backward: bool) -> None:
    """Raise ValueError, naming the shape, where an f32 CUDA-core body (the
    forward, or the backward's larger pass) would ask a block for more shared
    memory than the card has: W² rows of ``head_dim`` (W 12 at head dim
    128, W 9 at 128 in the backward). Held on every device, as the head dims
    are, so that a CPU run refuses what the card would."""
    body, floats = (("backward pass 2", 6 * head_dim + 4) if backward else
                    ("forward", 4 * head_dim + 3))
    need = 4 * w2 * floats
    if need > SMEM_PER_BLOCK:
        raise ValueError(
            f"the f32 sliding-chunk {body} at W² {w2} rows and head dim {head_dim} needs "
            f"{need} bytes of shared memory a block, more than the {SMEM_PER_BLOCK} an H100 "
            f"block may use: run it in bf16 (the tensor-core kernels take it), or with a "
            f"smaller window or head dim")


def check_operands(q, k, v, k_glo, v_glo, bias, mask_add, num_heads, span: int = 9,
                   halo: bool = False):
    """Raise on what the kernels do not take; ``span`` is the number of key
    chunks per query chunk (9 here, 2 for the sampled-neighbour kernels);
    with ``halo`` k and v hold two chunk rows more than q."""
    if q.dim() != 5:
        raise ValueError(f"q must be 5-D (B, mx, my, W², C), got {tuple(q.shape)}")
    kv_shape = (q.shape[0], q.shape[1] + 2 * halo, *q.shape[2:])
    if k.shape != kv_shape or v.shape != kv_shape:
        raise ValueError(f"k, v must be {kv_shape} for q {tuple(q.shape)}, got "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, mx, my, w2, C = q.shape
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"dtype {q.dtype} is not supported (float32, bfloat16)")
    if C % num_heads or C // num_heads not in HEAD_DIMS:
        raise ValueError(f"head dim {C}/{num_heads} is not one of {HEAD_DIMS}")
    if q.dtype == torch.float32:
        check_f32_shared_memory(w2, C // num_heads, backward=False)
    if (k_glo is None) != (v_glo is None):
        raise ValueError("k_glo and v_glo must both be given or both be None")
    nglo = 0 if k_glo is None else k_glo.shape[1]
    cols = nglo + span * w2
    tensors = [q, k, v]
    if k_glo is not None:
        if k_glo.shape != (B, nglo, C) or v_glo.shape != (B, nglo, C) or nglo == 0:
            raise ValueError(f"k_glo, v_glo must be ({B}, Nglo>0, {C}), got "
                             f"{tuple(k_glo.shape)}, {tuple(v_glo.shape)}")
        tensors += [k_glo, v_glo]
    if any(t.dtype != q.dtype for t in tensors):
        raise TypeError("q, k, v, k_glo, v_glo must share one dtype")
    if bias is not None:
        if bias.shape != (num_heads, w2, cols) or bias.dtype != torch.float32:
            raise ValueError(f"bias must be float32 ({num_heads}, {w2}, {cols}), "
                             f"got {bias.dtype} {tuple(bias.shape)}")
        tensors.append(bias)
    if (mask_add.dim() != 4 or mask_add.shape[:2] != (mx, my)
            or mask_add.shape[2] not in (1, w2) or mask_add.shape[3] != cols
            or mask_add.dtype != torch.float32):
        raise ValueError(f"mask must be float32 ({mx}, {my}, 1|{w2}, {cols}), "
                         f"got {mask_add.dtype} {tuple(mask_add.shape)}")
    tensors.append(mask_add)
    if any(t.device != q.device for t in tensors):
        raise ValueError("all operands must be on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("all operands must be contiguous")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"device {q.device} is not supported")


def check_grad_operands(q, g, lse, num_heads, out=None, takes_out=False):
    """Raise unless g matches q, lse is the forward's f32 (B, H, mx, my, W²)
    and, for a backward that ``takes_out`` (B2, B6, B7b), the forward's ``out``
    is given and matches q."""
    B, mx, my, w2, C = q.shape
    if q.dtype == torch.float32:
        check_f32_shared_memory(w2, C // num_heads, backward=True)
    if takes_out and out is None:
        raise ValueError("this backward takes the forward's out")
    for name, t in (("g", g), ("out", out)):
        if t is not None and (t.shape != q.shape or t.dtype != q.dtype or t.device != q.device
                              or not t.is_contiguous()):
            raise ValueError(f"{name} must match q and be contiguous: {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    if (lse.shape != (B, num_heads, mx, my, w2) or lse.dtype != torch.float32
            or lse.device != q.device):
        raise ValueError(f"lse must be float32 {(B, num_heads, mx, my, w2)} on {q.device}, "
                         f"got {lse.dtype} {tuple(lse.shape)}")
    if not lse.is_contiguous():
        raise ValueError("lse must be contiguous")


def _ptr(t):
    return None if t is None else t.data_ptr()


SMS = 132  # an H100's SMs: the biased backward passes size their grids by it


def chunk_group(B: int, mx: int, my: int, w2: int, num_heads: int) -> int:
    """Chunks a block of B2's biased pass 1 walks (the kernel's
    ``chunks_per_block``): the longest walk that leaves an image's mx·my
    chunks in enough groups for a grid (groups × 64-row slices × H × B) of
    four blocks an SM, or one chunk a block where the chunks are fewer. 63
    on ViL-Small 1024²'s 37×37 grid at batch 8, H 3 (22 groups, 528 blocks,
    where one block an image left 24); 22 on 224²'s 8×8 grid at batch 64."""
    chunks, blocks = mx * my, B * num_heads * -(-w2 // 64)  # blocks of one group
    need = min(chunks, -(-4 * SMS // blocks))
    per = -(-chunks // need)
    while -(-chunks // per) < need:
        per -= 1
    return per


def group_partials(terms: torch.Tensor, per: int, dim: int) -> torch.Tensor:
    """Plain version of a biased pass 1's dbias partials: ``terms`` holds
    one dbias term per image (B4, ``dim`` 0) or per chunk (B2, ``dim`` 1),
    summed in consecutive groups of ``per`` along ``dim`` in the order a
    block walks them, the first term taken and each later one added."""
    parts = []
    for part in terms.split(per, dim=dim):
        acc = part.select(dim, 0)
        for i in range(1, part.shape[dim]):
            acc = acc + part.select(dim, i)
        parts.append(acc)
    return torch.stack(parts, dim=dim)


def _check_aligned(*tensors):
    """The bf16 tensor-core kernels copy rows 16 bytes at a time (None: an
    absent operand)."""
    if any(t is not None and t.data_ptr() % 16 for t in tensors):
        raise ValueError("bf16 operands must start on a 16-byte boundary")


def launch_fwd(entry: str, q, k, v, k_glo, v_glo, bias, mask_add, num_heads: int,
               with_lse: bool, *extra: int):
    """Launch the C forward ``entry`` (B1's signature, then ``extra`` ints)
    on q's card; returns (out, lse | None)."""
    B, mx, my, w2, C = q.shape
    nglo = 0 if k_glo is None else k_glo.shape[1]
    out = torch.empty_like(q)
    lse = (torch.empty(B, num_heads, mx, my, w2, device=q.device, dtype=torch.float32)
           if with_lse else None)
    with torch.cuda.device(q.device):
        err = getattr(build.load(), entry)(
            _ptr(q), _ptr(k), _ptr(v), _ptr(k_glo), _ptr(v_glo), _ptr(bias),
            _ptr(mask_add), _ptr(out), _ptr(lse), B, mx, my, w2, C, num_heads, nglo,
            mask_add.shape[2], *extra, int(q.dtype == torch.bfloat16), int(bf16_exp()),
            torch.cuda.current_stream().cuda_stream,
        )
    build.check(err, entry)
    return out, lse


def launch_bwd(entry: str, span: int, q, k, v, k_glo, v_glo, bias, g, mask_add, lse,
               num_heads: int, *extra: int, out=None, groups: int = 1):
    """Launch the C backward ``entry`` (B7b's signature, then ``extra``
    ints; the forward's ``out`` after g where the entry takes it) over
    ``span`` key chunks per query chunk; returns (dq, dk, dv, dk_glo,
    dv_glo, dbias). dK_glo and dV_glo come from the kernel's P_glo and
    dS_glo columns by one einsum each; dbias is the sum over images and
    ``groups`` chunk groups of the kernel's partials, in that order."""
    B, mx, my, w2, C = q.shape
    H = num_heads
    nglo = 0 if k_glo is None else k_glo.shape[1]
    cols = nglo + span * w2
    f32 = dict(device=q.device, dtype=torch.float32)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty(B, H, mx, my, w2, **f32)
    p_glo = torch.empty(B, H, mx, my, w2, nglo, **f32) if nglo else None
    ds_glo = torch.empty(B, H, mx, my, w2, nglo, **f32) if nglo else None
    dbias_part = torch.zeros(B, groups, H, w2, cols, **f32) if bias is not None else None
    with torch.cuda.device(q.device):
        err = getattr(build.load(), entry)(
            _ptr(q), _ptr(k), _ptr(v), _ptr(k_glo), _ptr(v_glo), _ptr(g),
            *(() if out is None else (_ptr(out),)), _ptr(bias),
            _ptr(mask_add), _ptr(lse), _ptr(delta), _ptr(dq), _ptr(dk), _ptr(dv),
            _ptr(p_glo), _ptr(ds_glo), _ptr(dbias_part), B, mx, my, w2, C, H, nglo,
            mask_add.shape[2], *extra, int(q.dtype == torch.bfloat16), int(bf16_exp()),
            torch.cuda.current_stream().cuda_stream,
        )
    build.check(err, entry)
    dkg = dvg = None
    if nglo:
        M = C // H
        q6 = q.reshape(B, mx, my, w2, H, M).float()
        g6 = g.reshape(B, mx, my, w2, H, M).float()
        dkg = torch.einsum("bhxylt,bxylhm->bthm", ds_glo, q6).reshape(B, nglo, C)
        dvg = torch.einsum("bhxylt,bxylhm->bthm", p_glo, g6).reshape(B, nglo, C)
        dkg, dvg = dkg.to(k_glo.dtype), dvg.to(v_glo.dtype)
    dbias = None if bias is None else dbias_part.view(B * groups, H, w2, cols).sum(dim=0)
    return dq, dk, dv, dkg, dvg, dbias


def vil_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      k_glo: Optional[torch.Tensor], v_glo: Optional[torch.Tensor],
                      bias: Optional[torch.Tensor], mask_add: torch.Tensor,
                      num_heads: int, with_lse: bool = False):
    """Sliding-chunk attention forward. On a CUDA device this launches the
    hand-written kernel (or raises); on the CPU it runs the plain version.
    With ``with_lse`` it returns (out, lse). It records no gradient: the
    differentiable form is :func:`vil_attention`."""
    check_operands(q, k, v, k_glo, v_glo, bias, mask_add, num_heads)
    if q.device.type == "cpu":
        with torch.no_grad():
            return vil_attention_reference(q, k, v, k_glo, v_glo, bias, mask_add,
                                           num_heads, with_lse)
    if q.dtype == torch.bfloat16:  # the tensor-core kernel
        _check_aligned(q, k, v, k_glo, v_glo)
    out, lse = launch_fwd("vil_attention_fwd", q, k, v, k_glo, v_glo, bias, mask_add,
                          num_heads, with_lse)
    vil_attention_fwd.launches += 1
    return (out, lse) if with_lse else out


vil_attention_fwd.launches = 0


def vil_attention_bwd(q, k, v, k_glo, v_glo, bias, g, out, mask_add, lse, num_heads: int):
    """Sliding-chunk attention backward from the forward's ``out`` and
    ``lse``: returns (dq, dk, dv, dk_glo, dv_glo, dbias), None where the
    operand is. On a CUDA device this launches the hand-written kernels (or
    raises); the bf16 ones take δ = rowsum(g ∘ out). On the CPU it runs the
    plain version, which recomputes the softmax and reads neither ``out`` nor
    ``lse``. With a bias, pass 1 runs a block per group of
    :func:`chunk_group` chunks, each with its own dbias partial."""
    check_operands(q, k, v, k_glo, v_glo, bias, mask_add, num_heads)
    check_grad_operands(q, g, lse, num_heads, out, takes_out=True)
    if q.device.type == "cpu":
        return vil_attention_bwd_reference(q, k, v, k_glo, v_glo, bias, g, mask_add,
                                           num_heads)
    if q.dtype == torch.bfloat16:  # the tensor-core kernels
        _check_aligned(q, k, v, k_glo, v_glo, g, out)
    B, mx, my, w2, _ = q.shape
    per = chunk_group(B, mx, my, w2, num_heads) if bias is not None else 1
    grads = launch_bwd("vil_attention_bwd", 9, q, k, v, k_glo, v_glo, bias, g, mask_add,
                       lse, num_heads, per, out=out, groups=-(-mx * my // per))
    vil_attention_bwd.launches += 1
    return grads


vil_attention_bwd.launches = 0


class VilAttentionFunction(torch.autograd.Function):
    """Sliding-chunk attention with the hand-written backward: the forward
    keeps its output and per-row log-sum-exp, the backward launches
    :func:`vil_attention_bwd` from them."""

    @staticmethod
    def forward(ctx, q, k, v, k_glo, v_glo, bias, mask_add, num_heads):
        out, lse = vil_attention_fwd(q, k, v, k_glo, v_glo, bias, mask_add, num_heads,
                                     with_lse=True)
        ctx.save_for_backward(q, k, v, k_glo, v_glo, bias, mask_add, out, lse)
        ctx.num_heads = num_heads
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, k_glo, v_glo, bias, mask_add, out, lse = ctx.saved_tensors
        grads = vil_attention_bwd(q, k, v, k_glo, v_glo, bias, g.contiguous(), out, mask_add,
                                  lse, ctx.num_heads)
        return (*grads, None, None)


def vil_attention(q, k, v, k_glo, v_glo, bias, mask_add, num_heads: int) -> torch.Tensor:
    """Sliding-chunk attention through the kernels: the forward alone where
    no gradient is needed, else :class:`VilAttentionFunction`."""
    operands = (q, k, v, k_glo, v_glo, bias)
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in operands):
        return VilAttentionFunction.apply(q, k, v, k_glo, v_glo, bias, mask_add, num_heads)
    return vil_attention_fwd(q, k, v, k_glo, v_glo, bias, mask_add, num_heads)
