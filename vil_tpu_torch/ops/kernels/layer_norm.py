"""LayerNorm over the last axis: the Hopper kernels and their plain versions.

Counterpart of ``vil_tpu/ops/pallas/layer_norm.py``: of ``_ln_forward`` (the
forward kernel B8a) and ``_ln_bwd_rule`` (the backward kernel B8b), both in
``csrc/layer_norm.cu``; of the ``jax.custom_vjp`` ``layer_norm``
(:class:`LayerNormFunction`, :func:`layer_norm`) and of ``_xla_layer_norm``
(the plain version, :func:`layer_norm_reference`). For x (..., C) of any
leading shape:

    y  = (x - mean) · rsqrt(var + eps) · γ + β,   statistics and affine in f32
    dx = rstd · (γ·dy - mean_c(γ·dy) - x̂ · mean_c(γ·dy·x̂)),   dγ = Σ dy·x̂,  dβ = Σ dy

γ and β take part in f32 whatever their own type, and the result is rounded
to x's type once; dx comes out in x's type, dγ and dβ are summed in f32 and
cast to γ's type. Like the JAX kernel, the backward keeps only (x, γ) from
the forward and recomputes the statistics. The JAX package's wrapper falls
back to XLA for a row count that its tiles do not divide; the kernels here
take any row count.
"""
from __future__ import annotations

import torch

from . import build

MAX_C = 1024  # a row lives in one warp's registers: at most 32 values a lane


def layer_norm_reference(x, gamma, beta, eps: float = 1e-6):
    """Plain PyTorch version, ``_xla_layer_norm`` step by step: upcast to
    f32, mean, centred variance, rsqrt(var + eps), affine with f32 γ and β,
    one cast to x's type."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    xc = xf - mean
    var = (xc * xc).mean(dim=-1, keepdim=True)
    y = xc * torch.rsqrt(var + eps) * gamma.float() + beta.float()
    return y.to(x.dtype)


def layer_norm_bwd_reference(x, gamma, dy, eps: float = 1e-6):
    """Plain PyTorch version of the backward, the per-row formula of
    ``_ln_bwd_kernel``: (dx in x's type, dγ, dβ in γ's type)."""
    xf, dyf = x.float(), dy.float()
    mean = xf.mean(dim=-1, keepdim=True)
    xc = xf - mean
    rstd = torch.rsqrt((xc * xc).mean(dim=-1, keepdim=True) + eps)
    xhat = xc * rstd
    wdy = dyf * gamma.float()
    c1 = wdy.mean(dim=-1, keepdim=True)
    c2 = (wdy * xhat).mean(dim=-1, keepdim=True)
    dx = rstd * (wdy - c1 - xhat * c2)
    rows = dyf.reshape(-1, dyf.shape[-1])
    dgamma = (rows * xhat.reshape(rows.shape)).sum(dim=0)
    return dx.to(x.dtype), dgamma.to(gamma.dtype), rows.sum(dim=0).to(gamma.dtype)


def _check(x, gamma, beta=None, dy=None):
    """Raise on what the kernels do not take."""
    C = x.shape[-1]
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"dtype {x.dtype} is not supported (float32, bfloat16)")
    if not 0 < C <= MAX_C:
        raise ValueError(f"the last axis must hold 1..{MAX_C} values, got {C}")
    if gamma.shape != (C,) or (beta is not None and beta.shape != (C,)):
        raise ValueError(f"gamma and beta must be ({C},)")
    if dy is not None and (dy.shape != x.shape or dy.dtype != x.dtype):
        raise ValueError(f"dy must be {x.dtype} {tuple(x.shape)}, got {dy.dtype} "
                         f"{tuple(dy.shape)}")
    operands = [t for t in (x, gamma, beta, dy) if t is not None]
    if any(t.device != x.device for t in operands):
        raise ValueError("all operands must be on one device")
    if not x.is_contiguous() or not (dy is None or dy.is_contiguous()):
        raise ValueError("x and dy must be contiguous")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"device {x.device} is not supported")


def _f32(t: torch.Tensor) -> torch.Tensor:
    """t as contiguous f32, itself when it already is (no copy, no launch)."""
    return t if t.dtype == torch.float32 and t.is_contiguous() else t.float().contiguous()


def layer_norm_fwd(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                   eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm forward. On a CUDA device this launches the hand-written
    kernel (or raises); on the CPU it runs the plain version. It records no
    gradient: the differentiable form is :func:`layer_norm`."""
    _check(x, gamma, beta)
    if x.device.type == "cpu":
        with torch.no_grad():
            return layer_norm_reference(x, gamma, beta, eps)
    if x.device.index != torch.cuda.current_device():
        with torch.cuda.device(x.device):
            return layer_norm_fwd(x, gamma, beta, eps)
    C = x.shape[-1]
    y = torch.empty_like(x)
    g32, b32 = _f32(gamma), _f32(beta)
    err = build.load().layer_norm_fwd(
        x.data_ptr(), g32.data_ptr(), b32.data_ptr(), y.data_ptr(), x.numel() // C, C, eps,
        int(x.dtype == torch.bfloat16), build.stream(x.device))
    build.check(err, "layer_norm_fwd")
    layer_norm_fwd.launches += 1
    return y


layer_norm_fwd.launches = 0

# The backward's grid: 2 blocks of 256 threads an SM of the H100's 132 (the
# kernel keeps to 128 registers a thread for it), so that every block is
# resident at once and dγ, dβ come from few partials (8 KB each at
# C = 1024), each block over at least BWD_MIN_ROWS rows.
BWD_PARTIALS = 2 * 132
BWD_MIN_ROWS = 16


def bwd_geometry(rows: int) -> tuple[int, int]:
    """(blocks, rows_per_block) of the backward's grid for ``rows`` rows:
    block b takes rows [b · rows_per_block, (b + 1) · rows_per_block) ∩
    [0, rows), and writes partial b of the (blocks, 2, C) scratch."""
    blocks = min(BWD_PARTIALS, -(-rows // BWD_MIN_ROWS))
    per_block = -(-rows // blocks)
    return -(-rows // per_block), per_block


def layer_norm_bwd(x: torch.Tensor, gamma: torch.Tensor, dy: torch.Tensor,
                   eps: float = 1e-6):
    """LayerNorm backward: (dx, dγ, dβ), dx in x's type, dγ and dβ in γ's.
    On a CUDA device this launches the hand-written kernels (or raises); on
    the CPU it runs the plain version."""
    _check(x, gamma, dy=dy)
    if x.device.type == "cpu":
        return layer_norm_bwd_reference(x, gamma, dy, eps)
    if x.device.index != torch.cuda.current_device():
        with torch.cuda.device(x.device):
            return layer_norm_bwd(x, gamma, dy, eps)
    C = x.shape[-1]
    rows = x.numel() // C
    blocks, per_block = bwd_geometry(rows)
    dx = torch.empty_like(x)
    # one allocation: the (blocks, 2, C) partials, then dγ and dβ
    scratch = torch.empty((blocks + 1) * 2 * C, device=x.device, dtype=torch.float32)
    end = blocks * 2 * C
    dgamma, dbeta = scratch[end:end + C], scratch[end + C:]
    err = build.load().layer_norm_bwd(
        x.data_ptr(), _f32(gamma).data_ptr(), dy.data_ptr(), dx.data_ptr(), scratch.data_ptr(),
        dgamma.data_ptr(), rows, C, eps, blocks, per_block, int(x.dtype == torch.bfloat16),
        build.stream(x.device))
    build.check(err, "layer_norm_bwd")
    layer_norm_bwd.launches += 1
    if gamma.dtype != torch.float32:
        dgamma, dbeta = dgamma.to(gamma.dtype), dbeta.to(gamma.dtype)
    return dx, dgamma, dbeta


layer_norm_bwd.launches = 0


class LayerNormFunction(torch.autograd.Function):
    """LayerNorm with the hand-written backward; saves (x, γ) only."""

    @staticmethod
    def forward(ctx, x, gamma, beta, eps):
        ctx.save_for_backward(x, gamma)
        ctx.eps = eps
        return layer_norm_fwd(x, gamma, beta, eps)

    @staticmethod
    def backward(ctx, dy):
        x, gamma = ctx.saved_tensors
        dx, dgamma, dbeta = layer_norm_bwd(x, gamma, dy.contiguous(), ctx.eps)
        return dx, dgamma, dbeta, None


def layer_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm through the kernels: the forward alone where no gradient is
    needed, else :class:`LayerNormFunction`."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, gamma, beta)):
        return LayerNormFunction.apply(x, gamma, beta, eps)
    return layer_norm_fwd(x, gamma, beta, eps)
