"""Attention modules for MsViT.

Counterpart of ``vil_tpu/models/attention.py`` for the inference slice:

* ``FullAttention`` — dense multi-head self-attention without RPE, through
  the dense attention kernel (``ops/kernels/full_attention.py``).
* ``VilAttention``  — 2-D sliding-chunk local attention with global tokens at
  neighbour mode 0 without RPE, on the stage-resident chunked layout. The
  local branch runs the sliding-chunk kernel (``ops/kernels/vil_attention.py``);
  the global tokens' dense attention over all tokens is plain PyTorch.

q is scaled by M^-½ before either kernel. ``use_kernels=False`` calls the
kernels' plain versions directly instead of the kernel wrappers.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import masks as masks_lib
from ..ops import sliding_chunk as sc
from ..ops.kernels.full_attention import full_attention_fwd, full_attention_reference
from ..ops.kernels.vil_attention import (
    mask_to_additive,
    vil_attention_fwd,
    vil_attention_reference,
)
from .layers import check_eval_only


def _linear_part(layer: nn.Linear, part: int, n_parts: int, x: torch.Tensor):
    """Output slice ``part`` of ``layer(x)``, computed alone so that it comes
    out contiguous (the kernels take contiguous q, k and v)."""
    out = layer.out_features // n_parts
    rows = slice(part * out, (part + 1) * out)
    return F.linear(x, layer.weight[rows], layer.bias[rows])


class FullAttention(nn.Module):
    """Dense multi-head self-attention (no RPE)."""

    def __init__(self, dim: int, num_heads: int, attn_drop: float = 0.0,
                 proj_drop: float = 0.0, use_kernels: bool = True, device=None,
                 dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.dim, self.num_heads = dim, num_heads
        self.attn_drop, self.proj_drop = attn_drop, proj_drop
        self.use_kernels = use_kernels
        self.qkv = nn.Linear(dim, 3 * dim, **kw)
        self.proj = nn.Linear(dim, dim, **kw)

    def forward(self, x: torch.Tensor, nx: int, ny: int) -> torch.Tensor:
        check_eval_only(self, self.attn_drop, "attention dropout")
        check_eval_only(self, self.proj_drop, "projection dropout")
        H = self.num_heads
        scale = (self.dim // H) ** -0.5
        q = _linear_part(self.qkv, 0, 3, x) * scale
        k = _linear_part(self.qkv, 1, 3, x)
        v = _linear_part(self.qkv, 2, 3, x)
        attend = full_attention_fwd if self.use_kernels else full_attention_reference
        return self.proj(attend(q, k, v, None, H))


class VilAttention(nn.Module):
    """2-D sliding-chunk self-attention with global tokens, neighbour mode 0,
    shared local/global weights, no RPE.

    ``forward`` takes and returns the stage-resident chunked pair
    ``(x_glo (B, Nglo, C) | None, x_img (B, mx, my, W², C))``.
    ``exact`` selects the mask semantics (SW_EXACT 1, 0 or -1).
    """

    def __init__(self, dim: int, num_heads: int, w: int = 7,
                 attn_drop: float = 0.0, proj_drop: float = 0.0, nglo: int = 1,
                 exact: int = 0, use_kernels: bool = True, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.dim, self.num_heads, self.w, self.nglo = dim, num_heads, w, nglo
        self.exact = exact
        self.attn_drop, self.proj_drop = attn_drop, proj_drop
        self.use_kernels = use_kernels
        self.query = nn.Linear(dim, dim, **kw)
        self.kv = nn.Linear(dim, 2 * dim, **kw)
        self.proj = nn.Linear(dim, dim, **kw)
        self._masks: dict = {}  # (nx, ny, device) → additive mask table

    def _mask(self, nx: int, ny: int, device) -> torch.Tensor:
        """Additive f32 mask (mx, my, Wq, Nglo+9W²), built once per grid and
        device (the model may be cast to bf16; the table stays f32)."""
        key = (nx, ny, str(device))
        if key not in self._masks:
            W = self.w
            padx, pady, mx, my = sc.chunk_grid(nx, ny, W)
            mask_bool = masks_lib.invalid_mask(mx, my, padx, pady, W, self.exact, 0)
            self._masks[key] = torch.from_numpy(
                mask_to_additive(mask_bool, mx, my, W * W, self.nglo)
            ).to(device)
        return self._masks[key]

    def forward(self, x, nx: int, ny: int):
        check_eval_only(self, self.attn_drop, "attention dropout")
        check_eval_only(self, self.proj_drop, "projection dropout")
        x_glo, x_img = x
        B, mx, my, W2, C = x_img.shape
        H, Nglo = self.num_heads, self.nglo
        M = C // H
        if (0 if x_glo is None else x_glo.shape[1]) != Nglo:
            raise ValueError(f"expected {Nglo} global tokens")
        scale = M ** -0.5

        q_img = self.query(x_img) * scale  # (B, mx, my, W², C)
        k_img = _linear_part(self.kv, 0, 2, x_img)
        v_img = _linear_part(self.kv, 1, 2, x_img)
        kg = vg = None
        if Nglo >= 1:
            kg = _linear_part(self.kv, 0, 2, x_glo)  # (B, Nglo, C)
            vg = _linear_part(self.kv, 1, 2, x_glo)

        attend = vil_attention_fwd if self.use_kernels else vil_attention_reference
        x1 = attend(q_img, k_img, v_img, kg, vg, None,
                    self._mask(nx, ny, x_img.device), H)
        x1 = self.proj(x1)
        if Nglo == 0:
            return None, x1

        # global branch: the global queries attend densely over all tokens.
        # The local keys stay in chunk order (softmax over keys does not care
        # about their order) and the softmax over [glo ‖ local] is taken in
        # two parts that share one max and one denominator; pad positions of
        # a padded chunk grid are masked.
        f32 = torch.float32
        qg = (self.query(x_glo) * scale).reshape(B, Nglo, H, M)
        k6 = k_img.reshape(B, mx, my, W2, H, M)
        v6 = v_img.reshape(B, mx, my, W2, H, M)
        kg4, vg4 = kg.reshape(B, Nglo, H, M), vg.reshape(B, Nglo, H, M)
        s_loc = torch.einsum("bxylhm,bghm->bxylhg", k6, qg).to(f32)
        s_glo = torch.einsum("bthm,bghm->bthg", kg4, qg).to(f32)
        if mx * my * W2 != nx * ny:
            valid = torch.from_numpy(masks_lib.chunk_valid(nx, ny, self.w))
            s_loc = s_loc.masked_fill(
                ~valid.to(s_loc.device)[None, :, :, :, None, None], float("-inf")
            )
        m0 = torch.maximum(s_loc.amax(dim=(1, 2, 3)), s_glo.amax(dim=1))  # (B, H, Nglo)
        e_loc = torch.exp(s_loc - m0[:, None, None, None])
        e_glo = torch.exp(s_glo - m0[:, None])
        den = e_loc.sum(dim=(1, 2, 3)) + e_glo.sum(dim=1)
        p_loc = (e_loc / den[:, None, None, None]).to(x_img.dtype)
        p_glo = (e_glo / den[:, None]).to(x_img.dtype)
        x0 = (torch.einsum("bxylhg,bxylhm->bghm", p_loc, v6).to(f32)
              + torch.einsum("bthg,bthm->bghm", p_glo, vg4).to(f32))
        x0 = self.proj(x0.to(x_img.dtype).reshape(B, Nglo, C))
        return x0, x1
