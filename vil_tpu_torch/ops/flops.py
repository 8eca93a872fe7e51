"""Analytic MACs/params accounting: a copy of ``vil_tpu/ops/flops.py``
(the reference's ``compute_macs`` static methods: msvit.py:122-156,
longformer2d.py:231-280, performer.py:173-205, srformer.py:60-114, plus
hook-based conv/linear counting).

Pure config-time arithmetic over the parsed ARCH, for every attention family
and ``sharew``/``share_kv``. "MACs" = multiply-accumulate counted once (the
convention behind the README's G-FLOPs model cards). It imports only
``..models.arch``; ``tests/test_torch_efficient.py`` holds it equal to the
JAX package's.
"""
from __future__ import annotations

import dataclasses

from ..models.arch import StageCfg, parse_arch


@dataclasses.dataclass
class MacCount:
    macs: int = 0
    params: int = 0

    def add(self, macs: int, params: int = 0):
        self.macs += int(macs)
        self.params += int(params)


def _linear(count: MacCount, tokens: int, cin: int, cout: int, bias=True):
    count.add(tokens * cin * cout, cin * cout + (cout if bias else 0))


def _attention_macs(count: MacCount, attn_type: str, stage: StageCfg,
                    nloc: int, dim: int, sharew: bool, share_kv: bool):
    nglo = stage.nglo
    n = nloc + nglo
    w = stage.num_feats
    if attn_type == "full":
        _linear(count, n, dim, 3 * dim)  # qkv
        count.add(2 * n * n * dim)  # QK^T + PV
        _linear(count, n, dim, dim)  # proj
        return
    if attn_type in ("longformerhand", "longformerauto", "longformer_cuda"):
        kv_span = 9 * w * w
        _linear(count, nloc, dim, dim)  # query (local)
        _linear(count, n, dim, 2 * dim)  # kv (all tokens)
        count.add(nloc * kv_span * dim * 2)  # sliding-chunk qk + av
        count.add(nloc * nglo * dim * 2)  # l2g scores + av
        _linear(count, nloc, dim, dim)  # proj
        if nglo >= 1:
            # global branch: dense over all tokens
            gcount = MacCount()
            _linear(gcount, nglo, dim, dim)  # query_global
            _linear(gcount, n, dim, 2 * dim)  # kv_global
            gcount.add(2 * nglo * n * dim)
            _linear(gcount, nglo, dim, dim)  # proj_global
            count.macs += gcount.macs
            # shared projections add no extra params
            count.params += 0 if sharew else gcount.params
        return
    if attn_type == "linformer":
        k = stage.num_feats
        _linear(count, n, dim, dim)  # query
        _linear(count, n, dim, 2 * dim)  # kv
        count.add(2 * n * k * dim, n * k * (1 if share_kv else 2))  # seq proj
        count.add(2 * n * k * dim)  # attn + av
        _linear(count, n, dim, dim)  # proj
        return
    if attn_type == "srformer":
        r = stage.num_feats
        red = (nloc // (r * r)) if r > 0 else nloc
        kv_len = n - nloc + red
        _linear(count, n, dim, dim)  # query
        count.add(red * r * r * dim * dim, r * r * dim * dim)  # proj_sr conv
        _linear(count, kv_len, dim, 2 * dim)  # kv
        count.add(2 * n * kv_len * dim)  # attn + av
        _linear(count, n, dim, dim)  # proj
        return
    if attn_type == "performer":
        nf = stage.num_feats
        _linear(count, n, dim, 3 * dim)  # qkv
        count.add(2 * n * nf * dim, nf * (dim // stage.num_heads))  # feature maps
        count.add(3 * n * nf * dim)  # context + out (linear attention)
        _linear(count, n, dim, dim)  # proj
        return
    raise ValueError(f"unknown attention type {attn_type}")


def model_macs(arch: str, img_size: int = 224, attn_type: str = "longformerhand",
               num_classes: int = 1000, in_chans: int = 3, sharew: bool = True,
               share_kv: bool = True, mlp_ratio: float = 4.0,
               ape_params: bool = True) -> dict:
    """Total inference MACs + params of an MsViT config."""
    stages = parse_arch(arch)
    count = MacCount()
    per_stage = []
    nx = ny = img_size
    cin = in_chans
    sticky_full = False  # s=0 is sticky in the reference (msvit.py:460-461)
    for s in stages:
        before = MacCount(count.macs, count.params)
        nx //= s.patch_size
        ny //= s.patch_size
        nloc = nx * ny
        n = nloc + s.nglo
        # patch-embed conv
        count.add(
            nloc * s.patch_size * s.patch_size * cin * s.dim,
            s.patch_size * s.patch_size * cin * s.dim + s.dim,
        )
        # norm_embed + pos embeds (params only)
        count.add(0, 2 * s.dim)
        if s.ape:
            count.add(0, s.nglo * s.dim + (nx + ny) * (s.dim // 2))
        if s.nglo:
            count.add(0, s.nglo * s.dim)
        sticky_full = sticky_full or not s.is_sparse_attn
        stage_attn = "full" if sticky_full else attn_type
        for _ in range(s.num_blocks):
            count.add(0, 2 * s.dim)  # attn norm
            _attention_macs(count, stage_attn, s, nloc, s.dim, sharew, share_kv)
            if s.rpe:
                w = s.num_feats
                if stage_attn.startswith("longformer"):
                    count.add(0, (4 * w - 1) ** 2 * s.num_heads)
                else:
                    count.add(0, (2 * nx - 1) * (2 * ny - 1) * s.num_heads)
                if s.nglo >= 1:
                    count.add(0, 2 * s.num_heads * s.nglo
                              + s.num_heads * s.nglo * s.nglo)
            count.add(0, 2 * s.dim)  # mlp norm
            hidden = int(s.dim * mlp_ratio)
            _linear(count, n, s.dim, hidden)
            _linear(count, n, hidden, s.dim)
        per_stage.append(
            {"macs": count.macs - before.macs, "params": count.params - before.params,
             "grid": (nx, ny)}
        )
        cin = s.dim
    # final norm + head
    count.add(0, 2 * stages[-1].dim)
    _linear(count, 1, stages[-1].dim, num_classes)
    return {
        "macs": count.macs,
        "gmacs": count.macs / 1e9,
        "params": count.params,
        "mparams": count.params / 1e6,
        "per_stage": per_stage,
    }
