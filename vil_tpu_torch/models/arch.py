"""ARCH-string parser: the MsViT model-definition DSL.

A copy of ``vil_tpu/models/arch.py`` (pure Python, so the port runs on a host
without JAX); ``tests/test_torch_ops.py`` checks that the two agree.

Format: per-stage groups joined by ``_``, each group a comma-separated list of
``<letter><int>`` attributes (reference src/models/msvit.py:402-410
and README.md:34-57). Semantics:

    l  stage id (must equal its position, 1-based)
    h  number of attention heads
    d  embedding dim
    n  number of transformer blocks in the stage
    s  1 = use the configured sparse attention for this stage, 0 = force full
    g  number of global tokens
    p  patch / downsample factor of the stage's patch embedding
    f  "num_feats": longformer window w | linformer/performer feature count |
       srformer reduction ratio (fan-out at reference msvit.py:457-459)
    a  1 = absolute positional embedding, 0 = relative positional bias
"""
from __future__ import annotations

import dataclasses

_DEFAULTS = {"l": 1, "h": 3, "d": 192, "n": 1, "s": 1, "g": 1, "p": 2, "f": 7, "a": 1}


@dataclasses.dataclass(frozen=True)
class StageCfg:
    """Parsed configuration of one MsViT stage."""

    layer_id: int
    num_heads: int
    dim: int
    num_blocks: int
    is_sparse_attn: int
    nglo: int
    patch_size: int
    num_feats: int
    ape: int

    @property
    def rpe(self) -> bool:
        # rpe = not ape (reference msvit.py:470)
        return not bool(self.ape)


def parse_arch(arch: str) -> list[StageCfg]:
    """Parse an ARCH string into per-stage configs.

    Identical defaulting behavior to the reference parser
    (msvit.py:402-410): unknown keys raise, missing keys take defaults.
    """
    stages = []
    for pos, layer in enumerate(arch.split("_"), start=1):
        layer_cfg = dict(_DEFAULTS)
        for attr in layer.split(","):
            if not attr:
                raise ValueError(f"Empty attribute in ARCH stage {pos!r}")
            key, val = attr[0], attr[1:]
            if key not in layer_cfg:
                raise ValueError(f"Unknown ARCH attribute {key!r} in {layer!r}")
            layer_cfg[key] = int(val)
        if layer_cfg["l"] != pos:
            # reference asserts layerid == position (msvit.py:450)
            raise ValueError(
                f"ARCH stage id l{layer_cfg['l']} does not match position {pos}"
            )
        stages.append(
            StageCfg(
                layer_id=layer_cfg["l"],
                num_heads=layer_cfg["h"],
                dim=layer_cfg["d"],
                num_blocks=layer_cfg["n"],
                is_sparse_attn=layer_cfg["s"],
                nglo=layer_cfg["g"],
                patch_size=layer_cfg["p"],
                num_feats=layer_cfg["f"],
                ape=layer_cfg["a"],
            )
        )
    if len(stages) not in (3, 4):
        # reference supports exactly 3- or 4-stage models (msvit.py:430-437)
        raise ValueError(f"MsViT supports 3 or 4 stages, got {len(stages)}")
    return stages


# Canonical model sizes: exact ARCH strings of the released checkpoints'
# eval commands (reference README.md:210-239; sizes table README.md:61-68).
ARCH_ZOO = {
    "vil_tiny": "l1,h1,d48,n1,s1,g1,p4,f7_l2,h3,d96,n1,s1,g1,p2,f7_l3,h3,d192,n9,s0,g1,p2,f7_l4,h6,d384,n1,s0,g0,p2,f7",
    "vil_small": "l1,h3,d96,n1,s1,g1,p4,f7_l2,h3,d192,n2,s1,g1,p2,f7_l3,h6,d384,n8,s0,g1,p2,f7_l4,h12,d768,n1,s0,g0,p2,f7",
    "vil_medium_deep": "l1,h3,d96,n1,s1,g1,p4,f7_l2,h3,d192,n4,s1,g1,p2,f7_l3,h6,d384,n16,s0,g1,p2,f7_l4,h12,d768,n1,s0,g0,p2,f7",
    "vil_medium_wide": "l1,h3,d192,n1,s1,g1,p4,f7_l2,h6,d384,n2,s1,g1,p2,f7_l3,h8,d512,n8,s0,g1,p2,f7_l4,h12,d768,n1,s0,g0,p2,f7",
    # 384² finetune variants adjust window sizes f per stage (README.md:233-239)
    "vil_medium_wide_384": "l1,h3,d192,n1,s1,g1,p4,f8_l2,h6,d384,n2,s1,g1,p2,f12_l3,h8,d512,n8,s0,g1,p2,f7_l4,h12,d768,n1,s0,g0,p2,f7",
    "vil_base_deep_384": "l1,h3,d96,n1,s1,g1,p4,f6_l2,h3,d192,n8,s1,g1,p2,f8_l3,h6,d384,n24,s0,g1,p2,f7_l4,h12,d768,n1,s0,g0,p2,f7",
    "vil_base_wide_384": "l1,h3,d192,n1,s1,g1,p4,f8_l2,h6,d384,n2,s1,g1,p2,f8_l3,h12,d768,n8,s0,g1,p2,f7_l4,h16,d1024,n1,s0,g0,p2,f7",
    "vil_base_deep": "l1,h3,d96,n1,s1,g1,p4,f7_l2,h3,d192,n8,s1,g1,p2,f7_l3,h6,d384,n24,s0,g1,p2,f7_l4,h12,d768,n1,s0,g0,p2,f7",
}
