"""Model registry: the MsViT family (counterpart of ``vil_tpu/models``)."""
from __future__ import annotations

import torch

from .arch import ARCH_ZOO, StageCfg, parse_arch
from .msvit import MsViT


def build_model(cfg, dtype=None, device=None, use_kernels: bool = True,
                generator=None) -> MsViT:
    """Construct the model from a config tree, read by attribute as
    ``vil_tpu.models.build_model`` reads it (MODEL.ARCH may name an
    ``ARCH_ZOO`` entry or ``msvit``; the tree is not modified).

    ``dtype`` defaults to TPU.COMPUTE_DTYPE; it is the type of the parameters
    and of the computation alike."""
    name = cfg.MODEL.ARCH
    if name in ARCH_ZOO:
        arch = ARCH_ZOO[name]
    elif name.startswith("msvit"):
        arch = cfg.MODEL.VIT.MSVIT.ARCH
    else:
        raise ValueError(f"Unimplemented model architecture: {name}")
    if dtype is None:
        dtype = torch.bfloat16 if cfg.TPU.COMPUTE_DTYPE == "bfloat16" else torch.float32
    msvit = cfg.MODEL.VIT.MSVIT
    return MsViT(
        arch=arch,
        img_size=cfg.INPUT.IMAGE_SIZE,
        num_classes=cfg.DATA.NUM_CLASSES,
        drop_rate=cfg.MODEL.VIT.DROP,
        drop_path_rate=cfg.MODEL.VIT.DROP_PATH,
        norm_embed=cfg.MODEL.VIT.NORM_EMBED,
        avg_pool=cfg.MODEL.VIT.AVG_POOL,
        input_mean=tuple(cfg.INPUT.MEAN),
        input_std=tuple(cfg.INPUT.STD),
        sharew=msvit.SHARE_W,
        attn_type=msvit.ATTN_TYPE,
        only_glo=msvit.ONLY_GLOBAL,
        sw_exact=msvit.SW_EXACT,
        ln_eps=msvit.LN_EPS,
        mode=msvit.MODE,
        use_kernels=use_kernels,
        device=device,
        dtype=dtype,
        generator=generator,
    )


__all__ = ["ARCH_ZOO", "MsViT", "StageCfg", "build_model", "parse_arch"]
