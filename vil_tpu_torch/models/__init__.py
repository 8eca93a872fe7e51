"""Model registry: the MsViT family (counterpart of ``vil_tpu/models``)."""
from __future__ import annotations

import os

import torch

from .arch import ARCH_ZOO, StageCfg, parse_arch
from .attention import RelativePositionBias
from .msvit import NO_WEIGHT_DECAY_SUBSTRINGS, MsViT


def build_model(cfg, dtype=None, device=None, use_kernels=None,
                generator=None, param_dtype=None, fused_block=None) -> MsViT:
    """Construct the model from a config tree, read by attribute as
    ``vil_tpu.models.build_model`` reads it (MODEL.ARCH may name an
    ``ARCH_ZOO`` entry or ``msvit``; the tree is not modified).

    ``dtype``, the type of the computation, defaults to TPU.COMPUTE_DTYPE;
    the parameters are kept in ``param_dtype``, by default TPU.PARAM_DTYPE
    (float32 in the JAX package's defaults). ``use_kernels`` defaults to
    TPU.USE_PALLAS: the hand-written kernels, or their plain versions. An
    argument that is given wins over the tree. The model is built on the
    CUDA card unless ``device`` names another (``device="cpu"``).

    The fused-kernel configuration, as the JAX package selects it:
    TPU.FUSED_LN (with the kernels) puts the LayerNorm kernels in the block
    pre-norms, and ``fused_block`` the fused attention block at mode 0; it
    defaults to the environment variable ``VIL_TPU_FUSED_BLOCK`` being "1",
    read at each call, the switch of ``vil_tpu.models.attention``."""
    if fused_block is None:
        fused_block = os.environ.get("VIL_TPU_FUSED_BLOCK", "0") == "1"
    name = cfg.MODEL.ARCH
    if name in ARCH_ZOO:
        arch = ARCH_ZOO[name]
    elif name.startswith("msvit"):
        arch = cfg.MODEL.VIT.MSVIT.ARCH
    else:
        raise ValueError(f"Unimplemented model architecture: {name}")
    if dtype is None:
        dtype = torch.bfloat16 if cfg.TPU.COMPUTE_DTYPE == "bfloat16" else torch.float32
    if param_dtype is None:
        param_dtype = torch.bfloat16 if cfg.TPU.PARAM_DTYPE == "bfloat16" else torch.float32
    if use_kernels is None:
        use_kernels = bool(cfg.TPU.USE_PALLAS)
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
        share_kv=msvit.SHARE_KV,
        only_glo=msvit.ONLY_GLOBAL,
        sw_exact=msvit.SW_EXACT,
        ln_eps=msvit.LN_EPS,
        mode=msvit.MODE,
        use_kernels=use_kernels,
        fused_ln=bool(cfg.TPU.FUSED_LN) and use_kernels,
        fused_block=bool(fused_block),
        device=device,
        dtype=dtype,
        param_dtype=param_dtype,
        generator=generator,
    )


def precompute_rpe_cache(model: torch.nn.Module) -> torch.nn.Module:
    """Serving helper (counterpart of ``vil_tpu.models.precompute_rpe_cache``):
    assemble every relative-position block's mode-0 bias once, so that eval
    forwards read it instead of assembling it per call; the dense blocks'
    and the sliding-chunk blocks' alike. Returns ``model``.

    Training never reads the cache (it would cut the tables' gradients), nor
    does an eval forward that takes a gradient to the tables. A cache built
    before a table changes is never served: a block whose tables have a new
    version or storage since (``load_jax_params``, an optimizer step,
    ``.to()``) drops its cache and assembles the bias afresh; call this again
    to cache the new one."""
    for mod in model.modules():
        if isinstance(mod, RelativePositionBias):
            mod.cache_rpe_bias()
    return model


__all__ = ["ARCH_ZOO", "MsViT", "NO_WEIGHT_DECAY_SUBSTRINGS", "StageCfg", "build_model",
           "parse_arch", "precompute_rpe_cache"]
