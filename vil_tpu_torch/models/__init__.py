"""Model registry: the MsViT family and the ResNet zoo (counterpart of
``vil_tpu/models``)."""
from __future__ import annotations

import logging
import os

import torch

from .arch import ARCH_ZOO, StageCfg, parse_arch
from .attention import RelativePositionBias
from .msvit import NO_WEIGHT_DECAY_SUBSTRINGS, MsViT
from .resnet import RESNET_ZOO, BatchNorm, ResNet, build_resnet

logger = logging.getLogger(__name__)


def _resnet(cfg, name, dtype, device, generator, param_dtype, mesh) -> ResNet:
    """``vil_tpu``'s route for a ``RESNET_ZOO`` name: MODEL.PRETRAINED
    raises (it would need torchvision's hub), the computation in
    TPU.COMPUTE_DTYPE, the parameters in f32 (``vil_tpu`` passes no
    PARAM_DTYPE to its ResNet); on a data axis of several replicas, or a
    spatial axis, every BatchNorm takes the global batch's statistics over
    the whole image, over the ranks that hold different images or rows
    (``Mesh.param_group``: the data axis, with the spatial axis where the
    mesh has one). On a spatial axis each rank runs its rows of the
    INPUT.IMAGE_SIZE images (``ResNet.spatial_split``). On a model axis
    (TPU.PARAM_SHARDING 'tp') the ResNet is whole on every model rank, which
    runs it on its replica's images (and rows): ``vil_tpu``'s plan cuts no
    ResNet leaf, so GSPMD replicates it there. Under 'fsdp' the caller
    slices it (``parallel.fully_shard``)."""
    if cfg.MODEL.PRETRAINED:
        raise ValueError("MODEL.PRETRAINED needs torchvision hub access; load local "
                         "weights via MODEL.MODEL_PATH (a torchvision .pth) instead")
    if dtype is None:
        dtype = torch.bfloat16 if cfg.TPU.COMPUTE_DTYPE == "bfloat16" else torch.float32
    logger.info("=> creating torchvision-zoo model '%s'", name)
    stats = {}
    if mesh is not None:
        rows = mesh.spatial.size if mesh.spatial is not None else 1
        stats = dict(group=mesh.param_group, group_size=mesh.data_size * rows)
    return build_resnet(name, cfg.DATA.NUM_CLASSES, dtype, param_dtype or torch.float32,
                        device, input_mean=tuple(cfg.INPUT.MEAN),
                        input_std=tuple(cfg.INPUT.STD), generator=generator,
                        img_size=cfg.INPUT.IMAGE_SIZE, **stats)


def build_model(cfg, dtype=None, device=None, use_kernels=None,
                generator=None, param_dtype=None, fused_block=None, mesh=None,
                remat=None):
    """Construct the model from a config tree, read by attribute as
    ``vil_tpu.models.build_model`` reads it (MODEL.ARCH may name an
    ``ARCH_ZOO`` entry, ``msvit`` or a ``RESNET_ZOO`` entry, the ResNets of
    ``models/resnet.py``; the tree is not modified).

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
    read at each call, the switch of ``vil_tpu.models.attention``.

    Under TPU.PARAM_SHARDING 'tp' with a ``mesh`` (``parallel.Mesh``) that
    has a model axis, the model is this model rank's shard (``MsViT``'s
    ``tp``), as ``vil_tpu`` passes its ``tp_mesh``; the classifier head, the
    patch embeddings and the LayerNorms stay whole.

    ``remat`` defaults to TPU.REMAT ('', 'minimal', 'full'). As ``vil_tpu``
    does, it is dropped under MODEL.VIT.MSVIT.MODE > 0, whose random shift
    needs a mode that ``nn.remat`` cannot hold static; the port logs that it
    dropped it."""
    if fused_block is None:
        fused_block = os.environ.get("VIL_TPU_FUSED_BLOCK", "0") == "1"
    name = cfg.MODEL.ARCH
    if name in RESNET_ZOO:
        return _resnet(cfg, name, dtype, device, generator, param_dtype, mesh)
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
    if remat is None:
        remat = getattr(cfg.TPU, "REMAT", "")
    if remat and msvit.MODE > 0:
        logger.warning("TPU.REMAT %r is dropped under MODEL.VIT.MSVIT.MODE %d (random shift "
                       "needs a mode that rematerialisation cannot hold static), as vil_tpu "
                       "drops it", remat, msvit.MODE)
        remat = ""
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
        tp=mesh.model if mesh is not None and cfg.TPU.PARAM_SHARDING == "tp" else None,
        remat=remat,
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


__all__ = ["ARCH_ZOO", "BatchNorm", "MsViT", "NO_WEIGHT_DECAY_SUBSTRINGS", "RESNET_ZOO",
           "ResNet", "StageCfg", "build_model", "build_resnet", "parse_arch",
           "precompute_rpe_cache"]
