"""The ViL-Small 224² ImageNet-1k recipe of ``configs/msvit.yaml``.

:func:`vil_small_cfg` is the recipe as a config tree, read by attribute as
the JAX package's is: every key that ``build_model``, ``optim.get_opt``,
``schedulers.get_lr_schedule``, ``mixup_from_cfg`` and
``loss.get_criterion`` read, at the value of the JAX package's defaults
merged with ``configs/msvit.yaml`` (``tests/test_torch_train.py`` checks them
key by key). The tree is spelled out here so that the recipe reads no file
outside the package; the experiment entry point (``vil_tpu_torch.config``,
``python -m vil_tpu_torch.run_experiment``) merges the yaml itself. Two keys
differ from the yaml:

* DATALOADER.BSZ is 64, the batch ``bench.py`` trains at (256 in the yaml);
* SOLVER.STEPS_PER_EPOCH and MAX_ITER, which the JAX trainer sets from its
  loader (ImageNet-1k's training set, last partial batch dropped), are set
  from that batch here.

:func:`vil_cfg` and :func:`vil` are the same recipe for any model of the zoo
at any image size and batch (``vil_cfg("vil_medium_deep", 384, batch=16)``:
ViL-Medium-Deep 384²; ``vil_cfg("vil_small", 1024, batch=8)``: ViL-Small
1024²); ViL-Small 224² at batch 64 is their default, ``vil_small_cfg`` and
``vil_small``.

``vil_small_cfg(mode=1)`` is the random-shift recipe: MODEL.VIT.MSVIT.MODE 1,
the reference's switch for random shifting, with one sampled neighbour mode
per attention block (TPU.MODE_PER_LAYER).

``vil_small_cfg(rpe=True)`` and ``vil_small(..., rpe=True)`` are ViL-Small
RPE: the same model with relative position bias in every stage (``a0``
appended to each stage of the ARCH string, as ``benchmarks/model_bench.py``
builds it), the configuration of the released RPE checkpoints.

``vil_small_cfg(fused=True)`` and ``vil_small(..., fused=True)`` are the
fused-kernel configuration of the same model: TPU.FUSED_LN True (the block
pre-norms through the LayerNorm kernels) and the fused attention block at
mode 0, the switch the JAX package reads from ``VIL_TPU_FUSED_BLOCK=1``.

``vil_small_cfg(**VARIANTS[name])`` and ``vil_small(..., **VARIANTS[name])``
are the attention families of the paper's ablation on ViL-Small 224² (its
``BASELINE.md`` rows), each changing only MODEL.VIT.MSVIT's ATTN_TYPE,
ONLY_GLOBAL or SHARE_W and the ``f`` of stages 1-2; stages 3-4 stay dense:

* ``linformer``: ATTN_TYPE linformer, SHARE_KV True (the yaml's), f256 (the
  feature count of ``benchmarks/benchmark_vil.py``);
* ``srformer``: ATTN_TYPE srformer, f8 and f4: a 7×7 key grid in both
  stages (Pyramid Vision Transformer's reduction ratios);
* ``performer``: ATTN_TYPE performer, f256 random features;
* ``global``: ``longformerhand`` with ONLY_GLOBAL True (the ablation's
  "global" row);
* ``unshared``: ``longformerhand`` with SHARE_W False, the global branch's
  own query/kv/proj weights.

The model and the training step are built from that tree through those
builders, the ones the tests hold to the JAX package's. ``chip_smoke.py`` and
``vil_tpu_torch.tools.profile_step`` drive them.
"""
from __future__ import annotations

import re
from types import SimpleNamespace as NS
from typing import Callable

import torch

from ..data.mixup import mixup_from_cfg
from ..models import ARCH_ZOO, MsViT, build_model
from . import engine, loss, optim, schedulers

IMAGENET_TRAIN_IMAGES = 1281167
BATCH = 64


def rpe_arch(arch: str) -> str:
    """``arch`` with relative position bias in every stage: each stage's
    ``a`` attribute set to 0, or ``a0`` appended."""
    return "_".join(re.sub(r"a\d+", "a0", s) if ",a" in s else s + ",a0"
                    for s in arch.split("_"))


def stage_feats(arch: str, *feats: int) -> str:
    """``arch`` with the ``f`` of its first stages set to ``feats``, in order."""
    stages = arch.split("_")
    for i, f in enumerate(feats):
        stages[i] = re.sub(r"f\d+", f"f{f}", stages[i])
    return "_".join(stages)


VARIANTS = {
    "linformer": dict(attn_type="linformer", arch=stage_feats(ARCH_ZOO["vil_small"], 256, 256)),
    "srformer": dict(attn_type="srformer", arch=stage_feats(ARCH_ZOO["vil_small"], 8, 4)),
    "performer": dict(attn_type="performer", arch=stage_feats(ARCH_ZOO["vil_small"], 256, 256)),
    "global": dict(only_glo=True),
    "unshared": dict(sharew=False),
}


def vil_cfg(name: str = "vil_small", img_size: int = 224, batch: int = BATCH, mode: int = 0,
            fused: bool = False, rpe: bool = False, attn_type: str = "longformerhand",
            arch: str = "", only_glo: bool = False, sharew: bool = True) -> NS:
    """The recipe's tree for the zoo model ``name`` (``ARCH_ZOO``) at
    ``img_size`` px, trained at ``batch`` images a step (the counterpart of
    ``benchmarks/model_bench.py``'s ``MsViT(arch=ARCH_ZOO[...],
    img_size=...)``): INPUT.IMAGE_SIZE, DATALOADER.BSZ and the steps an epoch
    follow them, every other key is ViL-Small's. ``arch`` replaces the zoo's
    ARCH string (the attention families' ``f``)."""
    steps_per_epoch = IMAGENET_TRAIN_IMAGES // batch
    arch = arch or ARCH_ZOO[name]
    arch = rpe_arch(arch) if rpe else arch
    return NS(
        DATA=NS(NUM_CLASSES=1000),
        DATALOADER=NS(BSZ=batch),
        INPUT=NS(IMAGE_SIZE=img_size, MEAN=[0.485, 0.456, 0.406], STD=[0.229, 0.224, 0.225]),
        MODEL=NS(ARCH="msvit", VIT=NS(
            DROP=0.0, DROP_PATH=0.1, NORM_EMBED=True, AVG_POOL=False,
            MSVIT=NS(ARCH=arch, SHARE_W=sharew, ATTN_TYPE=attn_type, SHARE_KV=True,
                     ONLY_GLOBAL=only_glo, SW_EXACT=0, LN_EPS=1e-6, MODE=mode))),
        TPU=NS(COMPUTE_DTYPE="bfloat16", PARAM_DTYPE="float32", USE_PALLAS=True,
               MODE_PER_LAYER=True, FUSED_LN=fused),
        LOSS=NS(LOSS="xentropy", LABEL_SMOOTHING=0.1),
        AUG=NS(MIXUP_PROB=1.0, MIXUP=0.8, MIXCUT=1.0, MIXUP_SWITCH_PROB=0.5),
        OPTIM=NS(OPT="adamw", LR=5e-4, WD=0.05, WD0=0.0, MOM=0.9, EPOCHS=300,
                 DROP_FREQ=50, DROP_FACTOR=10.0,
                 ADAM=NS(BETA1=0.9, BETA2=0.999, EPS=1e-8)),
        SOLVER=NS(LR_POLICY="cosine", EPOCH_BASED_SCHEDULE=False, WARMUP_EPOCHS=5.0,
                  WARMUP_FACTOR=0.002, WARMUP_METHOD="linear", MIN_LR=1e-6,
                  STEPS_PER_EPOCH=steps_per_epoch, MAX_ITER=steps_per_epoch * 300),
    )


def vil_small_cfg(mode: int = 0, fused: bool = False, rpe: bool = False,
                  attn_type: str = "longformerhand", arch: str = "", only_glo: bool = False,
                  sharew: bool = True) -> NS:
    """ViL-Small 224² at batch 64: :func:`vil_cfg`'s default."""
    return vil_cfg(mode=mode, fused=fused, rpe=rpe, attn_type=attn_type, arch=arch,
                   only_glo=only_glo, sharew=sharew)


def vil(name: str, img_size: int, dtype: torch.dtype, param_dtype: torch.dtype = torch.float32,
        use_kernels: bool = True, device=None, fused: bool = False, rpe: bool = False,
        **variant) -> MsViT:
    """The zoo model ``name`` at ``img_size`` px (:func:`vil_cfg`), computed
    in ``dtype`` with parameters in ``param_dtype``; random weights from seed
    0 (the same with ``fused``; with ``rpe`` the model with relative position
    bias in every stage, whose tables are drawn too). ``variant`` is one of
    :data:`VARIANTS`' keyword sets, or keywords of :func:`vil_cfg`
    (``attn_type``, ``arch``, ``only_glo``, ``sharew``)."""
    return build_model(vil_cfg(name, img_size, fused=fused, rpe=rpe, **variant), dtype=dtype,
                       param_dtype=param_dtype, device=device, use_kernels=use_kernels,
                       fused_block=fused, generator=torch.Generator().manual_seed(0))


def vil_small(dtype: torch.dtype, param_dtype: torch.dtype = torch.float32,
              use_kernels: bool = True, device=None, fused: bool = False,
              rpe: bool = False, **variant) -> MsViT:
    """ViL-Small 224², :func:`vil` of ``vil_small``."""
    return vil("vil_small", 224, dtype, param_dtype, use_kernels, device, fused, rpe,
               **variant)


def train_step(model: MsViT, device=None, random_shift: bool = False,
               batch: int = BATCH) -> Callable:
    """``engine.make_train_step`` over ``model`` with the recipe's criterion,
    optimizer, schedule and mixup, its schedule's epochs of ``batch``
    images a step. ``random_shift`` takes the MODE 1 recipe: per-layer
    neighbour modes drawn each step from a CPU generator seeded with 0."""
    cfg = vil_cfg(batch=batch, mode=1 if random_shift else 0)
    mode_generator = torch.Generator().manual_seed(0) if random_shift else None
    return engine.make_train_step(model, loss.get_criterion(cfg), optim.get_opt(cfg, model),
                                  schedulers.get_lr_schedule(cfg), mixup_from_cfg(cfg),
                                  device=device, random_shift=random_shift,
                                  per_layer_modes=cfg.TPU.MODE_PER_LAYER,
                                  mode_generator=mode_generator)
