"""The ViL-Small 224² ImageNet-1k recipe of ``configs/msvit.yaml``.

:func:`vil_small_cfg` is the recipe as a config tree, read by attribute as
the JAX package's is: every key that ``build_model``, ``optim.get_opt``,
``schedulers.get_lr_schedule``, ``mixup_from_cfg`` and
``loss.get_criterion`` read, at the value of the JAX package's defaults
merged with ``configs/msvit.yaml`` (``tests/test_torch_train.py`` checks them
key by key). The port reads no YAML, so the tree is spelled out here. Two
keys differ from the yaml:

* DATALOADER.BSZ is 64, the batch ``bench.py`` trains at (256 in the yaml);
* SOLVER.STEPS_PER_EPOCH and MAX_ITER, which the JAX trainer sets from its
  loader (ImageNet-1k's training set, last partial batch dropped), are set
  from that batch here.

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


def vil_small_cfg(mode: int = 0, fused: bool = False, rpe: bool = False) -> NS:
    steps_per_epoch = IMAGENET_TRAIN_IMAGES // BATCH
    arch = rpe_arch(ARCH_ZOO["vil_small"]) if rpe else ARCH_ZOO["vil_small"]
    return NS(
        DATA=NS(NUM_CLASSES=1000),
        DATALOADER=NS(BSZ=BATCH),
        INPUT=NS(IMAGE_SIZE=224, MEAN=[0.485, 0.456, 0.406], STD=[0.229, 0.224, 0.225]),
        MODEL=NS(ARCH="msvit", VIT=NS(
            DROP=0.0, DROP_PATH=0.1, NORM_EMBED=True, AVG_POOL=False,
            MSVIT=NS(ARCH=arch, SHARE_W=True, ATTN_TYPE="longformerhand",
                     ONLY_GLOBAL=False, SW_EXACT=0, LN_EPS=1e-6, MODE=mode))),
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


def vil_small(dtype: torch.dtype, param_dtype: torch.dtype = torch.float32,
              use_kernels: bool = True, device=None, fused: bool = False,
              rpe: bool = False) -> MsViT:
    """The recipe's model, computed in ``dtype`` with parameters in
    ``param_dtype``; random weights from seed 0 (the same with ``fused``;
    with ``rpe`` the ViL-Small RPE model, whose tables are drawn too)."""
    return build_model(vil_small_cfg(fused=fused, rpe=rpe), dtype=dtype, param_dtype=param_dtype,
                       device=device, use_kernels=use_kernels, fused_block=fused,
                       generator=torch.Generator().manual_seed(0))


def train_step(model: MsViT, device=None, random_shift: bool = False) -> Callable:
    """``engine.make_train_step`` over ``model`` with the recipe's criterion,
    optimizer, schedule and mixup. ``random_shift`` takes the MODE 1 recipe:
    per-layer neighbour modes drawn each step from a CPU generator seeded
    with 0."""
    cfg = vil_small_cfg(1 if random_shift else 0)
    mode_generator = torch.Generator().manual_seed(0) if random_shift else None
    return engine.make_train_step(model, loss.get_criterion(cfg), optim.get_opt(cfg, model),
                                  schedulers.get_lr_schedule(cfg), mixup_from_cfg(cfg),
                                  device=device, random_shift=random_shift,
                                  per_layer_modes=cfg.TPU.MODE_PER_LAYER,
                                  mode_generator=mode_generator)
