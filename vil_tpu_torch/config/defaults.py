"""Default configuration schema.

A copy of ``vil_tpu/config/defaults.py``, TPU node included, so that every
YAML file and override merges in both packages alike. It mirrors the
reference yacs schema (its config/defaults.py:11-185) key for key. The
``TPU`` node keeps its name: the port reads COMPUTE_DTYPE, PARAM_DTYPE,
USE_PALLAS (the hand-written CUDA kernels or their plain versions), FUSED_LN,
MODE_PER_LAYER and SEED from it; a key that selects something the port lacks
raises (``train.trainer.check_ported``).
"""
from .node import CfgNode as CN

_C = CN(new_allowed=False)


def _n(parent: CN, key: str, node: CN) -> CN:
    parent.update_unchecked(key, node)
    return node


def _k(node: CN, key: str, value) -> None:
    node.update_unchecked(key, value)


# training input (reference defaults.py:14-19)
INPUT = _n(_C, "INPUT", CN())
_k(INPUT, "MEAN", [0.485, 0.456, 0.406])
_k(INPUT, "STD", [0.229, 0.224, 0.225])
_k(INPUT, "IMAGE_SIZE", 224)
# ship uint8 images to device; (x/255 - mean)/std folds into PatchEmbed
# (4x smaller H2D, no host float pass). Not used by the timm-aug train path.
_k(INPUT, "DEVICE_NORMALIZE", False)
_k(INPUT, "CROP_PCT", 0.875)
_k(INPUT, "INTERPOLATION", 2)

# mixed precision (reference defaults.py:21-23); on TPU this selects bf16
AMP = _n(_C, "AMP", CN())
_k(AMP, "ENABLED", False)
_k(AMP, "MEMORY_FORMAT", "nchw")

# data augmentation (reference defaults.py:26-44)
AUG = _n(_C, "AUG", CN())
_k(AUG, "SCALE", (0.08, 1.0))
_k(AUG, "RATIO", (3.0 / 4.0, 4.0 / 3.0))
_k(AUG, "COLOR_JITTER", [0.4, 0.4, 0.4, 0.1, 0.0])
_k(AUG, "GRAY_SCALE", 0.0)
_k(AUG, "GAUSSIAN_BLUR", 0.0)
_k(AUG, "DROPBLOCK_LAYERS", [3, 4])
_k(AUG, "DROPBLOCK_KEEP_PROB", 1.0)
_k(AUG, "DROPBLOCK_BLOCK_SIZE", 7)
_k(AUG, "MIXUP_PROB", 0.0)
_k(AUG, "MIXUP", 0.0)
_k(AUG, "MIXCUT", 0.0)
_k(AUG, "MIXCUT_MINMAX", [])
_k(AUG, "MIXUP_SWITCH_PROB", 0.5)
_k(AUG, "MIXUP_MODE", "batch")
_k(AUG, "MIXCUT_AND_MIXUP", False)
_k(AUG, "REPEATED_AUG", False)
TIMM_AUG = _n(AUG, "TIMM_AUG", CN(new_allowed=True))
_k(TIMM_AUG, "USE_TRANSFORM", False)

# datasets (reference defaults.py:46-55)
DATA = _n(_C, "DATA", CN())
_k(DATA, "TRAIN", ("imagenet",))
_k(DATA, "TEST", ("imagenet",))
_k(DATA, "NUM_CLASSES", 1000)
_k(DATA, "TARGETMAP", "")
_k(DATA, "PATH", "./datasets")
_k(DATA, "DATA_DIR", "./data")

# loss (reference defaults.py:58-64)
LOSS = _n(_C, "LOSS", CN())
_k(LOSS, "LABEL_SMOOTHING", 0.0)
_k(LOSS, "LOSS", "xentropy")
FOCAL = _n(LOSS, "FOCAL", CN())
_k(FOCAL, "NORMALIZE", True)
_k(FOCAL, "ALPHA", 1.0)
_k(FOCAL, "GAMMA", 0.5)

# dataloader (reference defaults.py:68-74)
DATALOADER = _n(_C, "DATALOADER", CN())
_k(DATALOADER, "BSZ", 128)
_k(DATALOADER, "RE", "no")
_k(DATALOADER, "WORKERS", 0)
# input pipeline backend: 'threads' (thread-pool prefetch, default) or
# 'grain' (process-parallel decode via Google Grain) — vil_tpu extension
_k(DATALOADER, "BACKEND", "threads")

# optimizer (reference defaults.py:77-104)
OPTIM = _n(_C, "OPTIM", CN())
_k(OPTIM, "OPT", "adamw")
_k(OPTIM, "LR", 1.0)
_k(OPTIM, "MOM", 0.9)
_k(OPTIM, "NU", 1.0)
_k(OPTIM, "WD", 5e-4)
_k(OPTIM, "WD0", 0.0)
_k(OPTIM, "EPOCHS", 150)
_k(OPTIM, "WARMUP", 0)
_k(OPTIM, "DROP_FREQ", 50)
_k(OPTIM, "DROP_FACTOR", 10.0)
_k(OPTIM, "VAL", 0)
_k(OPTIM, "TEST_FREQ", 1000)
ADAM = _n(OPTIM, "ADAM", CN())
_k(ADAM, "BETA1", 0.9)
_k(ADAM, "BETA2", 0.999)
_k(ADAM, "EPS", 1e-8)

# LR scheduler (reference defaults.py:107-115)
SOLVER = _n(_C, "SOLVER", CN())
_k(SOLVER, "LR_POLICY", "")
_k(SOLVER, "WARMUP_FACTOR", 1.0 / 3)
_k(SOLVER, "WARMUP_EPOCHS", 5.0)
_k(SOLVER, "WARMUP_METHOD", "linear")
_k(SOLVER, "MIN_LR", 0.0)
_k(SOLVER, "DETECT_ANOMALY", False)
_k(SOLVER, "EPOCH_BASED_SCHEDULE", False)
_k(SOLVER, "USE_LARC", False)
# derived at runtime by the CLI (reference run_experiment.py:102-108)
_k(SOLVER, "STEPS_PER_EPOCH", 0)
_k(SOLVER, "MAX_ITER", 0)

# models (reference defaults.py:118-161)
MODEL = _n(_C, "MODEL", CN())
_k(MODEL, "ARCH", "msvit")
_k(MODEL, "NONLINEARITY", "celu")
_k(MODEL, "MODEL_PATH", "")
_k(MODEL, "PRETRAINED", False)
_k(MODEL, "FREEZE_CONV_BODY_AT", -1)
VIT = _n(MODEL, "VIT", CN())
_k(VIT, "DROP", 0.0)
_k(VIT, "DROP_PATH", 0.1)
_k(VIT, "NORM_EMBED", True)
_k(VIT, "AVG_POOL", False)
MSVIT = _n(VIT, "MSVIT", CN())
_k(
    MSVIT,
    "ARCH",
    "l1,h3,d192,n1,s1,g1,p16,f7,a1_l2,h6,d384,n10,s0,g1,p2,f7,a1_l3,h12,d796,n1,s0,g1,p2,f7,a1",
)
_k(MSVIT, "SHARE_W", True)
# choices: full, longformerhand, longformerauto, longformer_cuda (alias of
# the Pallas path — the reference's TVM kernel selector), linformer,
# srformer, performer
_k(MSVIT, "ATTN_TYPE", "longformerhand")
_k(MSVIT, "SHARE_KV", True)
_k(MSVIT, "ONLY_GLOBAL", False)
# 1: exact conv-like window; 0: blockwise, zero padding; -1: blockwise, cyclic
_k(MSVIT, "SW_EXACT", 0)
_k(MSVIT, "LN_EPS", 1e-6)
# 0: all 8 neighbor blocks; -1: no neighbors; >0: random-sample one block
_k(MSVIT, "MODE", 0)
_k(MSVIT, "VIL_MODE_SWITCH", 0.75)

# finetune (reference defaults.py:164-166)
FINETUNE = _n(_C, "FINETUNE", CN())
_k(FINETUNE, "FINETUNE", False)
_k(FINETUNE, "USE_TRAIN_AUG", False)

# misc (reference defaults.py:171-185)
_k(_C, "OUTPUT_DIR", "/tmp")
_k(_C, "BACKUP_LOG_DIR", "")
_k(_C, "LOG_FREQ", 10)
_k(_C, "EVALUATE", False)
_k(_C, "OUTPUT_PERCLASS_ACC", False)
_k(_C, "ONLY_SAVE_LAST", 0)
# checkpoint backend: 'msgpack' (single-file flax) or 'orbax' (directory
# PyTree; sharding-aware multi-host restore) — vil_tpu extension
_k(_C, "CKPT_BACKEND", "msgpack")
_k(_C, "DISTRIBUTED_BACKEND", "nccl")  # accepted for config compat; ignored on TPU
_k(_C, "GATHER_ON_CPU", False)

# ---------------------------------------------------------------------------
# TPU-native extensions (no reference equivalent)
# ---------------------------------------------------------------------------
TPU = _n(_C, "TPU", CN())
# dtype policy for the compute path: 'float32' or 'bfloat16'
_k(TPU, "COMPUTE_DTYPE", "bfloat16")
_k(TPU, "PARAM_DTYPE", "float32")
# use the fused Pallas sliding-chunk kernel when on TPU
_k(TPU, "USE_PALLAS", True)
# fused Pallas LayerNorm fwd/bwd in the per-block pre-norms (no f32
# activation casts in the LN backward); requires USE_PALLAS
_k(TPU, "FUSED_LN", False)
# mesh axes: data / fsdp-style model sharding (data-parallel reference: §2.12)
_k(TPU, "MESH_SHAPE", [-1])  # -1 = all devices on the 'data' axis
_k(TPU, "MESH_AXES", ["data"])
# parameter placement: 'replicated' (pure DP), 'fsdp' (ZeRO-3-style
# sharding of params + optimizer state over the data axis), or 'tp'
# (Megatron-style tensor parallelism over a 'model' axis in MESH_AXES)
_k(TPU, "PARAM_SHARDING", "replicated")
# rematerialisation policy for the train step: '', 'minimal', 'full'
_k(TPU, "REMAT", "")
# run elementwise optimizers (sgd/qhm/adam/adamw) over two flat parameter
# vectors (decay / no-decay groups) instead of ~190 separate leaves.
# MEASURED DEAD END (r4, default OFF): the fragmented per-leaf update
# fusions cost 4.4 ms of the 38.7 ms train step, and flattening does
# collapse them to 0.6 ms — but the ravel boundary (2 concats, per-leaf
# bitcast-converts, unflatten slices) adds ~3.9 ms, a net REGRESSION to
# 41.6 ms (docs/BENCHMARKS.md). Kept as an option (numerics identical,
# tests/test_train_stack.py::test_flat_opt_matches_per_leaf); the real fix
# needs the params to LIVE flat end-to-end, which trades the copies for
# per-step weight-relayouts. LAMB always keeps the leaf structure. The
# opt-state layout changes across a flip of this flag (no resume).
_k(TPU, "FLAT_OPT", False)
# Stacked-group optimizer: same-(shape,dtype,decay) leaves below
# STACKED_OPT_THRESHOLD elements are jnp.stack'ed onto a leading axis so
# the elementwise optimizers update ~73 leaves instead of ~185 — the
# bitcast-free sibling of FLAT_OPT (stack preserves layout; copied bytes
# ~1.4 MB at the default threshold on ViL-Small). Numerics identical
# (tests/test_train_stack.py::test_stacked_opt_matches_per_leaf); the
# opt-state layout changes across a flip of this flag (no resume).
_k(TPU, "STACKED_OPT", False)
_k(TPU, "STACKED_OPT_THRESHOLD", 65536)
# seed of the random streams (jax PRNG keys; the port's torch generators)
_k(TPU, "SEED", 42)
# MODE>0 training: sample an independent random-shift mode per attention
# layer each step (reference samples per forward, longformer2d.py:116-121);
# False = one mode shared by all layers per step
_k(TPU, "MODE_PER_LAYER", True)


def get_default_cfg() -> CN:
    """Return a fresh (mutable) clone of the default config tree."""
    return _C.clone()
