#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``vil_tpu_torch``) once on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root; needs one CUDA card
    python3 chip_smoke.py --only kernels,serve_rpe   # the build and those parts alone

Phases, one line each; any failure raises and the exit code is not 0:

1. device  — refuse to run without CUDA; the card's name and power limit.
2. build   — compile ``vil_tpu_torch/csrc/*.cu`` with nvcc for sm_90a, one
   nvcc per source, all at once; the SASS census of the dense kernels, of
   the sliding-chunk forwards B1, B7a and B5, of the sliding-chunk backwards
   B2, B7b and B6 and of the fused block's forward B9a and backward B9b
   (``tools/sass_census.py``, with each kernel's registers): their bf16
   instances must hold wgmma (HGMMA) and cp.async (LDGSTS) instructions.
3. kernels — each kernel against its plain PyTorch version on the same
   inputs: the forwards (with their log-sum-exp against ``torch.logsumexp``
   of the plain scores) and the backwards (with the same upstream gradient)
   at the shapes of ViL-Small 224² at batch 64, in f32 and bf16, plus biased,
   padded, cyclic 1×2 and 2×2 and long-sequence cases, and the dense kernels
   at every head dim (8-128) at N 1, 63, 64 and 65, and each kernel of part
   highres at its shapes (timed per call: 14x14, 37x37, 19x19 grids, W 6, 8
   and 12; B5/B6 at two modes on 37x37 and W 12; dense N 577, 4097, 1024 and
   144; the fused block at W 12 and W 8), in bf16 also to a
   limit on max|err| / max|ref| of out, dq, dk and dv (and of out, dq, dk,
   dv, dk_glo, dv_glo and dbias of B1/B2, B5/B6 and B7a/B7b); the
   sampled-neighbour kernels of random-shift training (B5, B6) at two modes
   per stage and on biased, padded and cyclic grids, W 9 and head dim 128;
   B2 and B6 take the forward's out. Kernel, plain and library times (CUDA
   events, median of 20; the library call is
   ``scaled_dot_product_attention``, for the sliding-chunk kernels on the
   materialised key neighbourhood, whose concatenation is timed on its own
   line), and each kernel's bound on this card. The dense kernels are also
   timed at N=4097, ViL-Small 1024²'s stage-3 length, where the JAX package
   switches to its q-tiled kernels.
4. serve   — ViL-Small 224², 1000 classes, bf16, batch 64, random seeded
   weights: six requests of uint8 images; the launch counts must be 3
   (sliding-chunk forward) and 9 (dense forward) per forward and 0 for the
   backwards; then the same weights in f32 with the kernels and with the
   plain versions must agree, and in bf16 (the path's own types) too.
5. train   — the ViL-Small 224² training step of configs/msvit.yaml (AdamW
   with the no-decay set, mixup/cutmix with soft-target CE and label
   smoothing 0.1, drop path 0.1, f32 parameters under bf16 compute) at batch
   64 for six steps; launches must rise by 3, 3, 9 and 9 per step (B1, B2,
   B3, B4) and every loss be finite. Then one f32 step with the kernels and
   one with the plain versions, from the same weights, images and generator
   seed: losses and every parameter gradient must agree; then the same pair
   of steps in bf16 compute, each parameter gradient to a looser limit.
6. train_shift — the same step with random shifting (MODE 1, one sampled
   neighbour mode per attention block drawn each step from a seeded CPU
   generator, printed): launches must rise by 3, 3, 9 and 9 per step for the
   sampled-neighbour pair (B5, B6) and the dense pair, and by 0 for B1 and
   B2; then the f32 kernels-vs-plain step with the first step's modes.
7. serve_fused — phase 4 in the fused-kernel configuration (TPU.FUSED_LN and
   the fused attention block, ``recipe.vil_small(..., fused=True)``): per
   forward 3 fused-block (B9a), 30 LayerNorm (B8a) and 9 dense launches and
   no sliding-chunk one; f32 logits kernels vs plain, then the fused
   configuration's f32 logits against the classic one's, same weights.
8. train_fused — phase 5 in the fused configuration: per step B9a 3, B9b 3,
   B8a 30, B8b 30, B3 9, B4 9, and 0 for B1, B2, B5, B6; then the f32
   kernels-vs-plain step.
9. serve_spatial — spatial (chunk-row) parallelism on a process group of one
   card (``nccl``, set up from a ``FileStore`` under build/; the halos go
   through the exchange, sent by NCCL to the rank itself): the ViL-Small
   224² bf16 batch-64 forward through ``parallel.spatial_forward``, six
   requests; per forward 3 halo-input forward (B7a) and 9 dense launches and
   no B1. The classic serve forward is timed before it, same weights and
   images, outside its launch counts. Then, as a path of its own
   (``spatial_bwd``, counted apart), one autograd backward through
   ``spatial_local_attention_kernel`` at stage 1's shape on the same group:
   B7a 1 and B7b 1, B7b inside the halo exchange's adjoint, which returns the
   halo rows' gradients over NCCL (its gradients against the plain spatial
   tier). Last, f32 logits spatial vs classic and spatial kernels vs plain.
10. probe — the layout probe tool (``vil_tpu_torch.tools.layout_probe``):
   producer GEMM → P → consumer GEMM in both schemes, its census of copy ops
   and its time per pass.
11. serve_rpe — phase 4 on ViL-Small RPE (``recipe.vil_small(..., rpe=True)``:
   relative position bias in every stage), its biases assembled once by
   ``models.precompute_rpe_cache``: B1 3 and B3 9 per forward, each with its
   bias; the cached logits equal, bit for bit, those of a model that
   assembles the biases in the forward; f32 and bf16 logits kernels vs
   plain as in phase 4, and the f32 pair again with every table drawn at
   σ 1, beside the logits' change from zero tables (what a dropped bias
   moves them by).
12. train_rpe — phase 5 on ViL-Small RPE: launches rise by 3, 3, 9 and 9 per
   step; the f32 step pair holds the tables' gradients with every other
   (and again with the tables at σ 1), then the bf16 pair.
13. shift_rpe — the f32 kernels-vs-plain random-shift step pair of ViL-Small
   RPE, at the recipe's first draw of modes (printed) and again with the
   tables at σ 1: B5, B6 with the [g2l | self | sampled] bias, 3 each a
   kernel step, B3, B4 9.
14. train_fused_rpe — the same pair in the fused configuration: B9a, B9b 3,
   B8a, B8b 30, B3, B4 9 a kernel step.
15. experiment — the entry point users run, ``python -m
   vil_tpu_torch.run_experiment`` (config, data pipeline, trainer,
   checkpoints), driven in-process through its ``main(argv)`` on
   configs/msvit.yaml's recipe at ViL-Small's full width and depth, batch 64
   (the yaml's 256, cut), the synthetic set (512 images: 8 steps an epoch, 8
   eval batches): two epochs, random shift in the first (VIL_MODE_SWITCH
   0.5), MODE 0 in the second; a resume of the same directory to three
   epochs (from the ``last_checkpoint`` tag at epoch 2, step 16, at the
   schedule's LR there; its epoch under ``torch.profiler`` for the card's
   busy share); the last checkpoint reloaded under EVALUATE, its eval bit
   for bit the run's; the same eval in f32 with the kernels and with the
   plain versions (TPU.USE_PALLAS), loss to LOSS_TOL and top1 equal. Each
   run's launches must equal the formula from the trainer's own counts
   (random-shift and MODE-0 steps, eval batches, the best checkpoint's
   eval); per epoch the median batch_time, data_time and img/s, and the peak
   memory, are printed.
16. efficient — the paper's other attention families on ViL-Small 224² at
   batch 64 (``recipe.VARIANTS``: linformer f256 with SHARE_KV, srformer f8/f4,
   performer f256, global-only and unshared-global ViL), each a path of its
   own: REQUESTS bf16 serving forwards on uint8 images and STEPS bf16
   training steps of the recipe (walls the median of all but the first, as
   on the other paths; peak memory, parameters and ops/flops.py's GMACs
   printed), then one f32 forward and one f32 step with the kernels and
   with the plain versions from the same weights (logits to LOGITS_TOL, loss
   to LOSS_TOL, every parameter gradient to PARAM_GRAD_TOL of its max|ref|);
   the launches held exactly: per forward B3 9 (and B1 3 with unshared
   weights), per step also B4 9 (and B2 3), nothing else. Then the performer
   through ``run_experiment.main(argv)`` (path ``experiment_performer``):
   two epochs of 8 steps and a resume to three; its projection buffers must
   change before exactly the steps a fresh ``RedrawSchedule`` names, the
   resumed run's count must start afresh, the checkpoint's buffers be the
   last step's and the last redraw the draw keyed by (seed, step).
17. highres — high resolution at full width and depth (``HIGHRES``,
   ``recipe.vil``): ViL-Medium-Deep 384² served at batch 64 (``serve_384``:
   14x14 chunks of W 7 pad 2, 7x7 pad 1, dense N 577 and 144; B1 5, B3 17 a
   forward) and trained at 64 (``train_384``: B1, B2 5, B3, B4 17 a step);
   ViL-Small 1024² served at batch 8 (``serve_1024``: 37x37 pad 3, 19x19 pad
   5, dense N 4097 and 1024; B1 3, B3 9), trained at 8 at MODE 0
   (``train_1024``) and at random shift (``shift_1024``: B5, B6 3, B3, B4 9,
   B1, B2 0); ViL-Base-Deep-384 served and trained at batch 32
   (``base_deep_384``: 16x16 W 6, 6x6 W 8; B1 9, B3 25 a forward, B2 9, B4 25
   more a step). Each: REQUESTS forwards and/or STEPS steps (walls the
   median of all but the first, img/s, GMACs an image from ops/flops.py,
   peak memory), PROFILED more under torch.profiler (the card's time, idle
   share, top families); launches exact per forward and step; then the f32
   and the bf16 pair, kernels vs plain versions from the same weights, at
   the batch the plain versions' memory allows (64, 8, 8, 2, 2, 4): logits
   to LOGITS_TOL and BF16_LOGITS_TOL, a step's loss and every gradient to
   LOSS_TOL, PARAM_GRAD_TOL and BF16_PARAM_GRAD_TOL. Then ``finetune_384``:
   configs/msvit_384finetune.yaml through ``run_experiment.main(argv)`` on
   ViL-Medium-Wide 384² (W 8 with 64 rows a chunk, W 12 with 144 in three
   slices) from a .pth of a seeded ViL-Medium-Wide 224² under the
   reference's names, batch 32, one epoch of 8 QHM steps and its eval: every
   parameter after the load bit for bit the CPU importer's, each logged LR
   the schedule's, launches the trainer's counts, the f32 eval kernels vs
   plain (loss to LOSS_TOL, top1 equal).
Phase 9 also serves ViL-Small RPE (tables at σ 1) through the spatial route
and holds its f32 logits to the classic forward's and to the plain versions'.

Phase 3 also holds the LayerNorm kernels (B8a, B8b) at the six row shapes of
ViL-Small's block pre-norms, with ``F.layer_norm`` as their library call, and
at C 100 and 1000 (no 16-byte vectors) at 1 and 3000 rows, a second B8b
launch bit for bit; the fused-block kernels (B9a, B9b) at stage 1 and 2, on
biased, padded, cyclic 2×2 and 3×3 grids, with and without global rows, at
C 48-320, and at stage 1's width with q, k and v biases as large as the
products (no single PyTorch call computes the fused block; in bf16 B9a's y,
q, k, v, attn and lse and every B9b gradient also to max|err| / max|ref|
with no floor, and a second B9b launch bit for bit), then the card's time
per step (``torch.profiler``) beside the event time of B5, of B9a (by part:
projections, attention, output projection), of B9b (attention, products, the
rest), of B8a and of B8b (rows, reduction) (``card_times``), the
halo-input kernels (B7a, B7b) on every shard of stage 1 and 2 split over 1, 2
and 4 ranks, of a biased padded grid split over 3, of a cyclic 1×2 grid, and
of an SW_EXACT 1 (a mask row per query pixel) and a W 4 grid split over 1
and 2, in f32 and bf16 (the shards' outputs together must equal B1's on the
whole grid, their dK/dV folded onto the rows' owners B2's; SDPA on the
materialised halo neighbourhood as the library call; a bf16 operand off a
16-byte boundary must raise ValueError), and P's two entry points against
``x * 2``, exactly, at the probe's shape (event time, the time of 100 calls
between one pair of events, and the card's time by ``torch.profiler``, each
beside ``torch.mul``'s), on a ragged shape, on a view one element into its
storage and on a slice.

Phase 3 ends with ViL-Small RPE's biased kernels at its step's shapes, each
bias assembled from tables drawn at σ 1 by the model's own assembly: B3 with
(6, 197, 197) and (12, 49, 49), B1/B2 and B9a/B9b with (3, 49, 442), B5/B6 at
modes 1..8 with (3, 49, 99) in front order, B7a/B7b split over 2 ranks; each
timed per call with its bias (SDPA with the bias in its mask beside it).

Each path of phases 4-17 sets the launch counts to 0 before it and reads
them after it; a kernel that none of them launched fails the run. The last line is ``{"ok": true, "device": {...}}``; the line
before it holds every kernel's record (``launches`` is the sum over the
paths, ``launches_serve``, ``launches_train``, ``launches_shift``,
``launches_serve_fused``, ``launches_train_fused``, ``launches_serve_spatial``,
``launches_spatial_bwd``, ``launches_probe``, ``launches_serve_rpe``,
``launches_train_rpe``, ``launches_shift_rpe``, ``launches_train_fused_rpe``,
``launches_experiment``, ``launches_linformer``, ``launches_srformer``,
``launches_performer``, ``launches_global``, ``launches_unshared``,
``launches_experiment_performer``, ``launches_serve_384``,
``launches_train_384``, ``launches_serve_1024``, ``launches_train_1024``,
``launches_shift_1024``, ``launches_base_deep_384`` and
``launches_finetune_384`` each path's; ``ms``,
``plain_ms``, ``bound_ms`` and ``library_ms`` are per step of the training
path that runs the kernel: MODE 0, random shift for B5/B6, fused for B8/B9;
for B7a per spatial serving forward on one rank (no LSE), for B7b per run of
the ``spatial_bwd`` path, one stage-1 backward on one rank; for P per call at
the probe's shape), and the line before that the card as
``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives it.
"""
from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
BATCH = 64
REQUESTS = 6  # the first is the warm-up, left out of the img/s median
STEPS = 6  # training steps; the first is the warm-up
F32_TOL = 1e-4  # kernel vs plain, f32 inputs: f32 sums in another order
BF16_TOL = 2e-2  # kernel on bf16 inputs vs plain in f32 on the same values
LSE_TOL = 2e-5  # kernel vs logsumexp of the plain scores, either dtype (measured ≤ 3.8e-6)
# backward, max|err| / max(1, max|ref|) (measured ≤ 2.4e-6 and ≤ 3.4e-3)
GRAD_TOL = {"float32": 1e-5, "bfloat16": 1e-2}
# bf16 dense kernels: max|err| / max|ref| of out, dq, dk and dv, with no floor.
# The limits above are absolute below |ref| 1, where the dense outputs of the
# main path lie (|out| ≈ 0.02 at stage 3). Measured ≤ 7.1e-3 over the cases;
# a forward that skips the rescale of o across key tiles reads 3.0e-2-1.5 at
# N > 64, δ = 0 in the backward 0.12-4.5.
DENSE_SCALED_TOL = 2e-2
# bf16 sliding-chunk kernels B1/B2, B5/B6 and B7a/B7b: the same ratio for
# out, dq, dk, dv, dk_glo, dv_glo and (biased cases) dbias, with no floor
# (dq, the global keys' gradients and dbias lie far below 1 at these shapes);
# and for every gradient of the fused block's backward B9b (BLOCK_GRADS).
CHUNK_SCALED_TOL = 2e-2
BLOCK_GRADS = ("dx", "dWq", "dbq", "dWk", "dbk", "dWv", "dbv", "dWo", "dbo", "dk_glo",
               "dv_glo", "dbias")
# and the same ratio for what the fused block's forward B9a writes
BLOCK_FWD_OUTS = ("y", "q", "k", "v", "attn", "lse")
LOGITS_TOL = 1e-3  # whole model in f32, kernels vs plain versions
LOSS_TOL = 1e-4  # one f32 training step, kernels vs plain versions
PARAM_GRAD_TOL = 1e-4  # the same step: max|err| / max|ref| per parameter (measured 1.7e-6)
# the same paths in bf16, kernels vs plain versions from the same weights:
# logits max|err| / max|ref| (measured 5.2e-3; an all-zero dense forward
# 0.35); one step's parameter gradients ‖err‖ / ‖ref‖, the largest over the
# parameters (measured 9.9e-3; δ = 0 in the dense backward 0.20). Plain bf16
# vs plain f32 reads 1.7e-2 and 1.9e-2: a sound bf16 kernel of another
# rounding order may come near that.
BF16_LOGITS_TOL = 2.5e-2
# the RPE paths' f32 logits with every table at σ 1, kernels vs plain: at
# most this share of the logits' change from zero tables (and LOGITS_TOL),
# so that a dropped or misplaced bias, which moves them by about that change,
# fails however small the change is at random weights
RPE_SHARE_TOL = 1e-2
BF16_PARAM_GRAD_TOL = 2.5e-2
# H100 SXM data sheet: dense bf16 tensor-core rate and HBM3 bandwidth
PEAK_BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12


def phase(name: str, msg: str) -> None:
    print(f"[{name}] {msg}", flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout
    return out.strip().splitlines()[0]


def time_ms(fn, reps: int = 20) -> float:
    """Median time of one call in ms, by CUDA events, after two warm-ups."""
    import torch

    for _ in range(2):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, reps: int = 20, by=None):
    """The card's time of one call in ms: the time of the kernels that
    ``torch.profiler`` records over ``reps`` calls (after two warm-ups),
    over ``reps``. The host's share of a call is its event time less this.
    With ``by`` (a function of a kernel's name) {by(name): ms} instead."""
    import torch

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    groups = {}
    for e in prof.key_averages():
        if (e.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(e, "is_user_annotation", False)):
            us = getattr(e, "self_device_time_total", 0) or getattr(e, "self_cuda_time_total", 0)
            key = by(e.key) if by else None
            groups[key] = groups.get(key, 0.0) + us / 1e3 / reps
    return groups if by else sum(groups.values())


def burst_ms(fn, reps: int = 100) -> float:
    """Time of one call in ms from ``reps`` calls between one pair of CUDA
    events, after two warm-ups: the host's work of a call hides behind the
    card's where it is the shorter."""
    import torch

    for _ in range(2):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def probe_split(torch) -> dict:
    """P's time per call at the probe's shape in bf16, for ``consume_base``
    (the base layout), ``consume_perm`` (its permuted view) and, on the same
    views, the library call ``torch.mul(x, 2)``: {name: {"event": median of
    20 calls each between a pair of events (the record's ms), "burst": 100
    calls between one pair, "device": the card's time, ``device_ms``}}. It
    times whichever ``vil_tpu_torch`` is importable, so another tree's P
    can be timed by this same function."""
    from vil_tpu_torch.tools import layout_probe as lp

    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(lp.B, lp.MX, lp.MY, lp.W2, lp.C, generator=gen,
                    device="cuda").to(torch.bfloat16)
    xt = x.permute(1, 2, 3, 0, 4)
    calls = {"consume_base": lambda: lp.consume_base(x),
             "consume_perm": lambda: lp.consume_perm(xt),
             "torch.mul base": lambda: torch.mul(x, 2),
             "torch.mul perm": lambda: torch.mul(xt, 2)}
    return {name: {"event": time_ms(fn), "burst": burst_ms(fn), "device": device_ms(fn)}
            for name, fn in calls.items()}


# the rows and widths of the fused training step's LayerNorm launches, with
# their counts: the image and global rows of the chunked stages' attention
# and MLP pre-norms, then the dense stages' tokens
LN_STEP = ((200704, 96, 2), (64, 96, 2), (50176, 192, 4), (64, 192, 4), (12608, 384, 16),
           (3136, 768, 2))


def card_times(torch, family) -> dict:
    """Per step, bf16 at ViL-Small 224² batch 64: B5 per random-shift step
    (mode 1: stage 1 once, stage 2 twice); B9a (with the LSE and the saved q
    and attn, as training calls it), B9b, B8a and B8b per fused training
    step (stage 1 once, stage 2 twice; the LayerNorms at ``LN_STEP``):
    {"B5" | "B9a" | "B9b" | "B8a" | "B8b": {"event": median of 20 steps each
    between a pair of events, "device": the card's time by ``device_ms``,
    "parts": that time by ``family`` (a kernel name's group)}}. It times
    whichever ``vil_tpu_torch`` is importable, so another tree's kernels can
    be timed by this same function."""
    from vil_tpu_torch.ops import masks as masks_lib
    from vil_tpu_torch.ops.kernels import (
        layer_norm_bwd, layer_norm_fwd, mask_to_additive, vil_block_bwd, vil_block_fwd,
        vil_mode_attention_fwd,
    )

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    randn = lambda *s, scale=1.0: (torch.randn(*s, generator=gen, device=dev) * scale).to(
        torch.bfloat16)
    H, w2 = 3, 49
    mode_calls, fwd_calls, block_calls = [], [], []
    for mx, C in ((8, 96), (4, 192)):  # stage 1, stage 2
        M, shape = C // H, (BATCH, mx, mx, w2, C)
        masks = [torch.from_numpy(mask_to_additive(masks_lib.invalid_mask(
            mx, mx, 0, 0, 7, 0, mode), mx, mx, w2, 1)).to(dev) for mode in (0, 1)]
        ops = [randn(*shape, scale=M ** -0.5) for _ in range(3)] + [randn(BATCH, 1, C)] * 2
        mode_calls.append(lambda ops=ops, mask=masks[1]: vil_mode_attention_fwd(
            *ops, None, mask, H, 1, with_lse=True))
        ws = [randn(C, C, scale=C ** -0.5 * (M ** -0.5 if i == 0 else 1.0)) for i in range(4)]
        bs = [torch.randn(C, generator=gen, device=dev) * 0.02 for _ in range(4)]
        args = [randn(*shape), ws[0], bs[0], ws[1], bs[1], ws[2], bs[2], ws[3], bs[3],
                randn(BATCH, 1, C), randn(BATCH, 1, C), None]
        fwd_calls.append(lambda args=args, mask=masks[0]: vil_block_fwd(
            *args, mask, H, with_lse=True, saved=True))
        _, k, v, lse, q, attn = fwd_calls[-1]()
        block_calls.append(lambda args=args, mask=masks[0], g=randn(*shape), lse=lse,
                           saved=(q, k, v, attn): vil_block_bwd(*args, g, mask, lse, H, saved))
    ln_fwd, ln_bwd = [], []
    for rows, C, count in LN_STEP:
        x, dy = randn(rows, C), randn(rows, C)
        gamma, beta = torch.ones(C, device=dev), torch.zeros(C, device=dev)
        ln_fwd += [lambda x=x, gamma=gamma, beta=beta: layer_norm_fwd(x, gamma, beta)] * count
        ln_bwd += [lambda x=x, gamma=gamma, dy=dy: layer_norm_bwd(x, gamma, dy)] * count
    steps = {
        "B5": lambda: (mode_calls[0](), mode_calls[1](), mode_calls[1]()),
        "B9a": lambda: (fwd_calls[0](), fwd_calls[1](), fwd_calls[1]()),
        "B9b": lambda: (block_calls[0](), block_calls[1](), block_calls[1]()),
        "B8a": lambda: [call() for call in ln_fwd],
        "B8b": lambda: [call() for call in ln_bwd],
    }
    out = {}
    for name, step in steps.items():
        parts = device_ms(step, by=family)
        out[name] = {"event": time_ms(step), "device": sum(parts.values()), "parts": parts}
    return out


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def bound_ms(moved_bytes: int, flops: float) -> tuple[float, float]:
    """(ms at the HBM rate, ms at the dense bf16 rate) for one call."""
    return moved_bytes / HBM_BYTES_PER_S * 1e3, flops / PEAK_BF16_FLOPS * 1e3


def check_kernels(torch, records):
    """Phase 3. Fills ``records[name]`` with errors and per-step times."""
    import torch.nn.functional as F

    from vil_tpu_torch.ops import masks as masks_lib
    from vil_tpu_torch.ops import sliding_chunk as sc
    from vil_tpu_torch.ops.kernels import (
        full_attention_bwd, full_attention_bwd_reference, full_attention_fwd,
        full_attention_reference, layer_norm_bwd, layer_norm_bwd_reference, layer_norm_fwd,
        layer_norm_reference, mask_to_additive, vil_attention_bwd,
        vil_attention_bwd_reference, vil_attention_fwd, vil_attention_halo_bwd,
        vil_attention_halo_bwd_reference, vil_attention_halo_fwd,
        vil_attention_halo_reference, vil_attention_reference, vil_block_bwd,
        vil_block_bwd_reference, vil_block_fwd, vil_block_fwd_reference, vil_block_reference,
        vil_mode_attention_bwd,
        vil_mode_attention_bwd_reference, vil_mode_attention_fwd, vil_mode_attention_reference,
    )
    from vil_tpu_torch.ops.kernels.vil_attention_halo import halo_neighborhood
    from vil_tpu_torch.tools import layout_probe

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    randn = lambda *s, scale=1.0: torch.randn(*s, generator=gen, device=dev) * scale
    cast = lambda ts, dtype: [None if t is None else t.to(dtype) for t in ts]

    def max_err(out, ref):
        return (out.float() - ref.float()).abs().max().item()

    def rel_err(out, ref):
        return max_err(out, ref) / max(1.0, ref.float().abs().max().item())

    def scaled_err(out, ref):
        """max|err| / max|ref| with no floor (max|err| where ref is all 0)."""
        top = ref.float().abs().max().item()
        return max_err(out, ref) / top if top else max_err(out, ref)

    def check(what, err, tol):
        if not err <= tol:
            raise AssertionError(f"{what}: error {err} > {tol}")

    def chunk_scaled(out, ref, grads, refs):
        """Scaled errors of a bf16 sliding-chunk forward's out and its
        backward's dq, dk, dv, dk_glo, dv_glo and (biased) dbias."""
        names = ("out", "dq", "dk", "dv", "dk_glo", "dv_glo", "dbias")
        return {n: scaled_err(x, r) for n, x, r in zip(names, (out, *grads), (ref, *refs))
                if r is not None}

    def scaled_text(errs, tol=CHUNK_SCALED_TOL):
        return ("; scaled " + ", ".join(f"{n} {e:.3e}" for n, e in errs.items())
                + f" (tol {tol:g})") if errs else ""

    def account(name, per_step, ms, plain_ms, moved, flops, library_ms=None):
        """Add one launch shape's per-step share to the kernel's record."""
        rec = records[name]
        t_bytes, t_ops = bound_ms(moved, flops)
        rec["ms"] += per_step * ms
        rec["plain_ms"] += per_step * plain_ms
        rec["bound_ms"] += per_step * max(t_bytes, t_ops)
        rec["_bytes_ms"] += per_step * t_bytes
        rec["_ops_ms"] += per_step * t_ops
        if library_ms is not None:
            rec["library_ms"] = (rec["library_ms"] or 0.0) + per_step * library_ms
        return (f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {max(t_bytes, t_ops):.4f} "
                f"ms ({'bytes' if t_bytes >= t_ops else 'operations'})")

    def sdpa_times(q, k, v, g, attn_mask=None):
        """(forward ms, backward-alone ms, forward+backward ms) of
        scaled_dot_product_attention on the same values (q is pre-scaled, so
        scale=1), (batch, H, rows, M) operands."""
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        sdpa = lambda: F.scaled_dot_product_attention(*leaves, attn_mask=attn_mask, scale=1.0)
        with torch.no_grad():
            fwd = time_ms(sdpa)
        o = sdpa()
        bwd = time_ms(lambda: torch.autograd.grad(o, leaves, g, retain_graph=True))
        both = time_ms(lambda: torch.autograd.grad(sdpa(), leaves, g))
        return fwd, bwd, both

    def chunk_case(label, B, nx, ny, w, C, H, nglo, exact, with_bias, mode=0, per_step=0.0,
                   bias=None, timed=False):
        """A sliding-chunk case: B1/B2 at mode 0, B5/B6 (the sampled
        neighbour of ``mode``) at modes 1..8. ``per_step`` is the case's
        share of one training step's launches; ``timed`` times it without a
        share. ``bias`` (f32, front order) replaces the random one."""
        padx, pady, mx, my = sc.chunk_grid(nx, ny, w)
        w2, M = w * w, C // H
        cols = nglo + (9 if mode == 0 else 2) * w2
        if mode == 0:  # B2 and B6 take the forward's out (their bf16 kernels' δ)
            name, fwd = "vil_attention", vil_attention_fwd
            bwd = lambda *a, bias, g, out, lse: vil_attention_bwd(*a, bias, g, out, mask, lse, H)
            fwd_ref, bwd_ref = vil_attention_reference, vil_attention_bwd_reference
            tail = ()
        else:
            name, fwd = "vil_mode_attention", vil_mode_attention_fwd
            bwd = lambda *a, bias, g, out, lse: vil_mode_attention_bwd(*a, bias, g, out, mask,
                                                                       lse, H, mode)
            fwd_ref, bwd_ref = vil_mode_attention_reference, vil_mode_attention_bwd_reference
            tail = (mode,)
        mask = torch.from_numpy(mask_to_additive(
            masks_lib.invalid_mask(mx, my, padx, pady, w, exact, mode), mx, my, w2, nglo,
        )).to(dev)
        acts = [randn(B, mx, my, w2, C, scale=C ** -0.25) for _ in range(3)]
        acts += [randn(B, nglo, C) if nglo else None for _ in range(2)]
        g0 = randn(B, mx, my, w2, C)
        if bias is None and with_bias:
            bias = randn(H, w2, cols, scale=0.5)
        for dtype, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
            a = cast(acts, dtype)
            g = g0.to(dtype)
            a32 = cast(a, torch.float32)
            out, lse = fwd(*a, bias, mask, H, *tail, with_lse=True)
            ref, ref_lse = fwd_ref(*a32, bias, mask, H, *tail, with_lse=True)
            grads = bwd(*a, bias=bias, g=g, out=out, lse=lse)
            refs = bwd_ref(*a32, bias, g.float(), mask, H, *tail)
            torch.cuda.synchronize()
            e_out, e_lse = max_err(out, ref), max_err(lse, ref_lse)
            e_grad = max(rel_err(x, r) for x, r in zip(grads, refs) if r is not None)
            e_abs = max(max_err(x, r) for x, r in zip(grads, refs) if r is not None)
            dt = str(dtype)[6:]
            e_scaled = chunk_scaled(out, ref, grads, refs) if dtype == torch.bfloat16 else {}
            phase("kernels", f"{name} {label} {dt}: out {e_out:.3e} (tol {tol:g}), lse "
                             f"{e_lse:.3e} (tol {LSE_TOL:g}); grads rel {e_grad:.3e} "
                             f"(tol {GRAD_TOL[dt]:g}){scaled_text(e_scaled)}")
            check(f"{name} fwd {label} {dt}", e_out, tol)
            check(f"{name} lse {label} {dt}", e_lse, LSE_TOL)
            check(f"{name} bwd {label} {dt}", e_grad, GRAD_TOL[dt])
            for n, e in e_scaled.items():
                check(f"{name} {n} scaled {label} {dt}", e, CHUNK_SCALED_TOL)
            if (per_step or timed) and dtype == torch.bfloat16:  # the training step's type
                if per_step:
                    records[f"{name}_fwd"]["max_abs_err"] = max(
                        records[f"{name}_fwd"]["max_abs_err"], e_out)
                    records[f"{name}_bwd"]["max_abs_err"] = max(
                        records[f"{name}_bwd"]["max_abs_err"], e_abs)
                # the library comparator: SDPA over the materialised
                # [glo ‖ neighbourhood] keys, one batch row per (image, chunk),
                # the bias added to the mask
                heads = lambda t: t.view(B * mx * my, -1, H, M).transpose(1, 2)

                def materialise():
                    kv = []
                    for t, t_glo in ((a[1], a[3]), (a[2], a[4])):
                        nbh = sc.neighborhood(t, mode)  # (B, mx, my, K·W², C)
                        if nglo:
                            nbh = torch.cat([t_glo[:, None, None].expand(B, mx, my, nglo, C),
                                             nbh], dim=3)
                        kv.append(heads(nbh))
                    return kv

                cat_ms = time_ms(materialise)
                k_cat, v_cat = materialise()
                full_mask = (mask[:, :, None] if bias is None else
                             mask[:, :, None] + bias[None, None]).to(dtype)
                attn_mask = (full_mask[None].expand(B, -1, -1, -1, -1, -1)
                             .reshape(B * mx * my, full_mask.shape[2], -1, cols))
                lib_fwd, lib_bwd, lib_both = sdpa_times(heads(a[0]), k_cat, v_cat, heads(g),
                                                        attn_mask)
                act = B * mx * my * w2 * C
                fwd_flops = 4.0 * act * cols
                msg = account(
                    f"{name}_fwd", per_step,
                    time_ms(lambda: fwd(*a, bias, mask, H, *tail, with_lse=True)),
                    time_ms(lambda: fwd_ref(*a, bias, mask, H, *tail, with_lse=True)),
                    nbytes(*a, bias, mask, out, lse), fwd_flops, lib_fwd)
                share = f"x{per_step:g} per step" if per_step else "per call"
                phase("kernels", f"  {name}_fwd with lse, {share}: {msg}, SDPA "
                                 f"forward {lib_fwd:.4f} ms")
                msg = account(
                    f"{name}_bwd", per_step,
                    time_ms(lambda: bwd(*a, bias=bias, g=g, out=out, lse=lse)),
                    time_ms(lambda: bwd_ref(*a, bias, g, mask, H, *tail)),
                    nbytes(*a, bias, mask, lse, g, *grads), 2.5 * fwd_flops, lib_bwd)
                phase("kernels", f"  {name}_bwd, {share}: {msg}, SDPA backward "
                                 f"{lib_bwd:.4f} ms, SDPA forward+backward {lib_both:.4f} ms")
                phase("kernels", f"  concatenating the [glo | {cols // w2}-chunk] keys and "
                                 f"values for SDPA (not in its times): {cat_ms:.4f} ms")
                if mode == 0:
                    serve_ms = time_ms(lambda: fwd(*a, bias, mask, H))
                    phase("kernels", f"  {name}_fwd without lse (serving): {serve_ms:.4f} ms")

    def full_case(label, B, N, C, H, with_bias, per_step=0, timed=False, bias=None):
        """A dense case; ``timed`` times it without a share of the step.
        ``bias`` (f32) replaces the random one."""
        M = C // H
        acts = [randn(B, N, C, scale=C ** -0.25) for _ in range(3)]
        g0 = randn(B, N, C)
        if bias is None and with_bias:
            bias = randn(H, N, N, scale=0.5)
        for dtype, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
            a = cast(acts, dtype)
            g = g0.to(dtype)
            a32 = cast(a, torch.float32)
            out, lse = full_attention_fwd(*a, bias, H, with_lse=True)
            ref, ref_lse = full_attention_reference(*a32, bias, H, with_lse=True)
            grads = full_attention_bwd(*a, bias, g, out, lse, H)
            refs = full_attention_bwd_reference(*a32, bias, g.float(), H)
            torch.cuda.synchronize()
            e_out, e_lse = max_err(out, ref), max_err(lse, ref_lse)
            e_grad = max(rel_err(x, r) for x, r in zip(grads, refs) if r is not None)
            e_abs = max(max_err(x, r) for x, r in zip(grads, refs) if r is not None)
            dt = str(dtype)[6:]
            scaled = ""
            if dtype == torch.bfloat16:
                e_scaled = {n: scaled_err(x, r) for n, x, r in
                            zip(("out", "dq", "dk", "dv"), (out, *grads[:3]), (ref, *refs[:3]))}
                scaled = ("; scaled " + ", ".join(f"{n} {e:.3e}" for n, e in e_scaled.items())
                          + f" (tol {DENSE_SCALED_TOL:g})")
            phase("kernels", f"full_attention {label} {dt}: out {e_out:.3e} (tol {tol:g}), lse "
                             f"{e_lse:.3e} (tol {LSE_TOL:g}); grads rel {e_grad:.3e} "
                             f"(tol {GRAD_TOL[dt]:g}){scaled}")
            check(f"full fwd {label} {dt}", e_out, tol)
            check(f"full lse {label} {dt}", e_lse, LSE_TOL)
            check(f"full bwd {label} {dt}", e_grad, GRAD_TOL[dt])
            if dtype == torch.bfloat16:
                for n, e in e_scaled.items():
                    check(f"full {n} scaled {label} {dt}", e, DENSE_SCALED_TOL)
            if (per_step or timed) and dtype == torch.bfloat16:
                if per_step:
                    records["full_attention_fwd"]["max_abs_err"] = max(
                        records["full_attention_fwd"]["max_abs_err"], e_out)
                    records["full_attention_bwd"]["max_abs_err"] = max(
                        records["full_attention_bwd"]["max_abs_err"], e_abs)
                # the library comparator: SDPA on the same values, heads as a
                # batch dimension
                lib_fwd, lib_bwd, lib_both = sdpa_times(
                    *(t.view(B, N, H, M).transpose(1, 2) for t in (*a, g)),
                    attn_mask=None if bias is None else bias.to(dtype)[None])
                fwd_flops = 4.0 * B * N * N * C
                share = f"x{per_step} per step" if per_step else "per call"
                msg = account(
                    "full_attention_fwd", per_step,
                    time_ms(lambda: full_attention_fwd(*a, bias, H, with_lse=True)),
                    time_ms(lambda: full_attention_reference(*a, bias, H, with_lse=True)),
                    nbytes(*a, bias, out, lse), fwd_flops, lib_fwd)
                phase("kernels", f"  full_attention_fwd with lse, {share}: {msg}, "
                                 f"SDPA forward {lib_fwd:.4f} ms")
                msg = account(
                    "full_attention_bwd", per_step,
                    time_ms(lambda: full_attention_bwd(*a, bias, g, out, lse, H)),
                    time_ms(lambda: full_attention_bwd_reference(*a, bias, g, H)),
                    nbytes(*a, bias, lse, g, *grads), 2.5 * fwd_flops, lib_bwd)
                phase("kernels", f"  full_attention_bwd, {share}: {msg}, SDPA "
                                 f"backward {lib_bwd:.4f} ms, SDPA forward+backward "
                                 f"{lib_both:.4f} ms")
                serve_ms = time_ms(lambda: full_attention_fwd(*a, bias, H))
                phase("kernels", f"  full_attention_fwd without lse (serving): {serve_ms:.4f} ms")

    def ln_case(rows, C, per_step=0):
        """A LayerNorm case: B8a and B8b at (rows, C), ``per_step`` of the
        fused training step's launches; B8b launched twice, bit for bit."""
        x0, dy0 = randn(rows, C, scale=2.0) + 0.5, randn(rows, C)
        gamma, beta = randn(C, scale=0.2) + 1.0, randn(C, scale=0.1)
        for dtype, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
            x, dy = x0.to(dtype), dy0.to(dtype)
            y = layer_norm_fwd(x, gamma, beta)
            grads = layer_norm_bwd(x, gamma, dy)
            again = layer_norm_bwd(x, gamma, dy)
            ref = layer_norm_reference(x.float(), gamma, beta)
            refs = layer_norm_bwd_reference(x.float(), gamma, dy.float())
            torch.cuda.synchronize()
            e_out = max_err(y, ref)
            e_grad = max(rel_err(a, r) for a, r in zip(grads, refs))
            differ = [n for n, a, b in zip(("dx", "dgamma", "dbeta"), grads, again)
                      if not torch.equal(a, b)]
            dt = str(dtype)[6:]
            phase("kernels", f"layer_norm ({rows},{C}) {dt}: y {e_out:.3e} (tol {tol:g}); "
                             f"dx, dgamma, dbeta rel {e_grad:.3e} (tol {GRAD_TOL[dt]:g}); a "
                             f"second backward bitwise equal: {not differ}")
            check(f"layer_norm fwd ({rows},{C}) {dt}", e_out, tol)
            check(f"layer_norm bwd ({rows},{C}) {dt}", e_grad, GRAD_TOL[dt])
            if differ:
                raise AssertionError(f"layer_norm bwd ({rows},{C}) {dt}: two launches differ "
                                     f"in {differ}")
            if not (per_step and dtype == torch.bfloat16):
                continue
            records["layer_norm_fwd"]["max_abs_err"] = max(
                records["layer_norm_fwd"]["max_abs_err"], e_out)
            records["layer_norm_bwd"]["max_abs_err"] = max(
                records["layer_norm_bwd"]["max_abs_err"],
                max(max_err(a, r) for a, r in zip(grads, refs)))
            # the library: F.layer_norm on the same bf16 values, γ and β in
            # bf16 as nn.LayerNorm keeps them; its backward timed alone on a
            # saved forward
            leaves = [t.detach().requires_grad_() for t in (x, gamma.to(dtype), beta.to(dtype))]
            lib = lambda: F.layer_norm(leaves[0], (C,), leaves[1], leaves[2], 1e-6)
            with torch.no_grad():
                lib_fwd = time_ms(lib)
            y_lib = lib()
            lib_bwd = time_ms(lambda: torch.autograd.grad(y_lib, leaves, dy, retain_graph=True))
            elems = rows * C
            msg = account("layer_norm_fwd", per_step,
                          time_ms(lambda: layer_norm_fwd(x, gamma, beta)),
                          time_ms(lambda: layer_norm_reference(x, gamma, beta)),
                          nbytes(x, gamma, beta, y), 8.0 * elems, lib_fwd)
            phase("kernels", f"  layer_norm_fwd ({rows},{C}), x{per_step} per step: {msg}, "
                             f"F.layer_norm {lib_fwd:.4f} ms")
            msg = account("layer_norm_bwd", per_step,
                          time_ms(lambda: layer_norm_bwd(x, gamma, dy)),
                          time_ms(lambda: layer_norm_bwd_reference(x, gamma, dy)),
                          nbytes(x, gamma, dy, *grads), 16.0 * elems, lib_bwd)
            phase("kernels", f"  layer_norm_bwd ({rows},{C}), x{per_step} per step: {msg}, "
                             f"F.layer_norm backward {lib_bwd:.4f} ms")

    def block_case(label, B, nx, ny, w, C, H, nglo, with_bias, per_step=0, bias_scale=0.02,
                   backward=True, bias=None, timed=False):
        """A fused-block case: B9a and (``backward``) B9b, ``per_step`` of the
        fused training step's launches (``timed``: timed without a share);
        q, k, v and output biases of ``bias_scale`` (bq scale-folded).
        ``bias`` (the f32 score bias, front order) replaces the random one."""
        padx, pady, mx, my = sc.chunk_grid(nx, ny, w)
        w2, M = w * w, C // H
        cols = nglo + 9 * w2
        mask = torch.from_numpy(mask_to_additive(
            masks_lib.invalid_mask(mx, my, padx, pady, w, 0, 0), mx, my, w2, nglo)).to(dev)
        x0, g0 = randn(B, mx, my, w2, C), randn(B, mx, my, w2, C)
        # wq and bq scale-folded as the model passes them
        w0 = [randn(C, C, scale=C ** -0.5 * (M ** -0.5 if i == 0 else 1.0)) for i in range(4)]
        b0 = [randn(C, scale=bias_scale * (M ** -0.5 if i == 0 else 1.0)) for i in range(4)]
        glo0 = [randn(B, nglo, C) if nglo else None for _ in range(2)]
        if bias is None and with_bias:
            bias = randn(H, w2, cols, scale=0.5)
        for dtype, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
            x, g = x0.to(dtype), g0.to(dtype)
            ws = [t.to(dtype) for t in w0]
            ops = [x, ws[0], b0[0], ws[1], b0[1], ws[2], b0[2], ws[3], b0[3],
                   *cast(glo0, dtype), bias]
            ops32 = [None if t is None else t.float() for t in ops]
            y, k, v, lse, q, attn = vil_block_fwd(*ops, mask, H, with_lse=True, saved=True)
            grads = vil_block_bwd(*ops, g, mask, lse, H, (q, k, v, attn)) if backward else ()
            refs = vil_block_bwd_reference(*ops32, g.float(), mask, H) if backward else ()
            ry, rk, rv = vil_block_reference(*ops32, mask, H)
            # the LSE of the plain attention over the kernel's own q and k
            r_lse = vil_attention_reference(*(t.float() for t in (q, k, v)), *ops32[9:11],
                                            bias, mask, H, with_lse=True)[1]
            torch.cuda.synchronize()
            e_out = max(max_err(a, r) for a, r in ((y, ry), (k, rk), (v, rv)))
            e_lse = max_err(lse, r_lse)
            # dbk (index 4) is held at dWk's scale: its exact value is 0 (a
            # shift common to a query's scores leaves its softmax alone), so
            # what comes out is the rounding of a sum over the rows of terms
            # of dWk's size
            e_grad = max((max_err(a, r) / max(1.0, refs[3 if i == 4 else i].abs().max().item())
                          for i, (a, r) in enumerate(zip(grads, refs)) if r is not None),
                         default=0.0)
            e_abs = max((max_err(a, r) for a, r in zip(grads, refs) if r is not None),
                        default=0.0)
            dt = str(dtype)[6:]
            e_scaled, same, differ = {}, "" if backward else "; forward only", []
            if dtype == torch.bfloat16:
                # B9a's outputs, and every gradient, to max|err| / max|ref|
                # with no floor (dbk at dWk's scale, as above), and a second
                # B9b launch bit for bit
                fwd_refs = vil_block_fwd_reference(*ops32, mask, H, with_lse=True)
                for n, a, r in zip(BLOCK_FWD_OUTS, (y, q, k, v, attn, lse), fwd_refs):
                    e_scaled[n] = scaled_err(a, r)
                for i, (n, a, r) in enumerate(zip(BLOCK_GRADS, grads, refs)):
                    if r is not None:
                        e_scaled[n] = max_err(a, r) / refs[3 if i == 4 else i].abs().max().item()
                if backward:
                    again = vil_block_bwd(*ops, g, mask, lse, H, (q, k, v, attn))
                    differ = [n for n, a, b in zip(BLOCK_GRADS, grads, again)
                              if a is not None and not torch.equal(a, b)]
                    same = f"; a second launch bitwise equal: {not differ}"
            phase("kernels", f"vil_block {label} {dt}: y, k, v {e_out:.3e} (tol {tol:g}), lse "
                             f"{e_lse:.3e} (tol {LSE_TOL:g}); grads rel {e_grad:.3e} "
                             f"(tol {GRAD_TOL[dt]:g}){scaled_text(e_scaled)}{same}")
            check(f"vil_block fwd {label} {dt}", e_out, tol)
            check(f"vil_block lse {label} {dt}", e_lse, LSE_TOL)
            check(f"vil_block bwd {label} {dt}", e_grad, GRAD_TOL[dt])
            for n, e in e_scaled.items():
                check(f"vil_block {n} scaled {label} {dt}", e, CHUNK_SCALED_TOL)
            if differ:
                raise AssertionError(f"vil_block bwd {label}: two launches differ in {differ}")
            if not ((per_step or timed) and dtype == torch.bfloat16):
                continue
            if per_step:
                records["vil_block_fwd"]["max_abs_err"] = max(
                    records["vil_block_fwd"]["max_abs_err"], e_out)
                records["vil_block_bwd"]["max_abs_err"] = max(
                    records["vil_block_bwd"]["max_abs_err"], e_abs)
            share = f"x{per_step} per step" if per_step else "per call"
            R = B * mx * my * w2
            attn_flops = 4.0 * R * C * cols
            fwd_in = (x, *ws, *b0, *cast(glo0, dtype), bias, mask)
            msg = account("vil_block_fwd", per_step,
                          time_ms(lambda: vil_block_fwd(*ops, mask, H, with_lse=True,
                                                        saved=True)),
                          time_ms(lambda: vil_block_reference(*ops, mask, H)),
                          nbytes(*fwd_in, y, k, v, lse), 8.0 * R * C * C + attn_flops)
            phase("kernels", f"  vil_block_fwd with lse, q and attn, {share}: "
                             f"{msg}; no single PyTorch call computes the block (library: "
                             f"null)")
            msg = account("vil_block_bwd", per_step,
                          time_ms(lambda: vil_block_bwd(*ops, g, mask, lse, H,
                                                        (q, k, v, attn))),
                          time_ms(lambda: vil_block_bwd_reference(*ops, g, mask, H)),
                          nbytes(*fwd_in, q, k, v, attn, g, lse, *grads),
                          16.0 * R * C * C + 2.5 * attn_flops + 4.0 * R * C * nglo)
            phase("kernels", f"  vil_block_bwd from the saved q, k, v, attn, {share}: {msg}; "
                             f"library: null")
            serve_ms = time_ms(lambda: vil_block_fwd(*ops, mask, H))
            phase("kernels", f"  vil_block_fwd without lse (serving): {serve_ms:.4f} ms")

    def halo_case(label, B, nx, ny, w, C, H, nglo, exact, with_bias, splits, per_fwd=0,
                  per_bwd=0, bias=None, timed=False):
        """Halo-input cases: B7a and B7b on every shard of the grid split
        over each D of ``splits``, against their plain versions; the shards
        together against B1 and B2 on the whole grid. ``per_fwd`` is the
        case's share of one spatial forward's B7a launches on one rank
        (D = 1), ``per_bwd`` its share of the spatial backward path's B7b
        launches; with ``per_fwd`` or ``timed`` every D's shard 0 is timed
        (all shards do the same work; SDPA with the bias in its mask)."""
        padx, pady, mx, my = sc.chunk_grid(nx, ny, w)
        w2, M = w * w, C // H
        cols = nglo + 9 * w2
        mask = torch.from_numpy(mask_to_additive(
            masks_lib.invalid_mask(mx, my, padx, pady, w, exact, 0), mx, my, w2, nglo)).to(dev)
        acts = [randn(B, mx, my, w2, C, scale=C ** -0.25) for _ in range(3)]
        acts += [randn(B, nglo, C) if nglo else None for _ in range(2)]
        g0 = randn(B, mx, my, w2, C)
        if bias is None and with_bias:
            bias = randn(H, w2, cols, scale=0.5)
        for dtype, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
            a = cast(acts, dtype)
            g = g0.to(dtype)
            dt = str(dtype)[6:]
            b1_out, b1_lse = vil_attention_fwd(*a, bias, mask, H, with_lse=True)
            b2_grads = vil_attention_bwd(*a, bias, g, b1_out, mask, b1_lse, H)
            for D in splits:
                mxs = mx // D
                outs, e_out, e_lse, e_grad, e_abs, e_scaled = [], 0.0, 0.0, 0.0, 0.0, {}
                dk, dv = (torch.zeros(B, mx, my, w2, C, device=dev) for _ in range(2))
                shards = []
                for sh in range(D):
                    rows = [(sh * mxs - 1) % mx, *range(sh * mxs, (sh + 1) * mxs),
                            ((sh + 1) * mxs) % mx]
                    ops = [a[0][:, sh * mxs:(sh + 1) * mxs].contiguous(), a[1][:, rows].contiguous(),
                           a[2][:, rows].contiguous(), a[3], a[4], bias]
                    m_rows = mask[sh * mxs:(sh + 1) * mxs]
                    gs = g[:, sh * mxs:(sh + 1) * mxs].contiguous()
                    ops32 = cast(ops, torch.float32)
                    out, lse = vil_attention_halo_fwd(*ops, m_rows, H, with_lse=True)
                    ref, ref_lse = vil_attention_halo_reference(*ops32, m_rows, H, with_lse=True)
                    grads = vil_attention_halo_bwd(*ops, gs, out, m_rows, lse, H)
                    refs = vil_attention_halo_bwd_reference(*ops32, gs.float(), m_rows, H)
                    torch.cuda.synchronize()
                    if dtype == torch.bfloat16:
                        for n, e in chunk_scaled(out, ref, grads, refs).items():
                            e_scaled[n] = max(e_scaled.get(n, 0.0), e)
                    e_out, e_lse = max(e_out, max_err(out, ref)), max(e_lse, max_err(lse, ref_lse))
                    e_grad = max(e_grad, *(rel_err(x, r) for x, r in zip(grads, refs)
                                           if r is not None))
                    e_abs = max(e_abs, *(max_err(x, r) for x, r in zip(grads, refs)
                                         if r is not None))
                    outs.append(out)
                    for e, row in enumerate(rows):  # the halo rows' owners
                        dk[:, row] += grads[1][:, e].float()
                        dv[:, row] += grads[2][:, e].float()
                    shards.append((ops, m_rows, gs, out, lse, grads))
                e_b1 = max_err(torch.cat(outs, dim=1), b1_out)
                e_b2 = max(rel_err(dk, b2_grads[1]), rel_err(dv, b2_grads[2]))
                phase("kernels", f"vil_attention_halo {label}, D {D} ({mxs} rows a shard) {dt}: "
                                 f"out {e_out:.3e} (tol {tol:g}), lse {e_lse:.3e} (tol "
                                 f"{LSE_TOL:g}); grads rel {e_grad:.3e} (tol {GRAD_TOL[dt]:g})"
                                 f"{scaled_text(e_scaled)}; shards vs B1 on the whole grid "
                                 f"{e_b1:.3e}, folded dK/dV vs B2 rel {e_b2:.3e}")
                check(f"halo fwd {label} D {D} {dt}", e_out, tol)
                check(f"halo lse {label} D {D} {dt}", e_lse, LSE_TOL)
                check(f"halo bwd {label} D {D} {dt}", e_grad, GRAD_TOL[dt])
                check(f"halo shards vs B1 {label} D {D} {dt}", e_b1, tol)
                check(f"halo folded dK/dV vs B2 {label} D {D} {dt}", e_b2, GRAD_TOL[dt])
                for n, e in e_scaled.items():
                    check(f"halo {n} scaled {label} D {D} {dt}", e, CHUNK_SCALED_TOL)
                if not ((per_fwd or timed) and dtype == torch.bfloat16):
                    continue
                if per_fwd:
                    records["vil_attention_halo_fwd"]["max_abs_err"] = max(
                        records["vil_attention_halo_fwd"]["max_abs_err"], e_out)
                    records["vil_attention_halo_bwd"]["max_abs_err"] = max(
                        records["vil_attention_halo_bwd"]["max_abs_err"], e_abs)
                ops, m_rows, gs, out, lse, grads = shards[0]
                heads = lambda t: t.view(B * mxs * my, -1, H, M).transpose(1, 2)

                def materialise():  # [glo ‖ 3×3 halo neighbourhood] keys, values
                    kv = []
                    for t, t_glo in ((ops[1], ops[3]), (ops[2], ops[4])):
                        nbh = halo_neighborhood(t)
                        if nglo:
                            nbh = torch.cat([t_glo[:, None, None].expand(B, mxs, my, nglo, C),
                                             nbh], dim=3)
                        kv.append(heads(nbh))
                    return kv

                k_cat, v_cat = materialise()
                rows_mask = (m_rows[:, :, None] if bias is None else
                             m_rows[:, :, None] + bias[None, None]).to(dtype)
                attn_mask = (rows_mask[None].expand(B, -1, -1, -1, -1, -1)
                             .reshape(B * mxs * my, rows_mask.shape[2], -1, cols))
                lib_fwd, lib_bwd, _ = sdpa_times(heads(ops[0]), k_cat, v_cat, heads(gs), attn_mask)
                act = B * mxs * my * w2 * C
                fwd_flops = 4.0 * act * cols
                fwd_ms = time_ms(lambda: vil_attention_halo_fwd(*ops, m_rows, H))
                fwd_lse_ms = time_ms(lambda: vil_attention_halo_fwd(*ops, m_rows, H,
                                                                    with_lse=True))
                bwd_ms = time_ms(lambda: vil_attention_halo_bwd(*ops, gs, out, m_rows, lse, H))
                fwd_plain = time_ms(lambda: vil_attention_halo_reference(*ops, m_rows, H))
                bwd_plain = time_ms(lambda: vil_attention_halo_bwd_reference(*ops, gs, m_rows, H))
                fwd_bytes = nbytes(*ops, m_rows, out)
                bwd_bytes = nbytes(*ops, m_rows, lse, gs, *grads)
                one_rank = D == 1  # the records hold the one-rank paths
                f_msg = account("vil_attention_halo_fwd", per_fwd * one_rank, fwd_ms, fwd_plain,
                                fwd_bytes, fwd_flops, lib_fwd)
                b_msg = account("vil_attention_halo_bwd", per_bwd * one_rank, bwd_ms, bwd_plain,
                                bwd_bytes, 2.5 * fwd_flops, lib_bwd)
                phase("kernels", f"  vil_attention_halo_fwd {label}, D {D}, per shard (serving, "
                                 f"no lse): {f_msg}, SDPA forward {lib_fwd:.4f} ms; with lse "
                                 f"{fwd_lse_ms:.4f} ms")
                phase("kernels", f"  vil_attention_halo_bwd {label}, D {D}, per shard: {b_msg}, "
                                 f"SDPA backward {lib_bwd:.4f} ms")

    def probe_case():
        """P's two entry points: exactly 2x at the probe's shape in bf16, in
        the base layout and on its permuted view (both the flat path, timed
        with the card's share of a call), then on a ragged shape, on views
        that start off a 16-byte boundary (the flat path's scalar tail and
        head) and on a slice (the strided path)."""
        x = randn(layout_probe.B, layout_probe.MX, layout_probe.MY, layout_probe.W2,
                  layout_probe.C).to(torch.bfloat16)
        xt = x.permute(1, 2, 3, 0, 4)
        split = probe_split(torch)
        for name, fn, arg in (("consume_base", layout_probe.consume_base, x),
                              ("consume_perm", layout_probe.consume_perm, xt)):
            y = fn(arg)
            torch.cuda.synchronize()
            err = max_err(y, arg * 2)
            path = layout_probe.probe_path(arg.shape, arg.stride())
            phase("kernels", f"{name} (P) {tuple(arg.shape)} bf16, strides {arg.stride()}, "
                             f"path {path}: max|err| vs x*2 {err:.3e} (tol 0)")
            check(f"{name} vs x*2", err, 0.0)
            records[name]["max_abs_err"] = err
            lib = split["torch.mul " + name[len("consume_"):]]
            msg = account(name, 1, split[name]["event"],
                          time_ms(lambda: layout_probe.scale2_reference(arg)),
                          nbytes(arg, y), float(arg.numel()), lib["event"])
            phase("kernels", f"  {name} per call: {msg}, library torch.mul "
                             f"{lib['event']:.4f} ms; the card's time {split[name]['device']:.4f} "
                             f"ms (torch.mul {lib['device']:.4f}), 100 calls between one pair "
                             f"of events {split[name]['burst']:.4f} ms a call (torch.mul "
                             f"{lib['burst']:.4f})")
        # the flat path's scalar head and tail, and the strided path
        flat = randn(3 * 2 * 2 * 7 * 5 + 8).to(torch.bfloat16)
        cases = [(f"ragged (3,2,2,7,5), {lead} element(s) into its storage",
                  flat[lead:lead + 420].view(3, 2, 2, 7, 5)) for lead in (0, 1)]
        cases.append(("a slice of the base layout, [:, 1:7]", x[:, 1:7]))
        for label, arg in cases:
            for name, fn, view in (("consume_base", layout_probe.consume_base, arg),
                                   ("consume_perm", layout_probe.consume_perm,
                                    arg.permute(1, 2, 3, 0, 4))):
                y = fn(view)
                torch.cuda.synchronize()
                err = max_err(y, view * 2)
                path = layout_probe.probe_path(view.shape, view.stride())
                phase("kernels", f"{name} (P) {label} bf16, path {path}: max|err| vs x*2 "
                                 f"{err:.3e} (tol 0)")
                check(f"{name} {label} vs x*2", err, 0.0)

    # ViL-Small 224²: stage 1 (1 block) and stage 2 (2 blocks) sliding-chunk
    chunk_case("stage1 (64,8,8,49,96) H3", 64, 56, 56, 7, 96, 3, 1, 0, False, per_step=1)
    chunk_case("stage2 (64,4,4,49,192) H3", 64, 28, 28, 7, 192, 3, 1, 0, False, per_step=2)
    chunk_case("biased, padded 3x3 grid, nglo 2", 2, 19, 20, 7, 64, 2, 2, 0, True)
    chunk_case("SW_EXACT 1, 2x2 grid, nglo 0", 2, 13, 14, 7, 32, 1, 0, 1, True)
    chunk_case("SW_EXACT -1, W 4", 3, 14, 15, 4, 48, 3, 1, -1, False)
    chunk_case("cyclic 1x2 grid, nglo 5", 2, 7, 14, 7, 64, 2, 5, 0, False)
    # the same blocks in random-shift training, at two sampled neighbours
    # each: a step's share is the mean over the two modes
    for mode in (1, 6):
        chunk_case(f"mode {mode} stage1 (64,8,8,49,96) H3", 64, 56, 56, 7, 96, 3, 1, 0, False,
                   mode, per_step=0.5)
        chunk_case(f"mode {mode} stage2 (64,4,4,49,192) H3", 64, 28, 28, 7, 192, 3, 1, 0,
                   False, mode, per_step=1)
    chunk_case("mode 3 biased, padded 3x4 grid, nglo 2", 2, 19, 25, 7, 64, 2, 2, 0, True, 3)
    chunk_case("mode 2 cyclic 1x2 grid (sampled = self)", 2, 7, 14, 7, 32, 1, 1, 0, False, 2)
    chunk_case("mode 7 cyclic 2x2 grid, biased, nglo 0", 2, 13, 14, 7, 32, 1, 0, 0, True, 7)
    chunk_case("mode 5 SW_EXACT -1, W 4", 3, 14, 15, 4, 48, 3, 1, -1, False, 5)
    # W 9: two 64-row slices a chunk and 163 columns in 3 key tiles; and a
    # head dim of 128 on a 3x3 grid without global rows
    chunk_case("mode 8 W 9, 3x3 grid, biased, nglo 1", 2, 27, 27, 9, 64, 2, 1, 0, True, 8)
    chunk_case("mode 6 3x3 grid, nglo 0, head dim 128", 2, 21, 21, 7, 256, 2, 0, 0, False, 6)
    # stage 3 (8 blocks) and stage 4 (1 block) dense
    full_case("stage3 (64,197,384) H6", 64, 197, 384, 6, False, 8)
    full_case("stage4 (64,49,768) H12", 64, 49, 768, 12, False, 1)
    full_case("biased N 130", 2, 130, 96, 3, True)
    full_case("N 1025", 2, 1025, 192, 3, False)
    # every head dim at N ragged against the 64-row tiles (bf16 runs on the
    # tensor cores, whose k-depth 16 pads M = 8)
    for M in (8, 16, 32, 64, 128):
        for N in (1, 63, 64, 65):
            full_case(f"M {M} N {N}{' biased' if N % 2 else ''}", 3, N, 2 * M, 2, N % 2 == 1)
    # ViL-Small 1024² stage 3: the q-tiled tiers' length (B3t, B4b)
    full_case("N 4097", 1, 4097, 384, 6, False, timed=True)
    # the fused configuration's block pre-norms, per training step: the image
    # rows and global rows of the chunked stages' 3 blocks (attention and
    # MLP norms), then the 9 dense blocks' tokens
    for rows, C, per_step in LN_STEP:
        ln_case(rows, C, per_step)
    # and at C 100 and 1000 (C % 8 != 0: no 16-byte vectors) at 1 and 3000 rows
    for rows, C in ((1, 100), (3000, 100), (1, 1000), (3000, 1000)):
        ln_case(rows, C)
    # and its fused blocks: stage 1 (1 block), stage 2 (2 blocks)
    block_case("stage1 (64,8,8,49,96) H3", 64, 56, 56, 7, 96, 3, 1, False, per_step=1)
    block_case("stage2 (64,4,4,49,192) H3", 64, 28, 28, 7, 192, 3, 1, False, per_step=2)
    block_case("biased, padded, cyclic 2x2 grid", 2, 13, 14, 7, 64, 2, 1, True)
    block_case("biased, padded 3x3 grid, nglo 0, C 48", 2, 19, 20, 7, 48, 3, 0, True)
    # a ragged last row tile (3 x 4 x 49 rows), two global rows, head dim 128;
    # C 320 (two blocks along the products' columns) on a cyclic 3x3 grid
    block_case("cyclic 2x2 grid, nglo 2, C 128 H1", 3, 14, 14, 7, 128, 1, 2, False)
    block_case("biased cyclic 3x3 grid, C 320 H5", 2, 21, 21, 7, 320, 5, 1, True)
    # q, k and v biases as large as the products, for B9a's bias epilogue: a
    # dropped bias reads about 1.5e-2 scaled at the model's 0.02, under the
    # limit, and far above it here. B9b is not held here: rounding dS to bf16
    # (as the TPU kernel does) leaves each query's dS row a small sum, which
    # the keys' common bias multiplies into dq, so dWq and dbq read about
    # twice their usual error, the TPU kernel's own too
    # (tests/test_torch_fused.py::test_vil_block_bf16_with_large_qkv_biases_
    # matches_pallas; PERF.md §6)
    block_case("stage1 width, biases as large as the products", 4, 56, 56, 7, 96, 3, 1, False,
               bias_scale=1.0, backward=False)
    # relative position bias (ViL-Small RPE): every biased kernel at the RPE
    # step's shapes, its bias assembled from tables drawn at σ 1 by the
    # model's own assembly (front order [g2l | local]; the dense one with g2g
    # and g2l), checked as above (dbias too) and timed per call with the bias
    from vil_tpu_torch.models.attention import full_rpe_bias, sliding_chunk_rpe_bias

    def tables(rows, H, nglo):
        """(local table, g2l, g2g) at σ 1."""
        return (randn(rows, H), randn(2, H, nglo) if nglo else None,
                randn(H, nglo, nglo) if nglo else None)

    full_case("RPE stage3 (64,197,384) H6, bias (6,197,197) from tables", 64, 197, 384, 6,
              True, timed=True, bias=full_rpe_bias(*tables(27 * 27, 6, 1), 14, 14))
    full_case("RPE stage4 (64,49,768) H12, bias (12,49,49) from tables", 64, 49, 768, 12,
              True, timed=True, bias=full_rpe_bias(*tables(13 * 13, 12, 0), 7, 7))
    for stage, mx, C in ((1, 8, 96), (2, 4, 192)):
        table, g2l, _ = tables(27 * 27, 3, 1)
        shape = f"stage{stage} (64,{mx},{mx},49,{C}) H3"
        chunk_case(f"RPE {shape}, bias (3,49,442) from tables", 64, 7 * mx, 7 * mx, 7, C, 3,
                   1, 0, True, timed=True, bias=sliding_chunk_rpe_bias(table, g2l, 7))
        block_case(f"RPE {shape}, bias (3,49,442) from tables", 64, 7 * mx, 7 * mx, 7, C, 3,
                   1, True, timed=True, bias=sliding_chunk_rpe_bias(table, g2l, 7))
        # every sampled neighbour at stage 2, modes 1 and 6 at stage 1
        for mode in range(1, 9) if stage == 2 else (1, 6):
            chunk_case(f"RPE mode {mode} {shape}, bias (3,49,99) from tables, front order",
                       64, 7 * mx, 7 * mx, 7, C, 3, 1, 0, True, mode, timed=mode in (1, 6),
                       bias=sliding_chunk_rpe_bias(table, g2l, 7, mode))
    table, g2l, _ = tables(27 * 27, 3, 1)
    halo_case("RPE stage1 (64,8,8,49,96) H3, bias (3,49,442) from tables", 64, 56, 56, 7, 96,
              3, 1, 0, True, (2,), bias=sliding_chunk_rpe_bias(table, g2l, 7), timed=True)
    # the card's time of B5, B9a, B9b, B8a and B8b per step beside their
    # event time, B9a's, B9b's and B8b's by part
    from vil_tpu_torch.tools.profile_step import family

    for name, t in card_times(torch, family).items():
        parts = ", ".join(f"{k} {v:.4f}" for k, v in sorted(t["parts"].items()))
        phase("kernels", f"{name} per step, bf16: event {t['event']:.4f} ms, the card's time "
                         f"{t['device']:.4f} ms ({parts})")
    # spatial parallelism: the halo-input kernels on every shard of stage 1
    # (1 block) and stage 2 (2 blocks) over 1, 2 and 4 ranks
    halo_case("stage1 (64,8,8,49,96) H3", 64, 56, 56, 7, 96, 3, 1, 0, False, (1, 2, 4),
              per_fwd=1, per_bwd=1)
    halo_case("stage2 (64,4,4,49,192) H3", 64, 28, 28, 7, 192, 3, 1, 0, False, (1, 2, 4),
              per_fwd=2)
    halo_case("biased, padded 3x3 grid, nglo 2", 2, 19, 20, 7, 64, 2, 2, 0, True, (1, 3))
    halo_case("cyclic 1x2 grid", 2, 7, 14, 7, 32, 1, 1, 0, False, (1,))
    # a mask row per query pixel (Wq = W², read per element), and W² = 16,
    # whose 145 columns leave the last 64-key tile ragged
    halo_case("SW_EXACT 1, nglo 0, biased", 2, 26, 20, 7, 64, 2, 0, 1, True, (1, 2))
    halo_case("SW_EXACT -1, W 4", 3, 14, 15, 4, 48, 3, 1, -1, False, (1, 2))
    # the tensor-core B7a copies rows 16 bytes at a time: a bf16 operand
    # off a 16-byte boundary must raise, not be read wrongly
    q = randn(2, 2, 2, 49, 64).to(torch.bfloat16)
    q_off = torch.empty(q.numel() + 1, dtype=q.dtype, device=dev)[1:].view(q.shape)
    q_off.copy_(q)
    kv_ext = [randn(2, 4, 2, 49, 64).to(torch.bfloat16) for _ in range(2)]
    glo = [randn(2, 1, 64).to(torch.bfloat16) for _ in range(2)]
    try:
        vil_attention_halo_fwd(q_off, *kv_ext, *glo, None,
                               torch.zeros(2, 2, 1, 1 + 9 * 49, device=dev), 2)
    except ValueError as e:
        phase("kernels", f"vil_attention_halo bf16 q 2 bytes off a 16-byte boundary: raises "
                         f"ValueError ({e})")
    else:
        raise AssertionError("a misaligned bf16 halo forward did not raise")
    probe_case()
    # high resolution (part highres), each timed per call, last so that the
    # cases above draw what they drew before these were added: ViL-Medium-Deep
    # 384² (14x14 chunks pad 2, 7x7 pad 1; N 577, 144), ViL-Small 1024²
    # (37x37 pad 3, 19x19 pad 5; N 4097, 1024), the _384 windows: W 6 (36
    # rows), W 8 (64) and W 12 (144 rows in three 64-row slices, the last
    # holding 16; 1297 columns)
    chunk_case("384^2 stage1 (64,14,14,49,96) H3, pad 2", 64, 96, 96, 7, 96, 3, 1, 0, False,
               timed=True)
    chunk_case("1024^2 stage1 (1,37,37,49,96) H3, pad 3", 1, 256, 256, 7, 96, 3, 1, 0, False,
               timed=True)
    chunk_case("1024^2 stage2 (8,19,19,49,192) H3, pad 5", 8, 128, 128, 7, 192, 3, 1, 0, False,
               timed=True)
    chunk_case("W 6 (32,16,16,36,96) H3", 32, 96, 96, 6, 96, 3, 1, 0, False, timed=True)
    chunk_case("W 8 (32,12,12,64,192) H3", 32, 96, 96, 8, 192, 3, 1, 0, False, timed=True)
    chunk_case("W 12 (32,4,4,144,384) H6", 32, 48, 48, 12, 384, 6, 1, 0, False, timed=True)
    # W 12 biased on a padded 3x3 grid: the last slice's 16 rows in dbias
    chunk_case("W 12 biased, padded 3x3 grid, nglo 2", 2, 26, 30, 12, 64, 2, 2, 0, True)
    chunk_case("mode 4 W 12 biased, padded 3x3 grid", 2, 26, 30, 12, 64, 2, 1, 0, True, 4)
    for mode in (1, 6):
        chunk_case(f"mode {mode} 1024^2 stage1 (1,37,37,49,96) H3, pad 3", 1, 256, 256, 7, 96,
                   3, 1, 0, False, mode, timed=True)
        chunk_case(f"mode {mode} W 12 (32,4,4,144,384) H6", 32, 48, 48, 12, 384, 6, 1, 0,
                   False, mode, timed=True)
    full_case("384^2 stage3 (64,577,384) H6", 64, 577, 384, 6, False, timed=True)
    full_case("384^2 stage3 (32,577,512) H8", 32, 577, 512, 8, False, timed=True)
    full_case("1024^2 stage3 (8,4097,384) H6", 8, 4097, 384, 6, False, timed=True)
    full_case("1024^2 stage4 (8,1024,768) H12", 8, 1024, 768, 12, False, timed=True)
    full_case("384^2 stage4 (64,144,768) H12", 64, 144, 768, 12, False, timed=True)
    block_case("W 12 (32,4,4,144,384) H6", 32, 48, 48, 12, 384, 6, 1, False, timed=True)
    block_case("W 8 (32,12,12,64,192) H3", 32, 96, 96, 8, 192, 3, 1, False, timed=True)


def launch_counts(kernels) -> dict:
    return {fn.__name__: fn.launches for fn in kernels}


def draw_tables(torch, model, std: float, seed: int = 7) -> None:
    """Every relative-position table of ``model`` drawn at σ ``std`` (0: all
    zero) from a CPU generator, so one seed gives the same tables on any
    device and in any dtype."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if "relative_position" in name:
                p.copy_(torch.randn(p.shape, generator=gen) * std)


def run_serve(torch, kernels, fused=False, rpe=False):
    """Phase 4 (with ``fused`` phase 7, with ``rpe`` phase 11): the inference
    path of ViL-Small 224² (with ``rpe`` ViL-Small RPE, served from
    ``precompute_rpe_cache``)."""
    from vil_tpu_torch.models import precompute_rpe_cache
    from vil_tpu_torch.train import recipe

    name = "serve_fused" if fused else "serve_rpe" if rpe else "serve"
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    images = [torch.randint(0, 256, (BATCH, 224, 224, 3), generator=gen, device=dev,
                            dtype=torch.uint8) for _ in range(REQUESTS)]
    model = recipe.vil_small(torch.bfloat16, torch.bfloat16, device=dev, fused=fused,
                             rpe=rpe).eval()
    if rpe:
        precompute_rpe_cache(model)
    for fn in kernels:
        fn.launches = 0
    secs = []
    with torch.inference_mode():
        for x in images:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits = model(x)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            if logits.shape != (BATCH, 1000) or not torch.isfinite(logits).all():
                raise AssertionError(f"bad logits {tuple(logits.shape)}")
    launches = launch_counts(kernels)
    per_forward = ({"vil_block_fwd": 3, "layer_norm_fwd": 30} if fused else
                   {"vil_attention_fwd": 3})
    want = {fn.__name__: 0 for fn in kernels}
    want.update({k: n * REQUESTS for k, n in per_forward.items()},
                full_attention_fwd=9 * REQUESTS)
    what = "ViL-Small RPE 224^2 bf16, biases from precompute_rpe_cache," if rpe else \
        "ViL-Small 224^2 bf16"
    phase(name, f"{what} batch {BATCH}: {REQUESTS} requests, "
                f"launches {launches} (want {want})")
    if launches != want:
        raise AssertionError(f"launch counts {launches} != {want}")
    img_s = BATCH / statistics.median(secs[1:])
    phase(name, f"bf16 forward: median {statistics.median(secs[1:]) * 1e3:.3f} ms "
                f"per batch, {img_s:.1f} img/s (requests 2..{REQUESTS}); first "
                f"request {secs[0] * 1e3:.1f} ms")
    if rpe:
        # the cache serves what the tables give: the same bits as a model
        # that assembles its biases in every forward, same weights
        with torch.inference_mode():
            cached = model(images[0])
            uncached = recipe.vil_small(torch.bfloat16, torch.bfloat16, device=dev,
                                        rpe=True).eval()(images[0])
        same = torch.equal(cached, uncached)
        phase(name, f"bf16 logits with precompute_rpe_cache vs assembled in the forward: "
                    f"bitwise equal {same}")
        if not same:
            raise AssertionError("the cached biases give other logits than the assembled")
    del model

    # f32 logits: kernels vs plain versions; in the fused configuration also
    # against the classic configuration's kernels, from the same weights
    x = images[0]
    outs = {}
    with torch.inference_mode():
        for key, use_kernels, f in (("kernels", True, fused), ("plain", False, fused),
                                    ("classic", True, False)):
            if key == "classic" and not fused:
                continue
            m = recipe.vil_small(torch.float32, torch.float32, use_kernels, dev, fused=f,
                                 rpe=rpe).eval()
            outs[key] = m(x)
            del m
    for other in [k for k in ("plain", "classic") if k in outs]:
        err = (outs["kernels"] - outs[other]).abs().max().item()
        what = ("kernels vs plain versions" if other == "plain" else
                "fused vs classic configuration (both with the kernels)")
        phase(name, f"f32 logits, {what}: max|err| {err:.3e} (tol {LOGITS_TOL:g}); "
                    f"|logits| max {outs[other].abs().max().item():.3f}")
        if not (torch.isfinite(outs["kernels"]).all() and err <= LOGITS_TOL):
            raise AssertionError(f"f32 logits disagree ({what}): {err}")
    if rpe:
        check_big_tables(torch, name, lambda use_kernels: recipe.vil_small(
            torch.float32, torch.float32, use_kernels, dev, rpe=True).eval(), x)
    if not fused:
        # the path's own types: bf16 logits, kernels (the dense ones on the
        # tensor cores) vs plain versions, same weights; bf16's own error,
        # plain bf16 vs plain f32, printed beside it as its scale
        with torch.inference_mode():
            for key, use_kernels in (("bf16 kernels", True), ("bf16 plain", False)):
                m = recipe.vil_small(torch.bfloat16, torch.bfloat16, use_kernels, dev,
                                     rpe=rpe).eval()
                outs[key] = m(x).float()
                del m
        scaled = lambda a, b: ((outs[a] - outs[b]).abs().max() / outs[b].abs().max()).item()
        err, own = scaled("bf16 kernels", "bf16 plain"), scaled("bf16 plain", "plain")
        phase(name, f"bf16 logits, kernels vs plain versions: max|err| / max|ref| {err:.3e} "
                    f"(tol {BF16_LOGITS_TOL:g}); plain bf16 vs plain f32 {own:.3e}")
        if not (torch.isfinite(outs["bf16 kernels"]).all() and err <= BF16_LOGITS_TOL):
            raise AssertionError(f"bf16 logits disagree: {err}")
    return launches


def check_big_tables(torch, name, build, x, forward=None):
    """The RPE paths' f32 logits check with every table drawn at σ 1, where
    the bias moves the scores as much as q·k does: ``build(use_kernels)``
    makes the model, ``forward(model, x)`` (default: ``model(x)``) serves
    it. Kernels vs plain versions to LOGITS_TOL and to RPE_SHARE_TOL of the
    logits' max|Δ| between these tables and zero tables: what a dropped bias
    would move them by."""
    forward = forward or (lambda m, x: m(x))
    outs = {}
    with torch.inference_mode():
        for key, use_kernels, std in (("kernels", True, 1.0), ("plain", False, 1.0),
                                      ("zero tables", True, 0.0)):
            m = build(use_kernels)
            draw_tables(torch, m, std)
            outs[key] = forward(m, x)
            del m
    err = (outs["kernels"] - outs["plain"]).abs().max().item()
    moved = (outs["plain"] - outs["zero tables"]).abs().max().item()
    tol = min(LOGITS_TOL, RPE_SHARE_TOL * moved)
    phase(name, f"f32 logits, tables at σ 1, kernels vs plain versions: max|err| {err:.3e} "
                f"(tol {tol:.3e}: {RPE_SHARE_TOL:g} of the {moved:.3e} that zero tables move "
                f"them by; |logits| max {outs['plain'].abs().max().item():.3f})")
    if not (torch.isfinite(outs["kernels"]).all() and err <= tol):
        raise AssertionError(f"f32 logits with σ-1 tables disagree: {err} > {tol}")


def f32_grad_errors(grads_k: dict, grads_p: dict) -> tuple[float, str, float]:
    """max|err| / max|ref| of each parameter's gradient, kernels (``grads_k``)
    against plain versions (``grads_p``): (the largest, its parameter, the
    largest over the relative-position tables)."""
    grad_err, worst, table_err = 0.0, "", 0.0
    for param, ref in grads_p.items():
        if ref.numel() == 0:  # the (1, 0, C) position table of a stage without globals
            continue
        err = ((grads_k[param] - ref).abs().max() / ref.abs().max().clamp(min=1e-30)).item()
        if "relative_position" in param:
            table_err = max(table_err, err)
        if not math.isfinite(err) or err > grad_err:
            grad_err, worst = err, param
    return grad_err, worst, table_err


def bf16_grad_blocks(grads: dict):
    """Each parameter's gradient; the q, k and v rows of a fused
    projection's weight each on its own, where dq and dk, which
    near-uniform attention keeps small, would be lost in dv's norm. A
    block's relative-position tables go as one vector: the g2g and g2l
    gradients are a few sums per head over the batch of dS terms that cancel
    (a softmax row's dS sums to 0), whose bf16 rounding alone moves them by
    3.4e-2 of their norm (plain bf16 vs plain f32, PR 12); the f32 step
    holds each table alone."""
    import torch

    tables = {}
    for n, t in grads.items():
        if "relative_position" in n:
            tables.setdefault(n.rsplit(".", 1)[0], []).append(t.flatten())
            continue
        parts = 3 if n.endswith("qkv.weight") else 2 if n.endswith("kv.weight") else 1
        names = ("q", "k", "v")[3 - parts:] if parts > 1 else ("",)
        for part, rows in zip(names, t.chunk(parts)):
            yield n + (f"[{part}]" if part else ""), rows
    for block, parts in tables.items():
        yield block + ".[relative-position tables]", torch.cat(parts)


def bf16_grad_worst(grads: dict, refs: dict) -> tuple[float, str]:
    """The largest ‖err‖ / ‖ref‖ over ``bf16_grad_blocks``, and its block."""
    grads = dict(bf16_grad_blocks(grads))
    errs = {n: ((grads[n] - r).norm() / r.norm()).item()
            for n, r in bf16_grad_blocks(refs) if r.norm() > 0}
    name = max(errs, key=lambda n: (not math.isfinite(errs[n]), errs[n]))
    return errs[name], name


def run_train(torch, kernels, random_shift=False, fused=False, rpe=False):
    """Phase 5 (with ``random_shift`` phase 6, with ``fused`` phase 8, with
    ``rpe`` phase 12): the training step of ViL-Small 224² at batch 64 (with
    ``rpe`` ViL-Small RPE). With ``rpe`` and ``random_shift`` or ``fused``
    (phases 13, 14) the path is the f32 kernels-vs-plain step pair alone,
    its launches counted over the kernels' steps."""
    from vil_tpu_torch.train import engine, recipe

    if rpe:
        name = "shift_rpe" if random_shift else "train_fused_rpe" if fused else "train_rpe"
    else:
        name = "train_shift" if random_shift else "train_fused" if fused else "train"
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2)
    images = torch.randn(BATCH, 224, 224, 3, generator=gen, device=dev)
    labels = torch.randint(0, 1000, (BATCH,), generator=gen, device=dev)
    per_step = {fn.__name__: 0 for fn in kernels}
    per_step.update(full_attention_fwd=9, full_attention_bwd=9)
    if fused:
        per_step.update(vil_block_fwd=3, vil_block_bwd=3, layer_norm_fwd=30, layer_norm_bwd=30)
    else:
        chunk = "vil_mode_attention" if random_shift else "vil_attention"
        per_step.update({f"{chunk}_fwd": 3, f"{chunk}_bwd": 3})
    steps_run = not (rpe and (random_shift or fused))
    if steps_run:
        model = recipe.vil_small(torch.bfloat16, torch.float32, device=dev, fused=fused, rpe=rpe)
        step = recipe.train_step(model, dev, random_shift)
        step_gen = torch.Generator(device=dev).manual_seed(3)
        for fn in kernels:
            fn.launches = 0
        secs, losses, modes = [], [], []
        torch.cuda.reset_peak_memory_stats()
        for i in range(STEPS):
            before = launch_counts(kernels)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            metrics = step(images, labels, step_gen)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            losses.append(metrics["loss"].item())
            modes.append(metrics.get("modes"))
            rose = {k: v - before[k] for k, v in launch_counts(kernels).items()}
            if rose != per_step:
                raise AssertionError(f"step {i}: launches rose by {rose}, want {per_step}")
        launches = launch_counts(kernels)
        what = "ViL-Small RPE 224^2" if rpe else "ViL-Small 224^2"
        phase(name, f"{what} bf16 compute, f32 parameters, batch {BATCH}: {STEPS} "
                    f"steps, launches {launches} ({per_step} per step)")
        if random_shift:
            phase(name, "per-block modes drawn by the step (12 blocks; the 9 dense blocks "
                        f"ignore theirs): {modes}")
        if not all(math.isfinite(v) for v in losses):
            raise AssertionError(f"losses not finite: {losses}")
        med = statistics.median(secs[1:])
        phase(name, f"step: median {med * 1e3:.3f} ms, {BATCH / med:.1f} img/s "
                    f"(steps 2..{STEPS}); first step {secs[0] * 1e3:.1f} ms; losses "
                    f"{', '.join(f'{v:.4f}' for v in losses)}; peak memory "
                    f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        del model, step
    else:
        # the recipe's first draw of per-block modes (its mode generator,
        # seed 0): the step the six-step run would take first
        modes = [engine.sample_vil_modes(torch.Generator().manual_seed(0), 12)
                 if random_shift else None]
        if random_shift:
            phase(name, f"per-block modes (12 blocks; the 9 dense blocks ignore theirs): "
                        f"{modes[0]}")
        for fn in kernels:
            fn.launches = 0

    def one_step(dtype, use_kernels, std=None):
        """One step from the recipe's weights (with ``std`` every table
        drawn at σ ``std``), the same images, draws and (random shift) the
        first step's modes: (loss, parameter gradients)."""
        m = recipe.vil_small(dtype, torch.float32, use_kernels, dev, fused=fused, rpe=rpe)
        if std is not None:
            draw_tables(torch, m, std)
        s = recipe.train_step(m, dev, random_shift)
        loss = s(images, labels, torch.Generator(device=dev).manual_seed(3),
                 modes=modes[0])["loss"].item()
        return loss, {n: p.grad.clone() for n, p in m.named_parameters()}

    # one f32 step, kernels vs plain versions; with RPE also with every
    # table at σ 1, where the bias moves the scores as much as q·k does
    for std in (None, 1.0) if rpe else (None,):
        (loss_k, grads_k), (loss_p, grads_p) = one_step(torch.float32, True, std), one_step(
            torch.float32, False, std)
        loss_err = abs(loss_k - loss_p)
        grad_err, worst, table_err = f32_grad_errors(grads_k, grads_p)
        tables = (f"; the {sum('relative_position' in n for n in grads_p)} tables' max rel "
                  f"err {table_err:.3e}" if rpe else "")
        what = "f32 step" + (", tables at σ 1" if std else "")
        phase(name, f"{what}, kernels vs plain versions: loss {loss_k:.6f} vs {loss_p:.6f} "
                    f"(|err| {loss_err:.3e}, tol {LOSS_TOL:g}); parameter gradients max "
                    f"rel err {grad_err:.3e} at {worst} (tol {PARAM_GRAD_TOL:g}){tables}")
        if not (loss_err <= LOSS_TOL and grad_err <= PARAM_GRAD_TOL):
            raise AssertionError(f"{what} disagrees: loss {loss_err}, gradients {grad_err}")
        if std is None:
            grads_f32 = grads_p  # the recipe's tables: bf16's scale below
    if not steps_run:
        launches = launch_counts(kernels)
        want = {k: 2 * n for k, n in per_step.items()}  # two kernel steps
        phase(name, f"launches over the two f32 kernel steps {launches} (want {want})")
        if launches != want:
            raise AssertionError(f"launch counts {launches} != {want}")
    if not (random_shift or fused):
        # the path's own types: one bf16-compute step, kernels (the dense
        # backward on the tensor cores) vs plain versions; bf16's own error,
        # plain bf16 vs plain f32, printed beside it as its scale
        (bf_loss_k, bf_k), (bf_loss_p, bf_p) = one_step(torch.bfloat16, True), one_step(
            torch.bfloat16, False)
        (err, at), (own, own_at) = bf16_grad_worst(bf_k, bf_p), bf16_grad_worst(bf_p, grads_f32)
        alone = ""
        if rpe:  # each table alone, printed: what joining them leaves out

            def table_worst(grads, refs):
                return max(((grads[n] - r).norm() / r.norm()).item()
                           for n, r in refs.items() if "relative_position" in n and r.norm() > 0)

            alone = (f"; each table alone (printed, not held) {table_worst(bf_k, bf_p):.3e}, "
                     f"plain bf16 vs plain f32 {table_worst(bf_p, grads_f32):.3e}")
        phase(name, f"bf16 step, kernels vs plain versions: loss {bf_loss_k:.6f} vs "
                    f"{bf_loss_p:.6f}; parameter gradients max ‖err‖ / ‖ref‖ {err:.3e} at {at} "
                    f"(tol {BF16_PARAM_GRAD_TOL:g}); plain bf16 vs plain f32 {own:.3e} at "
                    f"{own_at}{alone}")
        if not (math.isfinite(bf_loss_k) and err <= BF16_PARAM_GRAD_TOL):
            raise AssertionError(f"bf16 step disagrees: gradients {err} at {at}")
    return launches


def run_serve_spatial(torch, kernels):
    """Phase 9: spatial (chunk-row) parallelism of ViL-Small 224² on a
    process group of one card, through ``parallel.spatial_forward``, and
    one backward through the spatial kernel tier. Returns the launch counts
    of the two paths: the serving forwards, and the backward."""
    import torch.distributed as dist

    from vil_tpu_torch import parallel
    from vil_tpu_torch.ops import masks as masks_lib
    from vil_tpu_torch.ops.kernels import mask_to_additive
    from vil_tpu_torch.train import recipe

    name = "serve_spatial"
    dev = torch.device("cuda")
    store = os.path.join(REPO, "build", f"spatial_store.{os.getpid()}")
    os.makedirs(os.path.dirname(store), exist_ok=True)
    parallel.init_process_group(store, 0, 1, backend="nccl")
    try:
        gen = torch.Generator(device=dev).manual_seed(1)
        images = [torch.randint(0, 256, (BATCH, 224, 224, 3), generator=gen, device=dev,
                                dtype=torch.uint8) for _ in range(REQUESTS)]
        model = recipe.vil_small(torch.bfloat16, torch.bfloat16, device=dev).eval()
        forward = lambda m, x: parallel.spatial_forward(m, parallel.shard_image(x))

        def timed(fn):
            secs = []
            with torch.inference_mode():
                for x in images:
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    logits = fn(x)
                    torch.cuda.synchronize()
                    secs.append(time.perf_counter() - t0)
                    if logits.shape != (BATCH, 1000) or not torch.isfinite(logits).all():
                        raise AssertionError(f"bad logits {tuple(logits.shape)}")
            return secs

        # the classic forward first, same weights and images, outside the
        # path's launch counts
        classic = timed(model)
        for fn in kernels:
            fn.launches = 0
        secs = timed(lambda x: forward(model, x))
        launches = launch_counts(kernels)
        want = {fn.__name__: 0 for fn in kernels}
        want.update(vil_attention_halo_fwd=3 * REQUESTS, full_attention_fwd=9 * REQUESTS)
        phase(name, f"ViL-Small 224^2 bf16 batch {BATCH} on a group of "
                    f"{parallel.get_world_size()} ({dist.get_backend()}): {REQUESTS} requests, "
                    f"launches {launches} (want {want})")
        if launches != want:
            raise AssertionError(f"launch counts {launches} != {want}")
        med, med_c = statistics.median(secs[1:]), statistics.median(classic[1:])
        phase(name, f"bf16 spatial forward: median {med * 1e3:.3f} ms per batch, "
                    f"{BATCH / med:.1f} img/s (requests 2..{REQUESTS}); first request "
                    f"{secs[0] * 1e3:.1f} ms; classic forward in the same phase "
                    f"{med_c * 1e3:.3f} ms, {BATCH / med_c:.1f} img/s")
        del model

        # the spatial_bwd path: one backward through the kernel tier at
        # stage 1's shape, B7b inside the halo exchange's adjoint, against
        # the plain spatial tier
        mask = torch.from_numpy(mask_to_additive(
            masks_lib.invalid_mask(8, 8, 0, 0, 7, 0, 0), 8, 8, 49, 1)).to(dev)
        shapes = [(BATCH, 8, 8, 49, 96)] * 3 + [(BATCH, 1, 96)] * 2
        ops = [torch.randn(*s, generator=gen, device=dev) * 96 ** -0.25 for s in shapes]
        g_out = torch.randn(*shapes[0], generator=gen, device=dev)
        route = type(parallel.halo_rows(ops[1].requires_grad_())[0].grad_fn).__name__
        if route != "_HaloExchangeBackward":
            raise AssertionError(f"the halos bypass the exchange: grad_fn {route}")
        grads = {}
        for fn in kernels:
            fn.launches = 0
        for tier, fn in (("kernels", parallel.spatial_local_attention_kernel),
                         ("plain", parallel.spatial_local_attention)):
            dtype = torch.bfloat16 if tier == "kernels" else torch.float32
            leaves = [t.detach().to(dtype).requires_grad_() for t in ops]
            fn(*leaves, None, mask, 3).backward(g_out.to(dtype))
            grads[tier] = [t.grad.float() for t in leaves]
        launches_bwd = launch_counts(kernels)
        want = {fn.__name__: 0 for fn in kernels}
        want.update(vil_attention_halo_fwd=1, vil_attention_halo_bwd=1)
        phase(name, f"spatial_bwd: halos through {route} over {dist.get_backend()}; launches "
                    f"{launches_bwd} (want {want})")
        if launches_bwd != want:
            raise AssertionError(f"spatial backward launch counts {launches_bwd} != {want}")
        errs = [(k - p).abs().max().item() / max(1.0, p.abs().max().item())
                for k, p in zip(grads["kernels"], grads["plain"])]
        phase(name, f"spatial_bwd: backward through spatial_local_attention_kernel, stage 1 "
                    f"({BATCH},8,8,49,96) bf16: dq, dk, dv, dk_glo, dv_glo rel err vs the plain "
                    f"spatial tier in f32 {max(errs):.3e} (tol {GRAD_TOL['bfloat16']:g})")
        if not max(errs) <= GRAD_TOL["bfloat16"]:
            raise AssertionError(f"spatial backward disagrees: {errs}")

        # f32 logits: spatial vs classic (kernels), spatial kernels vs plain
        x, outs = images[0], {}
        with torch.inference_mode():
            for use_kernels in (True, False):
                m = recipe.vil_small(torch.float32, torch.float32, use_kernels, dev).eval()
                outs[use_kernels] = forward(m, x)
                if use_kernels:
                    outs["classic"] = m(x)
                del m
        for other, what in ((False, "spatial kernels vs spatial plain versions"),
                            ("classic", "spatial vs classic forward (both with the kernels)")):
            err = (outs[True] - outs[other]).abs().max().item()
            phase(name, f"f32 logits, {what}: max|err| {err:.3e} (tol {LOGITS_TOL:g}); "
                        f"|logits| max {outs[other].abs().max().item():.3f}")
            if not (torch.isfinite(outs[True]).all() and err <= LOGITS_TOL):
                raise AssertionError(f"f32 logits disagree ({what}): {err}")
        # the same on ViL-Small RPE with its tables at σ 1: the bias through
        # the halo kernels, g2g and g2l[0] through the spread global branch
        with torch.inference_mode():
            m = recipe.vil_small(torch.float32, torch.float32, True, dev, rpe=True).eval()
            draw_tables(torch, m, 1.0)
            spatial_rpe, classic_rpe = forward(m, x), m(x)
            del m
        err = (spatial_rpe - classic_rpe).abs().max().item()
        phase(name, f"f32 logits, ViL-Small RPE (tables at σ 1), spatial vs classic forward "
                    f"(both with the kernels): max|err| {err:.3e} (tol {LOGITS_TOL:g}); "
                    f"|logits| max {classic_rpe.abs().max().item():.3f}")
        if not (torch.isfinite(spatial_rpe).all() and err <= LOGITS_TOL):
            raise AssertionError(f"f32 RPE logits disagree (spatial vs classic): {err}")
        check_big_tables(torch, name, lambda use_kernels: recipe.vil_small(
            torch.float32, torch.float32, use_kernels, dev, rpe=True).eval(), x, forward)
    finally:
        dist.destroy_process_group()
        if os.path.exists(store):
            os.remove(store)
    return launches, launches_bwd


def run_probe(torch, kernels):
    """Phase 10: the layout probe tool, once: P between two GEMMs in both
    schemes, its census of copy ops and its time per pass."""
    from vil_tpu_torch.tools import layout_probe

    for fn in kernels:
        fn.launches = 0
    results = layout_probe.run()
    launches = launch_counts(kernels)
    for scheme, res in results.items():
        copies = ", ".join(f"{k} {v:g}" for k, v in res["copies"].items())
        phase("probe", f"[{scheme}] ({layout_probe.B}, {layout_probe.MX}, {layout_probe.MY}, "
                       f"{layout_probe.W2}, {layout_probe.C}) bf16, GEMM -> P -> GEMM: copy ops "
                       f"per pass {copies}; {res['ms']:.4f} ms per pass")
    phase("probe", f"launches {launches}")
    others = [n for n, v in launches.items() if v and n not in ("consume_base", "consume_perm")]
    if not (launches["consume_base"] and launches["consume_perm"]) or others:
        raise AssertionError(f"probe launches {launches}")
    return launches


EXPERIMENT_DIR = os.path.join(REPO, "build", "chip_experiment")
# the CLI's arguments: configs/msvit.yaml's recipe on the synthetic set, the
# batch cut to 64, two epochs, random shift for the first
EXPERIMENT_ARGS = ["--config-file", os.path.join(REPO, "configs", "msvit.yaml"),
                   "--output_dir", EXPERIMENT_DIR, "--seed", "0",
                   "DATA.TRAIN", "('synthetic',)", "DATA.TEST", "('synthetic',)",
                   "DATALOADER.BSZ", str(BATCH), "OPTIM.EPOCHS", "2", "MODEL.VIT.MSVIT.MODE", "1",
                   "MODEL.VIT.MSVIT.VIL_MODE_SWITCH", "0.5", "LOG_FREQ", "1"]


def block_counts(model) -> tuple[int, int]:
    """(sliding-chunk blocks, dense blocks) of an MsViT: the launches of B1
    (B2; B5, B6) and of B3 (B4) per forward (per step)."""
    from vil_tpu_torch.models.attention import FullAttention, VilAttention

    return (sum(isinstance(m, VilAttention) for m in model.modules()),
            sum(isinstance(m, FullAttention) for m in model.modules()))


def experiment_want(trainer, kernels) -> tuple[dict, str]:
    """The launches a run of the CLI must have made, from the trainer's own
    counts and its model's blocks (ViL-Small: 3 sliding-chunk, 9 dense): per
    random-shift step B5, B6 one per sliding-chunk block and B3, B4 one per
    dense block; per MODE-0 step B1, B2 and B3, B4 the same; per eval batch
    (the best checkpoint's eval included) B1 and B3; none with the plain
    versions."""
    want = {fn.__name__: 0 for fn in kernels}
    shift, mode0, ev = trainer.steps_run[True], trainer.steps_run[False], trainer.eval_batches
    formula = (f"{shift} random-shift steps, {mode0} MODE-0 steps, {ev} eval batches "
               f"(best-checkpoint eval {'ran' if trainer.best_evaluated else 'did not run'})")
    if not trainer.cfg.TPU.USE_PALLAS:
        return want, formula + ", plain versions"
    chunk, dense = block_counts(trainer.model)
    want.update(vil_mode_attention_fwd=chunk * shift, vil_mode_attention_bwd=chunk * shift,
                vil_attention_fwd=chunk * (mode0 + ev), vil_attention_bwd=chunk * mode0,
                full_attention_fwd=dense * (shift + mode0 + ev),
                full_attention_bwd=dense * (shift + mode0))
    return want, formula + f", {chunk} sliding-chunk and {dense} dense blocks"


def run_cli(torch, kernels, name: str, label: str, argv: list):
    """One in-process run of ``python -m vil_tpu_torch.run_experiment`` for
    the path ``name``: its wall, its launches held to the trainer's counts
    (``experiment_want``) and its losses finite. Returns the Trainer."""
    from vil_tpu_torch import run_experiment as cli

    before = launch_counts(kernels)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer = cli.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rose = {k: v - before[k] for k, v in launch_counts(kernels).items()}
    want, formula = experiment_want(trainer, kernels)
    shown = {k: v for k, v in rose.items() if v or want[k]}
    phase(name, f"{label}: {wall:.1f} s; launches {shown} (the rest 0); want "
                f"{ {k: want[k] for k in shown} } from {formula}")
    if rose != want:
        raise AssertionError(f"{label}: launches {rose} != {want}")
    losses = [r["loss"] for r in trainer.steps_log] + [e["loss"] for e in trainer.evals]
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"{label}: losses not finite: {losses}")
    return trainer


def run_experiment_path(torch, kernels):
    """Phase 15: the port's entry point, ``python -m vil_tpu_torch.run_experiment``,
    driven in-process through its ``main(argv)`` at ViL-Small's full width
    and depth: two epochs (random shift, then MODE 0), a resume to a third
    epoch, a reload of the last checkpoint under EVALUATE (bit for bit), and
    the same eval in f32 with the kernels and with the plain versions."""
    import shutil

    from vil_tpu_torch.tools.profile_step import kernel_ms
    from vil_tpu_torch.train import schedulers
    from vil_tpu_torch.train.trainer import Trainer

    name = "experiment"
    shutil.rmtree(EXPERIMENT_DIR, ignore_errors=True)
    for fn in kernels:
        fn.launches = 0

    run = lambda label, argv: run_cli(torch, kernels, name, label, argv)

    def epochs(trainer, label):
        for epoch in sorted({r["epoch"] for r in trainer.steps_log}):
            rows = [r for r in trainer.steps_log if r["epoch"] == epoch]
            batch = statistics.median(r["batch_time"] for r in rows[1:])
            data = statistics.median(r["data_time"] for r in rows[1:])
            mode = "random shift" if rows[0]["random_shift"] else "MODE 0"
            losses = ", ".join(f"{r['loss']:.4f}" for r in rows)
            phase(name, f"{label} epoch {epoch} ({mode}, {len(rows)} steps): median batch_time "
                        f"{batch * 1e3:.3f} ms, data_time {data * 1e3:.3f} ms (steps "
                        f"2..{len(rows)}), {BATCH / batch:.1f} img/s; losses {losses}")

    # 1. two epochs: random shift in epoch 0 (< 0.5 * 2), MODE 0 in epoch 1
    torch.cuda.reset_peak_memory_stats()
    first = run("two-epoch run", EXPERIMENT_ARGS)
    flags = [(r["epoch"], r["random_shift"]) for r in first.steps_log]
    if flags != [(0, True)] * 8 + [(1, False)] * 8 or first.eval_batches != 8 * 2 + 8:
        raise AssertionError(f"two-epoch run: (epoch, random shift) per step {flags}, "
                             f"{first.eval_batches} eval batches (want 8 x 3)")
    epochs(first, "two-epoch run")
    mode0_wall = statistics.median(r["batch_time"] for r in first.steps_log[9:])
    phase(name, f"two-epoch run evals: " + "; ".join(
        f"top1 {e['top1']:.4f} loss {e['loss']:.6f}" for e in first.evals)
        + f"; peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del first

    # 2. a resume to three epochs, its MODE-0 epoch under torch.profiler for
    # the card's busy share (the profiler's host work lengthens the wall, so
    # the share is a lower bound)
    profiled = {}
    train_epoch = Trainer.train_epoch

    def profiled_epoch(self, epoch, meters=None):
        torch.cuda.synchronize()
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            train_epoch(self, epoch, meters)
            torch.cuda.synchronize()
            profiled["wall"] = time.perf_counter() - t0
        profiled["device"] = sum(kernel_ms(prof).values()) / 1e3

    argv = EXPERIMENT_ARGS[:EXPERIMENT_ARGS.index("OPTIM.EPOCHS") + 1] + ["3"] + \
        EXPERIMENT_ARGS[EXPERIMENT_ARGS.index("OPTIM.EPOCHS") + 2:]
    Trainer.train_epoch = profiled_epoch
    try:
        resumed = run("resume to 3 epochs", argv)
    finally:
        Trainer.train_epoch = train_epoch
    log = resumed.steps_log
    want_lr = schedulers.get_lr_schedule(resumed.cfg)(16)
    phase(name, f"resume: start epoch {resumed.start_epoch}, first step {log[0]['step']}, its "
                f"LR {log[0]['lr']!r} (get_lr_schedule at step 16: {want_lr!r}); "
                f"{len(log)} steps, random shift {sorted({r['random_shift'] for r in log})}")
    if not (resumed.start_epoch == 2 and log[0]["step"] == 16 and log[0]["lr"] == want_lr
            and len(log) == 8 and not any(r["random_shift"] for r in log)):
        raise AssertionError("the resume did not start at epoch 2, step 16, at its LR, MODE 0")
    epochs(resumed, "resume (profiled)")
    steps = len(log)
    device = profiled["device"] / steps
    phase(name, f"resume epoch 2 under torch.profiler: wall {profiled['wall'] * 1e3 / steps:.3f} "
                f"ms per step, device {device * 1e3:.3f} ms per step, busy "
                f"{100 * device * steps / profiled['wall']:.1f}%; against the two-epoch run's "
                f"unprofiled MODE-0 median wall {mode0_wall * 1e3:.3f} ms: idle "
                f"{100 * (1 - device / mode0_wall):.1f}%")
    last = resumed.evals[0]  # after epoch 2, from checkpoint_3's weights
    for f in ("checkpoint_1.ckpt", "checkpoint_2.ckpt", "checkpoint_3.ckpt",
              "checkpoint_1.ckpt.json", "checkpoint_2.ckpt.json", "checkpoint_3.ckpt.json",
              "last_checkpoint", "config.yaml"):
        if not os.path.isfile(os.path.join(EXPERIMENT_DIR, f)):
            raise AssertionError(f"{f} missing from {EXPERIMENT_DIR}")
    del resumed

    # 3. the last checkpoint reloaded under EVALUATE: its eval bit for bit
    ckpt = os.path.join(EXPERIMENT_DIR, "checkpoint_3.ckpt")

    def evaluate(label, *opts):
        out = os.path.join(EXPERIMENT_DIR, label)
        argv = EXPERIMENT_ARGS + ["EVALUATE", "True", "MODEL.MODEL_PATH", ckpt, *opts]
        argv[argv.index("--output_dir") + 1] = out
        return run(f"EVALUATE {label}", argv).evals[-1]

    reload = evaluate("reload")
    phase(name, f"reload of checkpoint_3: top1 {reload['top1']!r} loss {reload['loss']!r}; the "
                f"run's eval after epoch 2 top1 {last['top1']!r} loss {last['loss']!r}")
    if (reload["top1"], reload["loss"]) != (last["top1"], last["loss"]):
        raise AssertionError("the reloaded checkpoint's eval differs from the run's")

    # 4. the same eval in f32, kernels vs plain versions
    f32_k = evaluate("f32_kernels", "TPU.COMPUTE_DTYPE", "float32", "TPU.USE_PALLAS", "True")
    f32_p = evaluate("f32_plain", "TPU.COMPUTE_DTYPE", "float32", "TPU.USE_PALLAS", "False")
    err = abs(f32_k["loss"] - f32_p["loss"])
    phase(name, f"f32 eval of checkpoint_3, kernels vs plain versions: loss {f32_k['loss']:.6f} "
                f"vs {f32_p['loss']:.6f} (|err| {err:.3e}, tol {LOSS_TOL:g}); top1 "
                f"{f32_k['top1']} vs {f32_p['top1']}")
    if not (err <= LOSS_TOL and f32_k["top1"] == f32_p["top1"]):
        raise AssertionError(f"f32 eval disagrees: loss {err}, top1 {f32_k['top1']} vs "
                             f"{f32_p['top1']}")
    return launch_counts(kernels)


def efficient_per_pass(variant: dict) -> tuple[dict, dict]:
    """The kernels of one forward and of one training step of a recipe
    variant: the dense stages 3-4 (9 blocks) through B3 (and B4), and with
    unshared global weights the sliding-chunk stages 1-2 (3 blocks) through
    B1 (and B2); the efficient families reach no kernel."""
    forward, step = {"full_attention_fwd": 9}, {"full_attention_fwd": 9, "full_attention_bwd": 9}
    if not variant.get("sharew", True):
        forward["vil_attention_fwd"] = 3
        step.update(vil_attention_fwd=3, vil_attention_bwd=3)
    return forward, step


def run_efficient(torch, kernels) -> dict:
    """The paper's other attention families on ViL-Small 224², 1000 classes,
    batch 64 (``recipe.VARIANTS``: linformer, srformer, performer, global,
    unshared), each a path with its own launch counts: a bf16 serving
    forward on uint8 images (``REQUESTS``), ``STEPS`` bf16 training steps of
    the recipe (AdamW, mixup, drop path 0.1), timed as the other paths are
    (the median of all but the first), then the f32 forward and step with
    the kernels and with the plain versions from the same weights; the
    launches of each part held exactly. Then the performer through the
    entry point (``run_efficient_experiment``). Returns {path: launches}."""
    from vil_tpu_torch.ops import flops
    from vil_tpu_torch.train import recipe

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    served = torch.randint(0, 256, (BATCH, 224, 224, 3), generator=gen, device=dev,
                           dtype=torch.uint8)
    images = torch.randn(BATCH, 224, 224, 3, generator=gen, device=dev)
    labels = torch.randint(0, 1000, (BATCH,), generator=gen, device=dev)
    paths = {}
    for name, variant in recipe.VARIANTS.items():
        t_path = time.perf_counter()
        per_fwd, per_step = efficient_per_pass(variant)
        cfg = recipe.vil_small_cfg(**variant).MODEL.VIT.MSVIT

        def want(**times):
            """Launches of ``times[part]`` passes of each part."""
            out = {fn.__name__: 0 for fn in kernels}
            for part, n in times.items():
                for k, v in (per_fwd if part == "fwd" else per_step).items():
                    out[k] += v * n
            return out

        def held(what, rose, expect):
            if rose != expect:
                raise AssertionError(f"{name} {what}: launches {rose} != {expect}")

        for fn in kernels:
            fn.launches = 0
        # serving: bf16 parameters and compute
        model = recipe.vil_small(torch.bfloat16, torch.bfloat16, device=dev, **variant).eval()
        n_params = sum(p.numel() for p in model.parameters())
        n_buffers = sum(b.numel() for b in model.buffers())
        macs = flops.model_macs(cfg.ARCH, 224, cfg.ATTN_TYPE, sharew=cfg.SHARE_W,
                                share_kv=cfg.SHARE_KV)
        secs = []
        with torch.inference_mode():
            for _ in range(REQUESTS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                logits = model(served)
                torch.cuda.synchronize()
                secs.append(time.perf_counter() - t0)
        if logits.shape != (BATCH, 1000) or not torch.isfinite(logits).all():
            raise AssertionError(f"{name}: bad serving logits {tuple(logits.shape)}")
        held("serving", launch_counts(kernels), want(fwd=REQUESTS))
        serve_ms = statistics.median(secs[1:]) * 1e3
        del model

        # training: f32 parameters under bf16 compute, the recipe's step
        before = launch_counts(kernels)
        model = recipe.vil_small(torch.bfloat16, torch.float32, device=dev, **variant)
        step = recipe.train_step(model, dev)
        step_gen = torch.Generator(device=dev).manual_seed(3)
        torch.cuda.reset_peak_memory_stats()
        secs, losses = [], []
        for _ in range(STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses.append(step(images, labels, step_gen)["loss"].item())
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        peak = torch.cuda.max_memory_allocated() / 2**30
        if not all(math.isfinite(v) for v in losses):
            raise AssertionError(f"{name}: losses not finite: {losses}")
        rose = {k: v - before[k] for k, v in launch_counts(kernels).items()}
        held("training", rose, want(step=STEPS))
        train_ms = statistics.median(secs[1:]) * 1e3
        del model, step
        phase("efficient", f"{name} (ATTN_TYPE {cfg.ATTN_TYPE}, ONLY_GLOBAL {cfg.ONLY_GLOBAL}, "
                           f"SHARE_W {cfg.SHARE_W}, SHARE_KV {cfg.SHARE_KV}; stage 1-2 f "
                           f"{cfg.ARCH.split('_')[0].rsplit(',f', 1)[1]}, "
                           f"{cfg.ARCH.split('_')[1].rsplit(',f', 1)[1]}): {n_params / 1e6:.2f} M "
                           f"parameters, {n_buffers} buffer values, {macs['gmacs']:.3f} GMACs an "
                           f"image (ops/flops.py); serve bf16 batch {BATCH}: median "
                           f"{serve_ms:.3f} ms ({BATCH / serve_ms * 1e3:.1f} img/s, requests "
                           f"2..{REQUESTS}); train step: median {train_ms:.3f} ms "
                           f"({BATCH / train_ms * 1e3:.1f} img/s, steps 2..{STEPS}), "
                           f"losses {', '.join(f'{v:.4f}' for v in losses)}, peak memory "
                           f"{peak:.2f} GiB; launches per forward {per_fwd}, per step {per_step}")

        # f32, kernels vs plain versions: the forward, then one step
        before = launch_counts(kernels)
        outs = {}
        for key, use_kernels in (("kernels", True), ("plain", False)):
            m = recipe.vil_small(torch.float32, torch.float32, use_kernels, dev, **variant)
            with torch.inference_mode():
                logits = m.eval()(served)
            s = recipe.train_step(m, dev)
            loss = s(images, labels, torch.Generator(device=dev).manual_seed(3))["loss"].item()
            outs[key] = logits, loss, {n: p.grad.clone() for n, p in m.named_parameters()}
            del m, s
        rose = {k: v - before[k] for k, v in launch_counts(kernels).items()}
        held("f32 pair", rose, want(fwd=1, step=1))
        (lk, loss_k, gk), (lp, loss_p, gp) = outs["kernels"], outs["plain"]
        logit_err = (lk - lp).abs().max().item()
        grad_err, worst, _ = f32_grad_errors(gk, gp)
        phase("efficient", f"{name} f32, kernels vs plain versions: logits max|err| "
                           f"{logit_err:.3e} (tol {LOGITS_TOL:g}); step loss {loss_k:.6f} vs "
                           f"{loss_p:.6f} (|err| {abs(loss_k - loss_p):.3e}, tol {LOSS_TOL:g}); "
                           f"parameter gradients max rel err {grad_err:.3e} at {worst} (tol "
                           f"{PARAM_GRAD_TOL:g}); the path {time.perf_counter() - t_path:.1f} s")
        if not (torch.isfinite(lk).all() and logit_err <= LOGITS_TOL
                and abs(loss_k - loss_p) <= LOSS_TOL and grad_err <= PARAM_GRAD_TOL):
            raise AssertionError(f"{name}: f32 kernels vs plain disagree: logits {logit_err}, "
                                 f"loss {abs(loss_k - loss_p)}, gradients {grad_err} at {worst}")
        paths[name] = launch_counts(kernels)
    paths["experiment_performer"] = run_efficient_experiment(torch, kernels)
    return paths


EFFICIENT_EXPERIMENT_DIR = os.path.join(REPO, "build", "chip_experiment_performer")


def run_efficient_experiment(torch, kernels) -> dict:
    """The performer through ``python -m vil_tpu_torch.run_experiment``'s
    ``main(argv)``: configs/msvit.yaml's recipe with ATTN_TYPE performer at
    ViL-Small's width and depth, batch 64, the synthetic set (8 steps an
    epoch), two epochs and then a resume to three. The projection buffers
    must change before exactly the steps that a ``RedrawSchedule`` names
    (counted afresh by each run, as in ``vil_tpu``) and before no other, the
    last redraw must be the draw keyed by (seed, step), the resumed run must
    load the checkpoint's buffers bit for bit and its schedule count afresh;
    launches B3 9 a step and an eval batch, B4 9 a step, no other."""
    import shutil

    from vil_tpu_torch import run_experiment as cli
    from vil_tpu_torch.models.attention_efficient import gaussian_orthogonal_random_matrix
    from vil_tpu_torch.train import engine, recipe
    from vil_tpu_torch.train.redraw import RedrawSchedule
    from vil_tpu_torch.train.trainer import Trainer

    name = "experiment_performer"
    shutil.rmtree(EFFICIENT_EXPERIMENT_DIR, ignore_errors=True)
    argv = list(EXPERIMENT_ARGS)
    argv[argv.index("--output_dir") + 1] = EFFICIENT_EXPERIMENT_DIR
    i = argv.index("MODEL.VIT.MSVIT.MODE")
    argv[i:i + 4] = ["MODEL.VIT.MSVIT.ATTN_TYPE", "performer", "MODEL.VIT.MSVIT.ARCH",
                     recipe.VARIANTS["performer"]["arch"]]
    watch = {"last": None, "changed": []}

    def projections(model):
        return {n: b.clone() for n, b in model.named_buffers() if n.endswith("projection_matrix")}

    init, call = Trainer.__init__, engine.TrainStep.__call__

    def watched_init(self, *args, **kwargs):
        init(self, *args, **kwargs)
        watch["last"] = watch["loaded"] = projections(self.model)

    def watched_call(self, *args, **kwargs):
        now = projections(self.model)
        if any(not torch.equal(b, watch["last"][n]) for n, b in now.items()):
            watch["changed"].append(self.step)
        watch["last"] = now
        return call(self, *args, **kwargs)

    def schedule(epochs, steps=8, start=0):
        sched, out, step = RedrawSchedule(), [], start
        for epoch in epochs:
            sched.set_epoch(epoch)
            for _ in range(steps):
                if sched.should_redraw():
                    out.append(step)
                step += 1
        return out, sched.calls_since_last

    for fn in kernels:
        fn.launches = 0
    Trainer.__init__, engine.TrainStep.__call__ = watched_init, watched_call
    try:
        for label, epochs, start in (("two-epoch run", 2, 0), ("resume to 3 epochs", 3, 16)):
            watch["changed"] = []
            before = launch_counts(kernels)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            trainer = cli.main(argv[:argv.index("OPTIM.EPOCHS") + 1] + [str(epochs)]
                               + argv[argv.index("OPTIM.EPOCHS") + 2:])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            rose = {k: v - before[k] for k, v in launch_counts(kernels).items()}
            steps, ev = sum(trainer.steps_run.values()), trainer.eval_batches
            expect = {fn.__name__: 0 for fn in kernels}
            expect.update(full_attention_fwd=9 * (steps + ev), full_attention_bwd=9 * steps)
            want_steps, want_count = schedule(range(trainer.start_epoch, epochs), start=start)
            rows = trainer.steps_log
            batch = statistics.median(r["batch_time"] for r in rows[1:]) * 1e3
            phase(name, f"{label}: {wall:.1f} s, start epoch {trainer.start_epoch}, {steps} "
                        f"steps, {ev} eval batches; median batch_time {batch:.3f} ms "
                        f"({BATCH / batch * 1e3:.1f} img/s); the projections changed before steps {watch['changed']}, the "
                        f"trainer redrew before {trainer.redraw_steps}, a fresh RedrawSchedule "
                        f"names {want_steps}; its count after the run "
                        f"{trainer.redraw_schedule.calls_since_last} (a fresh schedule's "
                        f"{want_count}); launches {({k: v for k, v in rose.items() if v})}")
            if not (watch["changed"] == trainer.redraw_steps == want_steps
                    and trainer.redraw_schedule.calls_since_last == want_count
                    and trainer.start_epoch == start // 8
                    and trainer.train_step.step == 8 * epochs):
                raise AssertionError(f"{label}: redraws {watch['changed']} / "
                                     f"{trainer.redraw_steps} != {want_steps}, or the count or "
                                     f"the start is wrong")
            if rose != expect:
                raise AssertionError(f"{label}: launches {rose} != {expect}")
            losses = [r["loss"] for r in rows] + [e["loss"] for e in trainer.evals]
            if not all(math.isfinite(v) for v in losses):
                raise AssertionError(f"{label}: losses not finite: {losses}")
            if start == 0:
                # the buffers the last step saw are the checkpoint's, and the
                # last redraw is the draw keyed by (seed, step, 2)
                ckpt = torch.load(os.path.join(EFFICIENT_EXPERIMENT_DIR, "checkpoint_2.ckpt"),
                                  map_location="cpu", weights_only=True)["model"]
                gen = torch.Generator().manual_seed(
                    engine.keyed_seed(trainer.cfg.TPU.SEED, want_steps[-1], 2))
                for n, b in watch["last"].items():
                    draw = gaussian_orthogonal_random_matrix(*b.shape, generator=gen)
                    if not (torch.equal(ckpt[n], b.cpu()) and torch.equal(draw, b.cpu())):
                        raise AssertionError(f"{n}: the checkpoint's or the keyed draw differs "
                                             f"from the buffer the last step saw")
            elif not all(torch.equal(b.cpu(), ckpt[n]) for n, b in watch["loaded"].items()):
                raise AssertionError("the resumed run did not load the checkpoint's buffers")
            del trainer
    finally:
        Trainer.__init__, engine.TrainStep.__call__ = init, call
    return launch_counts(kernels)


# the high-resolution paths (part ``highres``): path → (zoo model, image px,
# batch, the batch of the f32 and bf16 kernels-vs-plain pairs, serves,
# trains, random shift). The pairs' batches are cut where the plain versions'
# memory would not fit: the plain dense attention keeps (B, H, N, N) f32
# scores and probabilities, about 0.8 GB an image and a block at N 4097
HIGHRES = {
    "serve_384": ("vil_medium_deep", 384, 64, 64, True, False, False),
    "train_384": ("vil_medium_deep", 384, 64, 8, False, True, False),
    "serve_1024": ("vil_small", 1024, 8, 8, True, False, False),
    "train_1024": ("vil_small", 1024, 8, 2, False, True, False),
    "shift_1024": ("vil_small", 1024, 8, 2, False, True, True),
    "base_deep_384": ("vil_base_deep_384", 384, 32, 4, True, True, False),
}
PROFILED = 2  # requests or steps of a path under torch.profiler, after the timed ones


def run_highres_path(torch, kernels, name: str) -> dict:
    """One high-resolution path of ``HIGHRES`` at full width and depth,
    seeded random weights (``recipe.vil``), bf16 compute: ``REQUESTS``
    serving forwards of uint8 images (bf16 parameters) and/or ``STEPS``
    training steps of the recipe (f32 parameters; ``recipe.train_step``,
    random shift where asked), each then ``PROFILED`` more under
    ``torch.profiler``; the launches of every forward and step held exactly
    (B1 and B3 per sliding-chunk and dense block a forward, B2 and B4 more a
    step; B5, B6 in place of B1, B2 at random shift). Then the f32 pair and
    the bf16 pair, kernels vs plain versions from the same weights, at the
    path's pair batch: logits (serving) to LOGITS_TOL and BF16_LOGITS_TOL,
    one step's loss and every parameter gradient (training) to LOSS_TOL,
    PARAM_GRAD_TOL and BF16_PARAM_GRAD_TOL. Returns the path's launches."""
    from vil_tpu_torch.ops import flops
    from vil_tpu_torch.tools.profile_step import family, kernel_ms
    from vil_tpu_torch.train import engine, recipe

    arch_name, img, batch, pair, serves, trains, shift = HIGHRES[name]
    dev = torch.device("cuda")
    t_path = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(1)
    served = torch.randint(0, 256, (batch, img, img, 3), generator=gen, device=dev,
                           dtype=torch.uint8)
    images = torch.randn(batch, img, img, 3, generator=gen, device=dev)
    labels = torch.randint(0, 1000, (batch,), generator=gen, device=dev)
    macs = flops.model_macs(recipe.vil_cfg(arch_name, img).MODEL.VIT.MSVIT.ARCH, img)
    what = f"{arch_name} {img}^2 bf16 batch {batch}"
    phase(name, f"{what}: {macs['gmacs']:.3f} GMACs an image (ops/flops.py), "
                f"{macs['params'] / 1e6:.2f} M parameters")
    want = {fn.__name__: 0 for fn in kernels}

    def measure(label, call, per_call, count):
        """``count`` timed calls, each one's launches held to ``per_call``,
        then PROFILED more under torch.profiler: the walls, the card's time
        and idle share, the top families and the peak memory."""

        def timed():
            before = launch_counts(kernels)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            call()
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            rose = {k: v - before[k] for k, v in launch_counts(kernels).items()}
            expect = {k: per_call.get(k, 0) for k in rose}
            if rose != expect:
                raise AssertionError(f"{name} {label} {len(secs)}: launches rose by {rose}, "
                                     f"want {expect}")

        torch.cuda.reset_peak_memory_stats()
        secs = []
        for _ in range(count):
            timed()
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(PROFILED):
                timed()
        for k, v in per_call.items():
            want[k] += v * (count + PROFILED)
        by_name = kernel_ms(prof)
        device = sum(by_name.values()) / PROFILED
        fams = {}
        for kernel, ms in by_name.items():
            fams[family(kernel)] = fams.get(family(kernel), 0.0) + ms / PROFILED
        top = ", ".join(f"{f} {ms:.3f}" for f, ms in sorted(fams.items(), key=lambda kv: -kv[1])[:8])
        med = statistics.median(secs[1:count])  # the first is the warm-up
        phase(name, f"{label}: median {med * 1e3:.3f} ms, {batch / med:.1f} img/s ({label}s "
                    f"2..{count}), first {secs[0] * 1e3:.1f} ms; device {device:.3f} ms a {label} "
                    f"(torch.profiler over {PROFILED} more), idle {100 * (1 - device / med / 1e3):.1f}%;"
                    f" top families (ms) {top}; peak memory "
                    f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    for fn in kernels:
        fn.launches = 0
    modes0 = None
    if serves:
        model = recipe.vil(arch_name, img, torch.bfloat16, torch.bfloat16, device=dev).eval()
        chunk, dense = block_counts(model)

        def serve():
            with torch.inference_mode():
                logits = model(served)
            if logits.shape != (batch, 1000) or not torch.isfinite(logits).all():
                raise AssertionError(f"{name}: bad logits {tuple(logits.shape)}")

        measure("request", serve, {"vil_attention_fwd": chunk, "full_attention_fwd": dense},
                REQUESTS)
        del model
    if trains:
        model = recipe.vil(arch_name, img, torch.bfloat16, torch.float32, device=dev)
        chunk, dense = block_counts(model)
        step = recipe.train_step(model, dev, shift, batch=batch)
        step_gen = torch.Generator(device=dev).manual_seed(3)
        losses, modes = [], []

        def train():
            metrics = step(images, labels, step_gen)
            losses.append(metrics["loss"].item())
            modes.append(metrics.get("modes"))

        pre = "vil_mode_attention" if shift else "vil_attention"
        measure("step", train, {f"{pre}_fwd": chunk, f"{pre}_bwd": chunk,
                                "full_attention_fwd": dense, "full_attention_bwd": dense}, STEPS)
        if not all(math.isfinite(v) for v in losses):
            raise AssertionError(f"{name}: losses not finite: {losses}")
        phase(name, f"losses {', '.join(f'{v:.4f}' for v in losses)}"
                    + (f"; per-block modes drawn by the step {modes}" if shift else ""))
        # the recipe's first draw of per-block modes, for the step pairs
        modes0 = engine.sample_vil_modes(torch.Generator().manual_seed(0), model.depth) \
            if shift else None
        del model, step
    launches = launch_counts(kernels)
    phase(name, f"{what}: launches {({k: v for k, v in launches.items() if v})} (want "
                f"{({k: v for k, v in want.items() if v})}, the rest 0)")
    if launches != want:
        raise AssertionError(f"{name}: launch counts {launches} != {want}")
    torch.cuda.empty_cache()

    def build(dtype, param_dtype, use_kernels):
        return recipe.vil(arch_name, img, dtype, param_dtype, use_kernels, dev)

    if serves:  # logits, kernels vs plain versions, in f32 then bf16
        x, outs = served[:pair], {}
        with torch.inference_mode():
            for key, dtype, use_kernels in (("kernels", torch.float32, True),
                                            ("plain", torch.float32, False),
                                            ("bf16 kernels", torch.bfloat16, True),
                                            ("bf16 plain", torch.bfloat16, False)):
                m = build(dtype, dtype, use_kernels).eval()
                outs[key] = m(x).float()
                del m
                torch.cuda.empty_cache()
        err = (outs["kernels"] - outs["plain"]).abs().max().item()
        scaled = lambda a, b: ((outs[a] - outs[b]).abs().max() / outs[b].abs().max()).item()
        bf_err, own = scaled("bf16 kernels", "bf16 plain"), scaled("bf16 plain", "plain")
        phase(name, f"batch {pair}: f32 logits, kernels vs plain versions: max|err| {err:.3e} "
                    f"(tol {LOGITS_TOL:g}), |logits| max {outs['plain'].abs().max().item():.3f}; "
                    f"bf16 logits max|err| / max|ref| {bf_err:.3e} (tol {BF16_LOGITS_TOL:g}), "
                    f"plain bf16 vs plain f32 {own:.3e}")
        if not (torch.isfinite(outs["kernels"]).all() and err <= LOGITS_TOL):
            raise AssertionError(f"{name}: f32 logits disagree: {err}")
        if not (torch.isfinite(outs["bf16 kernels"]).all() and bf_err <= BF16_LOGITS_TOL):
            raise AssertionError(f"{name}: bf16 logits disagree: {bf_err}")
        del outs
    if trains:

        def one_step(dtype, use_kernels):
            """One step of the recipe from its weights, the same images,
            draws and (random shift) modes: (loss, parameter gradients)."""
            m = build(dtype, torch.float32, use_kernels)
            s = recipe.train_step(m, dev, shift, batch=batch)
            loss = s(images[:pair], labels[:pair], torch.Generator(device=dev).manual_seed(3),
                     modes=modes0)["loss"].item()
            grads = {n: p.grad.clone() for n, p in m.named_parameters()}
            del m, s
            torch.cuda.empty_cache()
            return loss, grads

        (loss_k, grads_k), (loss_p, grads_p) = (one_step(torch.float32, True),
                                                one_step(torch.float32, False))
        grad_err, worst, _ = f32_grad_errors(grads_k, grads_p)
        del grads_k
        (bf_loss_k, bf_k), (bf_loss_p, bf_p) = (one_step(torch.bfloat16, True),
                                                one_step(torch.bfloat16, False))
        (bf_err, at), (own, own_at) = bf16_grad_worst(bf_k, bf_p), bf16_grad_worst(bf_p, grads_p)
        phase(name, f"batch {pair}{f', modes {modes0}' if shift else ''}: f32 step, kernels vs "
                    f"plain versions: loss {loss_k:.6f} vs {loss_p:.6f} (|err| "
                    f"{abs(loss_k - loss_p):.3e}, tol {LOSS_TOL:g}); parameter gradients max rel "
                    f"err {grad_err:.3e} at {worst} (tol {PARAM_GRAD_TOL:g}); bf16 step: loss "
                    f"{bf_loss_k:.6f} vs {bf_loss_p:.6f}, gradients max ‖err‖ / ‖ref‖ {bf_err:.3e} "
                    f"at {at} (tol {BF16_PARAM_GRAD_TOL:g}), plain bf16 vs plain f32 {own:.3e} at "
                    f"{own_at}")
        if not (abs(loss_k - loss_p) <= LOSS_TOL and grad_err <= PARAM_GRAD_TOL):
            raise AssertionError(f"{name}: f32 step disagrees: loss {abs(loss_k - loss_p)}, "
                                 f"gradients {grad_err} at {worst}")
        if not (math.isfinite(bf_loss_k) and bf_err <= BF16_PARAM_GRAD_TOL):
            raise AssertionError(f"{name}: bf16 step disagrees: gradients {bf_err} at {at}")
        del grads_p, bf_k, bf_p
    torch.cuda.empty_cache()
    phase(name, f"the path {time.perf_counter() - t_path:.1f} s")
    return launches


FINETUNE_DIR = os.path.join(REPO, "build", "chip_finetune")
# configs/msvit_384finetune.yaml on ViL-Medium-Wide 384² (its f8/f12
# windows), from a 224² ViL-Medium-Wide .pth: the synthetic set at 384²,
# batch 32 (the yaml's 256, cut): one epoch of 8 steps and its eval; the
# recipe's own QHM, cosine schedule and FINETUNE.USE_TRAIN_AUG False
FINETUNE_ARGS = ["--config-file", os.path.join(REPO, "configs", "msvit_384finetune.yaml"),
                 "--output_dir", FINETUNE_DIR, "--seed", "0",
                 "DATA.TRAIN", "('synthetic',)", "DATA.TEST", "('synthetic',)",
                 "DATALOADER.BSZ", "32", "OPTIM.EPOCHS", "1",
                 "MODEL.ARCH", "vil_medium_wide_384", "LOG_FREQ", "1"]


def run_finetune(torch, kernels) -> dict:
    """The 384² fine-tune recipe through ``run_experiment.main(argv)``: a
    seeded ViL-Medium-Wide 224² model saved under the reference's names
    (``torch_import.reference_key``; ``module.`` prefixes under ``net``) as
    a .pth (each tensor moved by seeded noise off its init), loaded by the
    Trainer into ViL-Medium-Wide 384² (MODEL.MODEL_PATH)
    and trained one epoch of 8 steps, then its eval. Every parameter right
    after the load must equal, bit for bit, what ``import_torch_checkpoint``
    gives for the file on the CPU (the x/y position embeddings resized);
    each logged LR must be ``get_lr_schedule``'s at its step; launches equal
    the trainer's counts (``experiment_want``); the f32 eval of the
    checkpoint, kernels vs plain versions, to LOSS_TOL, top1 equal."""
    import shutil

    from vil_tpu_torch.models import build_model
    from vil_tpu_torch.train import recipe, schedulers
    from vil_tpu_torch.train.trainer import Trainer
    from vil_tpu_torch.utils import torch_import

    name = "finetune_384"
    t_path = time.perf_counter()
    shutil.rmtree(FINETUNE_DIR, ignore_errors=True)
    os.makedirs(FINETUNE_DIR)
    pth = os.path.join(FINETUNE_DIR, "vil_medium_wide_224.pth")
    # seeded weights, every tensor moved off its init (zero biases, unit
    # norms) as training would, so that a tensor the load missed shows
    source = recipe.vil("vil_medium_wide", 224, torch.float32, device="cpu")
    noise = torch.Generator().manual_seed(1)
    state = {"module." + torch_import.reference_key(n):
             p.detach() + 0.02 * torch.randn(p.shape, generator=noise)
             for n, p in source.named_parameters()}
    torch.save({"net": state, "epoch": 300}, pth)
    del source
    phase(name, f"{os.path.relpath(pth, REPO)}: {len(state)} tensors of a seeded ViL-Medium-Wide "
                f"224^2 under the reference's names ({time.perf_counter() - t_path:.1f} s)")
    loaded = {}
    init = Trainer.__init__

    def watched_init(self, *args, **kwargs):
        init(self, *args, **kwargs)
        loaded["params"] = {n: p.detach().cpu().clone() for n, p in self.model.named_parameters()}

    for fn in kernels:
        fn.launches = 0

    run = lambda label, argv: run_cli(torch, kernels, name, label, argv)

    Trainer.__init__ = watched_init
    try:
        torch.cuda.reset_peak_memory_stats()
        trainer = run("fine-tune epoch", FINETUNE_ARGS + ["MODEL.MODEL_PATH", pth])
    finally:
        Trainer.__init__ = init
    cfg, log = trainer.cfg, trainer.steps_log
    # the load, against the CPU importer on a model built from the same tree
    cpu = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(cfg.TPU.SEED))
    fresh = {n: p.detach().clone() for n, p in cpu.named_parameters()}
    torch_import.load_into_model(pth, cpu)
    differ = [n for n, p in cpu.named_parameters() if not torch.equal(p, loaded["params"][n])]
    kept = [n for n, p in cpu.named_parameters() if p.numel() and torch.equal(p, fresh[n])]
    resized = {n: f"{tuple(state['module.' + torch_import.reference_key(n)].shape)} -> "
                  f"{tuple(p.shape)}" for n, p in cpu.named_parameters()
               if p.shape != state["module." + torch_import.reference_key(n)].shape}
    phase(name, f"{cfg.MODEL.ARCH} {cfg.INPUT.IMAGE_SIZE}^2 from {os.path.basename(pth)} "
                f"({len(state)} tensors): {len(loaded['params'])} parameters after the load, "
                f"{len(differ)} differ from the CPU importer's bit for bit, {len(kept)} kept "
                f"their init; resized {resized}")
    if differ or kept or not resized:
        raise AssertionError(f"the fine-tune load: differ {differ}, kept {kept}, resized {resized}")
    del cpu, fresh, loaded["params"]
    # the schedule and the run
    schedule = schedulers.get_lr_schedule(cfg)
    wrong = [(r["step"], r["lr"]) for r in log if r["lr"] != schedule(r["step"])]
    batch = statistics.median(r["batch_time"] for r in log[1:])
    data = statistics.median(r["data_time"] for r in log[1:])
    ev = trainer.evals[0]
    lrs = ", ".join(f"{r['lr']:.6g}" for r in log)
    losses = ", ".join(f"{r['loss']:.4f}" for r in log)
    phase(name, f"{len(log)} steps of OPTIM.OPT {cfg.OPTIM.OPT} at LR {lrs} (get_lr_schedule's: "
                f"{'all' if not wrong else wrong}; warm-up {cfg.SOLVER.WARMUP_EPOCHS} epochs of "
                f"{cfg.SOLVER.STEPS_PER_EPOCH} steps); median batch_time {batch * 1e3:.3f} ms, "
                f"data_time {data * 1e3:.3f} ms (steps 2..{len(log)}), "
                f"{cfg.DATALOADER.BSZ / batch:.1f} img/s; losses {losses}; eval top1 "
                f"{ev['top1']:.4f} loss "
                f"{ev['loss']:.6f} over {ev['images']} images; peak memory "
                f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if wrong or len(log) != 8 or cfg.OPTIM.OPT != "qhm" or cfg.FINETUNE.USE_TRAIN_AUG:
        raise AssertionError(f"the fine-tune run: {len(log)} steps, LR off the schedule at {wrong}")
    del trainer
    # the f32 eval of the checkpoint, kernels vs plain versions
    ckpt = os.path.join(FINETUNE_DIR, "checkpoint_1.ckpt")
    evals = {}
    for key, use_kernels in (("kernels", "True"), ("plain", "False")):
        argv = FINETUNE_ARGS + ["EVALUATE", "True", "MODEL.MODEL_PATH", ckpt,
                                "TPU.COMPUTE_DTYPE", "float32", "TPU.USE_PALLAS", use_kernels]
        argv[argv.index("--output_dir") + 1] = os.path.join(FINETUNE_DIR, f"f32_{key}")
        evals[key] = run(f"EVALUATE f32 {key}", argv).evals[-1]
    f32_k, f32_p = evals["kernels"], evals["plain"]
    err = abs(f32_k["loss"] - f32_p["loss"])
    phase(name, f"f32 eval of checkpoint_1, kernels vs plain versions: loss {f32_k['loss']:.6f} "
                f"vs {f32_p['loss']:.6f} (|err| {err:.3e}, tol {LOSS_TOL:g}); top1 "
                f"{f32_k['top1']} vs {f32_p['top1']}")
    if not (err <= LOSS_TOL and f32_k["top1"] == f32_p["top1"]):
        raise AssertionError(f"f32 eval disagrees: loss {err}, top1 {f32_k['top1']} vs "
                             f"{f32_p['top1']}")
    phase(name, f"the path {time.perf_counter() - t_path:.1f} s")
    return launch_counts(kernels)


def run_highres(torch, kernels) -> dict:
    """Part ``highres``: the paths of ``HIGHRES``, then ``finetune_384``.
    Returns {path: launches}."""
    paths = {name: run_highres_path(torch, kernels, name) for name in HIGHRES}
    paths["finetune_384"] = run_finetune(torch, kernels)
    return paths


# the parts ``--only`` picks from: phase 3, then the main paths in run order
PARTS = ("kernels", "serve", "train", "shift", "serve_fused", "train_fused", "serve_spatial",
         "probe", "serve_rpe", "train_rpe", "shift_rpe", "train_fused_rpe", "experiment",
         "efficient", "highres")


def only_arg(argv) -> "set | None":
    """``--only a,b``: run the build and those parts alone, to read their
    checks; they pass or fail as in the whole run, which alone prints the
    records and the result line. None (no argument): every part."""
    if not argv:
        return None
    if len(argv) != 2 or argv[0] != "--only" or not set(argv[1].split(",")) <= set(PARTS):
        raise SystemExit(f"usage: chip_smoke.py [--only part,...], parts {', '.join(PARTS)}")
    return set(argv[1].split(","))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script runs only on a CUDA card")
    only = only_arg(sys.argv[1:])
    sys.path.insert(0, REPO)
    from vil_tpu_torch.ops.kernels import KERNELS, build
    from vil_tpu_torch.tools import layout_probe

    kernels = (*KERNELS, *layout_probe.KERNELS)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    card = card_line()
    phase("device", f"{kind} x{torch.cuda.device_count()}; torch {torch.__version__}, "
                    f"CUDA {torch.version.cuda}; {card}")

    t0 = time.perf_counter()
    lib_path = build.build()
    build.load()
    phase("build", f"{os.path.relpath(lib_path, REPO)} from vil_tpu_torch/csrc "
                   f"(nvcc {' '.join(build.NVCC_FLAGS[:2])}, one process per source) in "
                   f"{time.perf_counter() - t0:.1f} s")
    log = lib_path.with_suffix(".log")
    if log.exists():
        kernel = ""
        for line in log.read_text().splitlines():
            if "Function properties for" in line:
                kernel = line.split("Function properties for", 1)[1].strip()
            if "spill" in line and not line.strip().startswith("0 bytes stack"):
                phase("build", f"{kernel}: {line.strip()}")
    # the dense kernels' and the sliding-chunk forwards' and backwards'
    # instructions: the bf16 ones on the tensor cores (HGMMA) with their
    # tiles by cp.async (LDGSTS), at each of the five head dims the dense
    # forward, B1, B7a, B5, B9a's attention, and both passes of each
    # backward (B9b's attention too), and B9a's two and B9b's three products
    # at each of their four widths (1-4 64-column sub-tiles); each with its
    # registers
    from vil_tpu_torch.tools import sass_census

    t_census = time.perf_counter()
    every = sass_census.census("")  # one disassembly of the library (~30 s), every kernel
    for match, want in (("full_attention", 15), ("vil_attention_fwd", 5),
                        ("vil_attention_bwd", 10), ("vil_attention_halo_fwd", 5),
                        ("vil_attention_halo_bwd", 10), ("vil_mode_attention_fwd", 5),
                        ("vil_mode_attention_bwd", 10), ("vil_block_fwd", 13),
                        ("vil_block_bwd", 22)):
        census = {name: counts for name, counts in every.items() if match in name}
        for name, counts in sorted(census.items()):
            phase("build", f"SASS {name}: " + ", ".join(f"{k} {v}" for k, v in counts.items()))
            if "wgmma" in name and not (counts["HGMMA"] and counts["LDGSTS"]):
                raise AssertionError(f"{name}: no wgmma or no cp.async in its SASS: {counts}")
        if sum("wgmma" in name for name in census) < want:
            raise AssertionError(f"{match}: fewer than {want} wgmma kernels: {sorted(census)}")
    phase("build", f"SASS census in {time.perf_counter() - t_census:.1f} s")

    sources = {
        "vil_attention_fwd": ("vil_tpu_torch/csrc/vil_attention_fwd.cu",
                              "vil_tpu/ops/pallas/vil_kernel.py:1086"),
        "vil_attention_bwd": ("vil_tpu_torch/csrc/vil_attention_bwd.cu",
                              "vil_tpu/ops/pallas/vil_backward.py:1576"),
        "full_attention_fwd": ("vil_tpu_torch/csrc/full_attention_fwd.cu",
                               "vil_tpu/ops/pallas/full_attention.py:127"),
        "full_attention_bwd": ("vil_tpu_torch/csrc/full_attention_bwd.cu",
                               "vil_tpu/ops/pallas/full_attention.py:664"),
        "vil_mode_attention_fwd": ("vil_tpu_torch/csrc/vil_mode_attention_fwd.cu",
                                   "vil_tpu/ops/pallas/vil_mode_kernel.py:559"),
        "vil_mode_attention_bwd": ("vil_tpu_torch/csrc/vil_mode_attention_bwd.cu",
                                   "vil_tpu/ops/pallas/vil_mode_kernel.py:678"),
        "layer_norm_fwd": ("vil_tpu_torch/csrc/layer_norm.cu",
                           "vil_tpu/ops/pallas/layer_norm.py:108"),
        "layer_norm_bwd": ("vil_tpu_torch/csrc/layer_norm.cu",
                           "vil_tpu/ops/pallas/layer_norm.py:135"),
        "vil_block_fwd": ("vil_tpu_torch/csrc/vil_block_fwd.cu",
                          "vil_tpu/ops/pallas/vil_block.py:512"),
        "vil_block_bwd": ("vil_tpu_torch/csrc/vil_block_bwd.cu",
                          "vil_tpu/ops/pallas/vil_block.py:603"),
        "vil_attention_halo_fwd": ("vil_tpu_torch/csrc/vil_attention_halo_fwd.cu",
                                   "vil_tpu/ops/pallas/vil_kernel.py:821"),
        "vil_attention_halo_bwd": ("vil_tpu_torch/csrc/vil_attention_halo_bwd.cu",
                                   "vil_tpu/ops/pallas/vil_backward.py:757"),
        "consume_base": ("vil_tpu_torch/csrc/layout_probe.cu", "tools/layout_probe.py:36"),
        "consume_perm": ("vil_tpu_torch/csrc/layout_probe.cu", "tools/layout_probe.py:48"),
    }
    records = {name: {"name": name, "route": "cuda", "source": src, "replaces": rep,
                      "launches": 0, "max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0,
                      "bound_ms": 0.0, "bound_by": "", "library_ms": None,
                      "_bytes_ms": 0.0, "_ops_ms": 0.0}
               for name, (src, rep) in sources.items()}
    # the main paths, each with its launch counts (serve_spatial's run also
    # gives the spatial_bwd path's)
    runs = {
        "serve": lambda: run_serve(torch, kernels),
        "train": lambda: run_train(torch, kernels),
        "shift": lambda: run_train(torch, kernels, random_shift=True),
        "serve_fused": lambda: run_serve(torch, kernels, fused=True),
        "train_fused": lambda: run_train(torch, kernels, fused=True),
        "serve_spatial": lambda: run_serve_spatial(torch, kernels),
        "probe": lambda: run_probe(torch, kernels),
        # ViL-Small RPE: the biased paths
        "serve_rpe": lambda: run_serve(torch, kernels, rpe=True),
        "train_rpe": lambda: run_train(torch, kernels, rpe=True),
        "shift_rpe": lambda: run_train(torch, kernels, random_shift=True, rpe=True),
        "train_fused_rpe": lambda: run_train(torch, kernels, fused=True, rpe=True),
        # the entry point users run: config, data pipeline, trainer, checkpoints
        "experiment": lambda: run_experiment_path(torch, kernels),
        # the paper's other attention families, a path each, and the
        # performer through the entry point
        "efficient": lambda: run_efficient(torch, kernels),
        # high resolution: ViL-Medium-Deep 384², ViL-Small 1024², the _384
        # windows and the 384² fine-tune recipe
        "highres": lambda: run_highres(torch, kernels),
    }
    if only is None or "kernels" in only:
        t_part = time.perf_counter()
        check_kernels(torch, records)
        phase("kernels", f"phase 3 in {time.perf_counter() - t_part:.1f} s")
    paths = {}
    for name, run in runs.items():
        if only is not None and name not in only:
            continue
        t_part = time.perf_counter()
        if name == "serve_spatial":
            paths["serve_spatial"], paths["spatial_bwd"] = run()
        elif name in ("efficient", "highres"):
            paths.update(run())
        else:
            paths[name] = run()
        phase(name, f"part {name} in {time.perf_counter() - t_part:.1f} s")
    if only is not None:
        phase("done", f"part of the run ({', '.join(sorted(only))}): every check passed; "
                      f"no record and no result line")
        return 0
    for name, rec in records.items():
        rec["launches"] = sum(counts[name] for counts in paths.values())
        for path, counts in paths.items():
            rec[f"launches_{path}"] = counts[name]
        rec["bound_by"] = "bytes" if rec.pop("_bytes_ms") >= rec.pop("_ops_ms") else "operations"
        per_path = ", ".join(f"{path} {counts[name]}" for path, counts in paths.items())
        phase("record", f"{name}: {rec['ms']:.3f} ms per step of its path (plain "
                        f"{rec['plain_ms']:.3f}, bound {rec['bound_ms']:.4f} by {rec['bound_by']}, "
                        f"library {rec['library_ms']}), launches {rec['launches']} ({per_path})")
    idle = [name for name, rec in records.items() if not rec["launches"]]
    if idle:
        raise AssertionError(f"kernels no main path launched: {idle}")

    print(card, flush=True)
    print(json.dumps({"kernels": list(records.values())}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
