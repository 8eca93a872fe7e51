"""Where the time of a step of a ViL model goes on one CUDA card.

    python -m vil_tpu_torch.tools.profile_step
        [--mode train|train_shift|serve|serve_spatial] [--fused] [--rpe]
        [--attn linformer|srformer|performer|global|unshared]
        [--arch vil_small] [--img 224] [--batch 64] [--out profile_train.json]

Runs the recipe of ``vil_tpu_torch.train.recipe`` on the zoo model ``--arch``
at ``--img`` px, ``--batch`` images a step (``recipe.vil``: ViL-Small 224² at
64 by default, ``--arch vil_small --img 1024 --batch 8`` ViL-Small 1024²; bf16
compute; f32 parameters for training, bf16 for serving; ``train_shift`` is
the random-shift step, one sampled neighbour mode per block; ``--fused`` the
fused-kernel configuration, ``recipe.vil_small(..., fused=True)``; ``--rpe``
ViL-Small RPE, ``recipe.vil_small(..., rpe=True)``, served from
``models.precompute_rpe_cache``; ``--attn`` one of the paper's other
attention families, ``recipe.vil(..., **recipe.VARIANTS[attn])``, whose
ARCH string (linformer, srformer, performer) is ViL-Small's;
``serve_spatial`` the serving forward through ``parallel.spatial_forward`` on
a one-rank ``nccl`` group, set up from a ``FileStore`` under build/) under
``torch.profiler`` for 5 steps after 3 warm-up steps, and prints the device time per step by
kernel family and the top kernels, the wall time per step and the device's
busy share (kernel time over wall time). The profiler's own host work
lengthens the wall time, so that share is a lower bound. The same numbers go
to ``--out`` as JSON, with the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import time

import torch

WARMUP, STEPS = 3, 5

# kernel-name patterns → family, first match wins
FAMILIES = [
    ("B1 sliding-chunk fwd", r"vil_attention_fwd_(wgmma|kernel)"),
    # bf16 on the tensor cores (_wgmma), f32 on the CUDA cores
    ("B2 sliding-chunk bwd", r"vil_attention_bwd_(wgmma_)?pass"),
    ("B3 dense fwd", r"full_attention_fwd_(wgmma|kernel)"),
    ("B4 dense bwd", r"full_attention_bwd_(wgmma_)?pass"),
    ("B5 sampled-neighbour fwd", r"vil_mode_attention_fwd_(wgmma|kernel)"),
    ("B6 sampled-neighbour bwd", r"vil_mode_attention_bwd_(wgmma_)?pass"),
    ("B7a halo fwd", r"vil_attention_halo_fwd_(wgmma|kernel)"),
    ("B7b halo bwd", r"vil_attention_halo_bwd_(wgmma_)?pass"),
    ("B8 LayerNorm fwd", r"vil_ln_fwd"),
    # B8b in two parts: dx with the per-block partials, and their sum
    ("B8 LayerNorm bwd: rows", r"vil_ln_bwd_rows"),
    ("B8 LayerNorm bwd: reduce", r"vil_ln_bwd_reduce"),
    # B9a in three parts (bf16 on the tensor cores: _wgmma): the q/k/v
    # projections, the attention and the output projection
    ("B9a fused block fwd: projections", r"vil_block_fwd_proj_qkv"),
    ("B9a fused block fwd: attention", r"vil_block_fwd_att"),
    ("B9a fused block fwd: output projection", r"vil_block_fwd_proj_out"),
    # B9b in three parts: the attention passes, the products (dattn, the
    # weight gradients, dx; bf16 on the tensor cores: _wgmma) and the rest
    ("B9b fused block bwd: attention", r"vil_block_bwd_attn_(wgmma_)?pass"),
    ("B9b fused block bwd: products", r"vil_block_bwd_(proj_out|wgrad|proj_in)"),
    ("B9b fused block bwd: rest", r"vil_block_bwd_(glo|bgrad|reduce)"),
    ("NCCL", r"nccl|ncclDevKernel"),
    ("GEMM", r"gemm|cutlass|xmma|nvjet|cublas|matmul|sm90_"),
    ("convolution", r"conv|cudnn|implicit"),
    ("LayerNorm", r"layer_norm|LayerNorm"),
    ("optimizer", r"multi_tensor|adam|Adam"),
    ("softmax", r"softmax|Softmax"),
    ("reduction", r"reduce|Reduce"),
    ("copy, cat, index", r"copy|Copy|cat|Cat|Memcpy|Memset|memset|index|Index|gather|scatter"),
    ("elementwise", r"elementwise|vectorized|unrolled|Elementwise"),
]


def family(name: str) -> str:
    for fam, pattern in FAMILIES:
        if re.search(pattern, name):
            return fam
    return "other"


def card_line() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[0]


def kernel_ms(prof) -> dict:
    """{kernel name: device ms} summed over a finished ``torch.profiler``
    run, kernels only."""
    kernels = {}
    for evt in prof.key_averages():
        us = getattr(evt, "self_device_time_total", 0) or getattr(evt, "self_cuda_time_total", 0)
        # GPU-side user annotations (e.g. Optimizer.step#AdamW.step) span
        # kernels already counted: kernels only
        if (us > 0 and evt.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(evt, "is_user_annotation", False)):
            kernels[evt.key] = kernels.get(evt.key, 0.0) + us / 1e3
    return kernels


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mode", choices=("train", "train_shift", "serve", "serve_spatial"), default="train")
    ap.add_argument("--fused", action="store_true",
                    help="the fused-kernel configuration (TPU.FUSED_LN, fused block)")
    ap.add_argument("--rpe", action="store_true",
                    help="ViL-Small RPE: relative position bias in every stage")
    ap.add_argument("--attn", choices=("linformer", "srformer", "performer", "global",
                                       "unshared"), default=None,
                    help="one of the paper's other attention families (recipe.VARIANTS)")
    ap.add_argument("--arch", default="vil_small", help="a model of the zoo (models.ARCH_ZOO)")
    ap.add_argument("--img", type=int, default=224, help="image size, px")
    ap.add_argument("--batch", type=int, default=64, help="images a step")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_step: needs a CUDA card")
    from ..train import recipe

    variant = recipe.VARIANTS[args.attn] if args.attn else {}
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2)
    images = torch.randn(args.batch, args.img, args.img, 3, generator=gen, device=dev)
    labels = torch.randint(0, 1000, (args.batch,), generator=gen, device=dev)
    if args.mode in ("train", "train_shift"):
        model = recipe.vil(args.arch, args.img, torch.bfloat16, torch.float32, device=dev,
                           fused=args.fused, rpe=args.rpe, **variant)
        step_fn = recipe.train_step(model, dev, random_shift=args.mode == "train_shift",
                                    batch=args.batch)
        step_gen = torch.Generator(device=dev).manual_seed(3)
        run = lambda: step_fn(images, labels, step_gen)
    else:
        model = recipe.vil(args.arch, args.img, torch.bfloat16, torch.bfloat16, device=dev,
                           fused=args.fused, rpe=args.rpe, **variant).eval()
        if args.rpe:
            from ..models import precompute_rpe_cache

            precompute_rpe_cache(model)
        images = torch.randint(0, 256, images.shape, generator=gen, device=dev,
                               dtype=torch.uint8)  # normalised on the device
        forward = model
        if args.mode == "serve_spatial":
            from .. import parallel

            build_dir = os.path.join(os.path.dirname(__file__), "..", "..", "build")
            os.makedirs(build_dir, exist_ok=True)
            store = os.path.join(build_dir, f"spatial_store.{os.getpid()}")
            parallel.init_process_group(store, 0, 1, backend="nccl")
            forward = lambda x: parallel.spatial_forward(model, parallel.shard_image(x))

        def run():
            with torch.inference_mode():
                return forward(images)

    for _ in range(WARMUP):
        run()
    torch.cuda.synchronize()
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for _ in range(STEPS):
            run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / STEPS
    kernels = {name: ms / STEPS for name, ms in kernel_ms(prof).items()}
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()
    device_ms = sum(kernels.values())
    fams = {}
    for name, ms in kernels.items():
        fams[family(name)] = fams.get(family(name), 0.0) + ms
    card = card_line()
    result = {
        "mode": args.mode, "fused": args.fused, "rpe": args.rpe, "attn": args.attn,
        "arch": args.arch, "img": args.img, "batch": args.batch,
        "steps": STEPS,
        "card": card,
        "wall_ms_per_step": wall_ms, "device_ms_per_step": device_ms,
        "busy_share": device_ms / wall_ms if wall_ms else None,
        "families_ms": dict(sorted(fams.items(), key=lambda kv: -kv[1])),
        "top_kernels_ms": dict(sorted(kernels.items(), key=lambda kv: -kv[1])[:30]),
    }
    label = (args.mode + (" fused" if args.fused else "") + (" RPE" if args.rpe else "")
             + (f" {args.attn}" if args.attn else ""))
    print(f"{card}; {args.arch} {args.img}^2 {label} bf16 batch {args.batch}: wall "
          f"{wall_ms:.3f} ms per step, device {device_ms:.3f} ms, busy {100 * device_ms / wall_ms:.1f}%")
    for fam, ms in result["families_ms"].items():
        print(f"  {fam:32s} {ms:9.3f} ms  {100 * ms / device_ms:5.1f}%")
    for name, ms in result["top_kernels_ms"].items():
        print(f"  {ms:9.3f} ms  {name[:110]}")
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)


if __name__ == "__main__":
    main()
