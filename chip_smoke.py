#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``vil_tpu_torch``) once on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root; needs one CUDA card

Phases, one line each; any failure raises and the exit code is not 0:

1. device  — refuse to run without CUDA; the card's name and power limit.
2. build   — compile ``vil_tpu_torch/csrc/*.cu`` with nvcc for sm_90a.
3. kernels — each kernel against its plain PyTorch version at the shapes of
   ViL-Small 224² inference (f32 and bf16), plus a biased and a small odd
   case of each; kernel and plain times (CUDA events, median of 20).
4. slice   — ViL-Small 224², 1000 classes, bf16, batch 64, random seeded
   weights: six requests of uint8 images; the launch counts must be 3
   (sliding-chunk) and 9 (dense) per forward; then the same weights in f32
   with the kernels and with the plain versions must agree.

The last line is ``{"ok": true, "device": {...}}``; the line before it holds
every kernel's record, and the line before that the card as
``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives it.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
BATCH = 64
REQUESTS = 6  # the first is the warm-up, left out of the img/s median
F32_TOL = 1e-4  # kernel vs plain, f32 inputs: f32 sums in another order
BF16_TOL = 2e-2  # kernel on bf16 inputs vs plain in f32 on the same values
LOGITS_TOL = 1e-3  # whole model in f32, kernels vs plain versions


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


def check_kernels(torch, records):
    """Phase 3. Fills ``records[name]`` with errors and per-forward times."""
    from vil_tpu_torch.ops import masks as masks_lib
    from vil_tpu_torch.ops import sliding_chunk as sc
    from vil_tpu_torch.ops.kernels import (
        full_attention_fwd, full_attention_reference, mask_to_additive,
        vil_attention_fwd, vil_attention_reference,
    )

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    randn = lambda *s, scale=1.0: torch.randn(*s, generator=gen, device=dev) * scale

    def compare(name, label, kernel, plain, acts, rest, dtype, tol, per_forward=0):
        """kernel(*acts, *rest) against plain() in f32 on the same values;
        ``acts`` (q, k, v, ...) take ``dtype``, ``rest`` (tables, H) stay."""
        acts = [None if a is None else a.to(dtype) for a in acts]
        args = acts + rest
        out = kernel(*args)
        ref = plain(*[None if a is None else a.float() for a in acts], *rest)
        torch.cuda.synchronize()
        err = (out.float() - ref).abs().max().item()
        rec = records[name]
        msg = f"{name} {label} {str(dtype)[6:]}: max|err| {err:.3e} (tol {tol:g})"
        if per_forward:
            ms = time_ms(lambda: kernel(*args))
            plain_ms = time_ms(lambda: plain(*args))
            msg += (f", kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                    f"x{per_forward} per forward")
            if dtype == torch.bfloat16:  # the main path's type
                rec["ms"] += per_forward * ms
                rec["plain_ms"] += per_forward * plain_ms
                rec["max_abs_err"] = max(rec["max_abs_err"], err)
        phase("kernels", msg)
        if not err <= tol:
            raise AssertionError(f"{name} {label} {dtype}: max|err| {err} > {tol}")

    def vil_case(label, B, nx, ny, w, C, H, nglo, exact, with_bias, per_forward=0):
        padx, pady, mx, my = sc.chunk_grid(nx, ny, w)
        w2 = w * w
        mask = torch.from_numpy(mask_to_additive(
            masks_lib.invalid_mask(mx, my, padx, pady, w, exact, 0), mx, my, w2, nglo,
        )).to(dev)
        acts = [randn(B, mx, my, w2, C, scale=C ** -0.25) for _ in range(3)]
        acts += [randn(B, nglo, C) if nglo else None for _ in range(2)]
        rest = [randn(H, w2, nglo + 9 * w2, scale=0.5) if with_bias else None, mask, H]
        for dtype, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
            compare("vil_attention_fwd", label, vil_attention_fwd,
                    vil_attention_reference, acts, rest, dtype, tol, per_forward)

    def full_case(label, B, N, C, H, with_bias, per_forward=0):
        acts = [randn(B, N, C, scale=C ** -0.25) for _ in range(3)]
        rest = [randn(H, N, N, scale=0.5) if with_bias else None, H]
        for dtype, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
            compare("full_attention_fwd", label, full_attention_fwd,
                    full_attention_reference, acts, rest, dtype, tol, per_forward)

    # ViL-Small 224²: stage 1 (1 block) and stage 2 (2 blocks) sliding-chunk
    vil_case("stage1 (64,8,8,49,96) H3", 64, 56, 56, 7, 96, 3, 1, 0, False, 1)
    vil_case("stage2 (64,4,4,49,192) H3", 64, 28, 28, 7, 192, 3, 1, 0, False, 2)
    vil_case("biased, padded 3x3 grid, nglo 2", 2, 19, 20, 7, 64, 2, 2, 0, True)
    vil_case("SW_EXACT 1, 2x2 grid, nglo 0", 2, 13, 14, 7, 32, 1, 0, 1, True)
    vil_case("SW_EXACT -1, W 4", 3, 14, 15, 4, 48, 3, 1, -1, False)
    # stage 3 (8 blocks) and stage 4 (1 block) dense
    full_case("stage3 (64,197,384) H6", 64, 197, 384, 6, False, 8)
    full_case("stage4 (64,49,768) H12", 64, 49, 768, 12, False, 1)
    full_case("biased N 130", 2, 130, 96, 3, True)
    full_case("N 1025", 2, 1025, 192, 3, False)


def run_slice(torch, kernels):
    """Phase 4: the inference path of ViL-Small 224²."""
    from vil_tpu_torch.models import ARCH_ZOO, MsViT

    dev = torch.device("cuda")

    def build(dtype, use_kernels):
        return MsViT(
            arch=ARCH_ZOO["vil_small"], img_size=224, num_classes=1000,
            attn_type="longformerhand", sharew=True, norm_embed=True,
            dtype=dtype, device=dev, use_kernels=use_kernels,
            generator=torch.Generator().manual_seed(0),
        ).eval()

    gen = torch.Generator(device=dev).manual_seed(1)
    images = [torch.randint(0, 256, (BATCH, 224, 224, 3), generator=gen, device=dev,
                            dtype=torch.uint8) for _ in range(REQUESTS)]
    model = build(torch.bfloat16, True)
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
    launches = {fn.__name__: fn.launches for fn in kernels}
    want = {"vil_attention_fwd": 3 * REQUESTS, "full_attention_fwd": 9 * REQUESTS}
    phase("slice", f"ViL-Small 224^2 bf16 batch {BATCH}: {REQUESTS} requests, "
                   f"launches {launches} (want {want})")
    if launches != want:
        raise AssertionError(f"launch counts {launches} != {want}")
    img_s = BATCH / statistics.median(secs[1:])
    phase("slice", f"bf16 forward: median {statistics.median(secs[1:]) * 1e3:.3f} ms "
                   f"per batch, {img_s:.1f} img/s (requests 2..{REQUESTS}); first "
                   f"request {secs[0] * 1e3:.1f} ms")
    del model

    x = images[0]
    outs = {}
    with torch.inference_mode():
        for use_kernels in (True, False):
            m = build(torch.float32, use_kernels)
            outs[use_kernels] = m(x)
            del m
    err = (outs[True] - outs[False]).abs().max().item()
    phase("slice", f"f32 logits, kernels vs plain versions: max|err| {err:.3e} "
                   f"(tol {LOGITS_TOL:g}); |logits| max {outs[False].abs().max().item():.3f}")
    if not (torch.isfinite(outs[True]).all() and err <= LOGITS_TOL):
        raise AssertionError(f"f32 logits disagree: {err}")
    return launches, img_s


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script runs only on a CUDA card")
    sys.path.insert(0, REPO)
    from vil_tpu_torch.ops.kernels import KERNELS, build

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
                   f"(nvcc {' '.join(build.NVCC_FLAGS[:2])}) in "
                   f"{time.perf_counter() - t0:.1f} s")
    log = lib_path.with_suffix(".log")
    if log.exists():
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line:
                phase("build", line.strip())

    sources = {
        "vil_attention_fwd": ("vil_tpu_torch/csrc/vil_attention_fwd.cu",
                              "vil_tpu/ops/pallas/vil_kernel.py:1086"),
        "full_attention_fwd": ("vil_tpu_torch/csrc/full_attention_fwd.cu",
                               "vil_tpu/ops/pallas/full_attention.py:127"),
    }
    records = {name: {"name": name, "route": "cuda", "source": src, "replaces": rep,
                      "launches": 0, "max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0}
               for name, (src, rep) in sources.items()}
    check_kernels(torch, records)
    launches, _ = run_slice(torch, KERNELS)
    for name, n in launches.items():
        records[name]["launches"] = n

    print(card, flush=True)
    print(json.dumps({"kernels": list(records.values())}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
