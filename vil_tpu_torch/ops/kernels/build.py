"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` file is compiled by its own ``nvcc`` for Hopper
(``sm_90a``), all at once, and the objects are linked into one shared
library with a plain C interface, which is loaded with ``ctypes``. Pointers
and the CUDA stream are passed as ``c_void_p``, sizes as ``c_int``; each
entry point returns the ``cudaError_t`` of its launch.

The library is built at first use under ``build/vil_tpu_torch/`` beside the
package, named by a hash of the sources and flags, so an edited kernel is
rebuilt and an unchanged one is not. Nothing is compiled at import time.
There is no fallback: if ``nvcc`` is missing or the build fails, ``load``
raises.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "vil_tpu_torch"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
]

_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_int64
# argtypes of every C entry point, in the order of its C signature
SIGNATURES = {
    # x, gamma, beta, y, rows, C, eps, is_bf16, stream
    "layer_norm_fwd": [_P] * 4 + [_I] * 2 + [_F, _I, _P],
    # x, gamma, dy, dx, part, out, rows, C, eps, blocks, rows_per_block,
    # is_bf16, stream
    "layer_norm_bwd": [_P] * 6 + [_I] * 2 + [_F] + [_I] * 3 + [_P],
    # x, wq, wk, wv, bq, bk, bv, wo, bo, k_glo, v_glo, bias, mask, q, k, v,
    # attn, y, lse, B, mx, my, w2, C, H, nglo, wq_rows, is_bf16, bf16_exp, stream
    "vil_block_fwd": [_P] * 19 + [_I] * 10 + [_P],
    # x, wq, wk, wv, wo, k_glo, v_glo, bias, mask, q, k, v, attn, g, lse,
    # dattn, delta, dq, dk, dv, p_glo, ds_glo, dbias_part, dkg, dvg, part,
    # grads, dx, B, mx, my, w2, C, H, nglo, wq_rows, slices, rows_per_slice,
    # is_bf16, bf16_exp, stream
    "vil_block_bwd": [_P] * 28 + [_I] * 12 + [_P],
    # q, k, v, k_glo, v_glo, bias, mask, out, lse,
    # B, mx, my, w2, C, H, nglo, wq, is_bf16, bf16_exp, stream (bf16_exp:
    # vil_tpu's BF16_EXP for the bf16 kernels, vil_attention.bf16_exp())
    "vil_attention_fwd": [_P] * 9 + [_I] * 10 + [_P],
    # q, k, v, k_glo, v_glo, g, out, bias, mask, lse, delta, dq, dk, dv,
    # p_glo, ds_glo, dbias_part, B, mx, my, w2, C, H, nglo, wq,
    # chunks_per_block, is_bf16, bf16_exp, stream
    "vil_attention_bwd": [_P] * 17 + [_I] * 11 + [_P],
    # the same as vil_attention_fwd / _bwd (the backward with out after g,
    # without chunks_per_block) with the sampled chunk's offset dx, dy before
    # is_bf16
    "vil_mode_attention_fwd": [_P] * 9 + [_I] * 12 + [_P],
    "vil_mode_attention_bwd": [_P] * 17 + [_I] * 12 + [_P],
    # the self-only (mode -1) instances: vil_mode_attention_fwd / _bwd's
    # signatures without the offset
    "vil_self_attention_fwd": [_P] * 9 + [_I] * 10 + [_P],
    "vil_self_attention_bwd": [_P] * 17 + [_I] * 10 + [_P],
    # the same as vil_attention_fwd / _bwd (without chunks_per_block), with
    # k, v (and dk, dv) of mx + 2 chunk rows
    "vil_attention_halo_fwd": [_P] * 9 + [_I] * 10 + [_P],
    "vil_attention_halo_bwd": [_P] * 17 + [_I] * 10 + [_P],
    # the sampled-neighbour halo forms (B5h, B6h): vil_mode_attention_fwd /
    # _bwd's signatures, with k, v (and dk, dv) of mx + 2 chunk rows
    "vil_mode_attention_halo_fwd": [_P] * 9 + [_I] * 12 + [_P],
    "vil_mode_attention_halo_bwd": [_P] * 17 + [_I] * 12 + [_P],
    # P's strided path: x, y, the 5 sizes of the layout, x's and y's 5
    # strides (elements), is_bf16, stream; one entry point per layout
    "layout_probe_base": [_P] * 2 + [_L] * 15 + [_I, _P],
    "layout_probe_perm": [_P] * 2 + [_L] * 15 + [_I, _P],
    # P's dense path: x, y, n, is_bf16, stream
    "layout_probe_flat": [_P] * 2 + [_L, _I, _P],
    # q, k, v, bias, out, lse, B, N, C, H, is_bf16, stream
    "full_attention_fwd": [_P] * 6 + [_I] * 5 + [_P],
    # q, k, v, g, out, bias, lse, delta, dq, dk, dv, dbias_part,
    # B, N, C, H, per_group, is_bf16, stream
    "full_attention_bwd": [_P] * 12 + [_I] * 6 + [_P],
}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile ``csrc/*.cu`` unless the library for these sources exists.

    One ``nvcc -c`` per source, all started together, then one link. The
    compilers' reports (``-Xptxas -v``: registers, shared memory and spills
    of every kernel) are kept beside the library, with suffix .log."""
    out = BUILD_DIR / f"libvil_tpu_torch_{_digest()}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp_dir = Path(tempfile.mkdtemp(dir=BUILD_DIR))
    try:
        nvcc = _nvcc()
        jobs = []
        for src in _sources():
            obj = tmp_dir / (src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o", str(obj), str(src)]
            jobs.append((cmd, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        log, failed = [], []
        for cmd, _, proc in jobs:
            text = proc.communicate()[0]
            log.append(text)
            if proc.returncode != 0:
                failed.append(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{text}")
        if failed:
            raise RuntimeError("\n".join(failed))
        lib = tmp_dir / out.name
        cmd = [nvcc, *NVCC_FLAGS, "-shared", "-o", str(lib), *(str(o) for _, o, _ in jobs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                               f"{proc.stdout}{proc.stderr}")
        out.with_suffix(".log").write_text("".join(log))
        os.replace(lib, out)  # atomic: a concurrent build sees all or nothing
    finally:
        shutil.rmtree(tmp_dir, ignore_errors=True)
    return out


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed (once per process)."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.vil_cuda_error_string.argtypes = [ctypes.c_int]
    lib.vil_cuda_error_string.restype = ctypes.c_char_p
    return lib


def stream(device) -> int:
    """The raw handle of the current CUDA stream of ``device``: the accessor
    PyTorch's own generated kernels launch with. ``torch.cuda.current_stream()``
    builds a Stream object under a device context on every call, the largest
    host cost of a short launch."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def check(err: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error for its launch."""
    if err != 0:
        msg = load().vil_cuda_error_string(err).decode()
        raise RuntimeError(f"{name}: launch failed with CUDA error {err}: {msg}")
