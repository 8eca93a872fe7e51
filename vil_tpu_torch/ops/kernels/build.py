"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` file is compiled by ``nvcc`` for Hopper (``sm_90a``)
into one shared library with a plain C interface, which is loaded with
``ctypes``. Pointers and the CUDA stream are passed as ``c_void_p``, sizes as
``c_int``; each entry point returns the ``cudaError_t`` of its launch.

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

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "vil_tpu_torch"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
]

_P, _I = ctypes.c_void_p, ctypes.c_int
# argtypes of every C entry point, in the order of its C signature
SIGNATURES = {
    # q, k, v, k_glo, v_glo, bias, mask, out,
    # B, mx, my, w2, C, H, nglo, wq, is_bf16, stream
    "vil_attention_fwd": [_P] * 8 + [_I] * 9 + [_P],
    # q, k, v, bias, out, B, N, C, H, is_bf16, stream
    "full_attention_fwd": [_P] * 5 + [_I] * 5 + [_P],
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

    The compiler's report (``-Xptxas -v``: registers, shared memory and
    spills of every kernel) is kept beside the library, with suffix .log."""
    out = BUILD_DIR / f"libvil_tpu_torch_{_digest()}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", tmp,
           *map(str, _sources())]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
            f"{proc.stdout}{proc.stderr}"
        )
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)  # atomic: a concurrent build sees all or nothing
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


def check(err: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error for its launch."""
    if err != 0:
        msg = load().vil_cuda_error_string(err).decode()
        raise RuntimeError(f"{name}: launch failed with CUDA error {err}: {msg}")
