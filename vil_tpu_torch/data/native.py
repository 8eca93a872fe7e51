"""ctypes bindings of the native TSV core (``native/tsv_core.cpp``): the
counterpart of ``vil_tpu/data/native.py``.

The core is host C++ of the repository: a single-pass lineidx scanner
(``build_lineidx``, ``count_rows``), row reads by ``pread`` at a byte offset
(``tsv_open``, ``read_row``, ``tsv_close``: no shared file position, so the
loader's threads read without a lock) and a base64 decoder (``b64_decode``).
It is compiled at first use with ``g++ -O3 -shared -fPIC`` into
``build/vil_tpu_torch/``, named by a digest of the source and the flags, as
the CUDA kernels are (``ops/kernels/build.py``); nothing is compiled at
import time, and ``native/build/`` is never written.

Where the library cannot be built or loaded, ``get_lib`` returns None after
one logged warning that names the error, and the callers (``data.tsv``)
read in Python; ``vil_tpu`` falls back silently.
"""
from __future__ import annotations

import base64
import ctypes
import functools
import hashlib
import logging
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

logger = logging.getLogger(__name__)

SRC = Path(__file__).resolve().parents[2] / "native" / "tsv_core.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "vil_tpu_torch"
CXX_FLAGS = ["-O3", "-shared", "-fPIC"]
MAX_ROW_BYTES = 1 << 22  # read_row's first buffer; a longer row retries 4x larger

_c = ctypes
# restype and argtypes of every C entry point (vil_tpu/data/native.py:40-72)
SIGNATURES = {
    "build_lineidx": (_c.c_int64, [_c.c_char_p, _c.c_char_p]),
    "count_rows": (_c.c_int64, [_c.c_char_p]),
    "tsv_open": (_c.c_int, [_c.c_char_p]),
    "tsv_close": (None, [_c.c_int]),
    "read_row": (_c.c_int64, [_c.c_int, _c.c_int64, _c.c_char_p, _c.c_int64]),
    "b64_decode": (_c.c_int64, [_c.c_char_p, _c.c_int64, _c.c_char_p]),
}
_LOCK = threading.Lock()


def library_path(build_dir: Optional[Path] = None) -> Path:
    """Where the library of this source and these flags is built
    (``BUILD_DIR`` unless another directory is given)."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SRC.read_bytes())
    return Path(build_dir or BUILD_DIR) / f"libtsv_core_{h.hexdigest()[:16]}.so"


def build(build_dir: Optional[Path] = None) -> Path:
    """Compile the core unless its library exists; raise if ``g++`` fails.
    The library is written under a temporary name and renamed, so that
    processes building at once see all of it or nothing."""
    out = library_path(build_dir)
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    try:
        cmd = ["g++", *CXX_FLAGS, "-o", tmp, str(SRC)]
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
        if proc.returncode != 0:
            raise RuntimeError(f"{' '.join(cmd)} failed ({proc.returncode}): {proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


@functools.lru_cache(maxsize=None)
def _load() -> Optional[ctypes.CDLL]:
    try:
        lib = ctypes.CDLL(str(build()))
    except (OSError, RuntimeError, subprocess.SubprocessError) as e:
        logger.warning("the native TSV core is unavailable, reading TSV files in Python: %s", e)
        return None
    for name, (restype, argtypes) in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = restype, argtypes
    return lib


def get_lib() -> Optional[ctypes.CDLL]:
    """The native library, built at first use, or None (warned once)."""
    with _LOCK:
        return _load()


def build_lineidx(tsv_path: str, idx_path: str) -> bool:
    """Write the lineidx file natively; False if the caller must do it in
    Python."""
    lib = get_lib()
    if lib is None:
        return False
    tmp = idx_path + ".tmp"
    if lib.build_lineidx(tsv_path.encode(), tmp.encode()) < 0:
        raise OSError(f"build_lineidx failed on {tsv_path}")
    os.replace(tmp, idx_path)
    return True


def count_rows(tsv_path: str) -> int:
    """The number of rows (lines) of a file."""
    lib = get_lib()
    if lib is None:
        with open(tsv_path, "rb") as f:
            return sum(1 for _ in f)
    rows = lib.count_rows(tsv_path.encode())
    if rows < 0:
        raise OSError(f"count_rows failed on {tsv_path}")
    return rows


class NativeRowReader:
    """Rows of one file by ``pread`` at their byte offsets, one descriptor
    shared by every thread, each thread with a buffer of its own kept
    between rows. ``read_row`` reads as many bytes as it is allowed before
    it looks for the newline, so the first read is bounded by the row's
    length where the caller knows it (the lineidx's next offset), else by
    ``max_row_bytes`` (``vil_tpu``'s reader always reads 4 MiB into a new
    buffer: ≈ 0.5 ms a row); a row longer than the bound is read again with
    a bound four times larger, as ``vil_tpu``'s is."""

    def __init__(self, path: str, lib: ctypes.CDLL, max_row_bytes: int = MAX_ROW_BYTES):
        self._lib, self._fd = lib, -1
        self._fd = lib.tsv_open(path.encode())
        if self._fd < 0:
            raise OSError(f"cannot open {path}")
        self._cap = max_row_bytes
        self._buffers = threading.local()

    def _buffer(self, size: int):
        buf = getattr(self._buffers, "buf", None)
        if buf is None or len(buf) < size:
            buf = self._buffers.buf = ctypes.create_string_buffer(size)
        return buf

    def read(self, offset: int, length: Optional[int] = None) -> bytes:
        """The row at ``offset``, without its newline; ``length``, the row's
        bytes with its newline, bounds the first read."""
        cap = length if length is not None and length > 0 else self._cap
        while True:
            buf = self._buffer(cap)
            n = self._lib.read_row(self._fd, offset, buf, cap)
            if n == -2:
                cap *= 4
                continue
            if n < 0:
                raise OSError(f"read_row failed at offset {offset}")
            return ctypes.string_at(buf, n)

    def close(self) -> None:
        if self._fd >= 0:
            self._lib.tsv_close(self._fd)
            self._fd = -1

    def __del__(self):
        self.close()


def b64_decode(data: bytes) -> bytes:
    """Standard base64 (padding and whitespace ignored)."""
    lib = get_lib()
    if lib is None:
        return base64.b64decode(data)
    out = ctypes.create_string_buffer(3 * (len(data) // 4) + 3)
    n = lib.b64_decode(data, len(data), out)
    if n < 0:
        raise ValueError("invalid base64")
    return out.raw[:n]
