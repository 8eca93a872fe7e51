"""The port's native TSV reader (``vil_tpu_torch/data/native.py``, built
from ``native/tsv_core.cpp`` with g++) against its Python path and against
``vil_tpu``'s ``TSVFile`` and ``create_lineidx``, on the CPU: rows with
tabs, non-ASCII text, empty fields and rows past the reader's buffer,
exactly; lineidx files byte for byte; ``b64_decode`` against ``base64``;
where the library is built, and that ``native/build/libtsv_core.so`` (a
file of ``vil_tpu``) is not written.
"""
import base64
import hashlib
import logging
import os
import threading
from pathlib import Path

import numpy as np
import pytest

from vil_tpu.data import tsv as jax_tsv

from vil_tpu_torch.data import native, tsv

REPO = Path(__file__).resolve().parents[1]
TRACKED_SO = REPO / "native" / "build" / "libtsv_core.so"

ROWS = [
    ["key0", "3", "aGVsbG8="],
    ["clé-ü", '[{"class": "ß猫"}]', "x" * 100],
    ["key2", "", "  padded field  ", "last"],
    ["long", "7", "y" * (native.MAX_ROW_BYTES + 12345)],  # past the first buffer
    ["tail", "1", "end"],
]


def _write(path: Path) -> Path:
    tsv.tsv_writer(ROWS, str(path))
    os.remove(os.path.splitext(path)[0] + ".lineidx")
    return path


def _sha(path: Path) -> str:
    return hashlib.sha256(path.read_bytes()).hexdigest()


def test_rows_match_python_and_vil_tpu(tmp_path):
    path = str(_write(tmp_path / "rows.tsv"))
    ours = tsv.TSVFile(path, generate_lineidx=True)
    assert native.get_lib() is not None
    python = tsv.TSVFile(path)
    python._native = False  # the Python path
    theirs = jax_tsv.TSVFile(path)
    want = [[s.strip() for s in row] for row in ROWS]
    for i, row in enumerate(want):
        assert ours.seek(i) == python.seek(i) == theirs.seek(i) == row, i
    assert ours._native and theirs._native  # both read natively
    assert ours.num_rows() == native.count_rows(path) == len(ROWS)
    # a small first bound grows 4x until the row fits, with and without
    # the row's length (a wrong length only bounds the first read)
    small = native.NativeRowReader(path, native.get_lib(), max_row_bytes=8)
    offsets = [int(x) for x in open(ours.lineidx)]
    for i, off in enumerate(offsets):
        for length in (None, 3, 1 << 20):
            assert small.read(off, length).decode().split("\t") == [
                str(v) for v in ROWS[i]], (i, length)
    small.close()
    # the last row without its newline
    cut = tmp_path / "cut.tsv"
    cut.write_bytes(open(path, "rb").read()[:-1])
    ours, theirs = tsv.TSVFile(str(cut), generate_lineidx=True), jax_tsv.TSVFile(str(cut))
    for i, row in enumerate(want):
        assert ours.seek(i) == theirs.seek(i) == row, i


def test_threads_share_one_reader(tmp_path):
    """Eight threads seek the same TSVFile at once (no lock on the native
    path): every row read is the row at its offset."""
    rows = [[f"k{i}", str(i), "z" * (i % 97)] for i in range(400)]
    path = tmp_path / "many.tsv"
    tsv.tsv_writer(rows, str(path))
    f = tsv.TSVFile(str(path))
    bad = []

    def read(seed):
        rng = np.random.default_rng(seed)
        for i in rng.integers(0, len(rows), 500):
            if f.seek(int(i)) != rows[i]:
                bad.append(int(i))

    threads = [threading.Thread(target=read, args=(s,)) for s in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads) and not bad and f._native


@pytest.mark.parametrize("trailing_newline", [True, False])
def test_lineidx_byte_for_byte(trailing_newline, tmp_path, monkeypatch):
    text = "a\tb\n\nc\té\n" + "d" * 3000 + "\n" + ("e" if not trailing_newline else "")
    path = tmp_path / "f.tsv"
    path.write_text(text, encoding="utf-8")
    jax_tsv.create_lineidx(str(path), str(tmp_path / "theirs.lineidx"))
    tsv.create_lineidx(str(path), str(tmp_path / "native.lineidx"))
    monkeypatch.setattr(native, "get_lib", lambda: None)
    tsv.create_lineidx(str(path), str(tmp_path / "python.lineidx"))
    theirs = (tmp_path / "theirs.lineidx").read_bytes()
    assert (tmp_path / "native.lineidx").read_bytes() == theirs
    assert (tmp_path / "python.lineidx").read_bytes() == theirs


def test_b64_decode_matches_base64():
    rng = np.random.default_rng(0)
    for n in (0, 1, 2, 3, 4, 5, 57, 1000, 65537):
        raw = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        enc = base64.b64encode(raw)
        assert native.b64_decode(enc) == raw == base64.b64decode(enc), n
    with pytest.raises(ValueError):
        native.b64_decode(b"ab$d")


def test_built_under_build_and_native_build_untouched(tmp_path, monkeypatch, caplog):
    """The library is named by the source's digest under build/vil_tpu_torch/;
    a fresh build writes there and not into native/build/. Where g++ fails,
    one warning names the error and the rows come from Python."""
    before = (_sha(TRACKED_SO), TRACKED_SO.stat().st_mtime_ns)
    assert native.get_lib() is not None
    lib = native.library_path()
    assert lib.is_file() and lib.parent == REPO / "build" / "vil_tpu_torch"
    fresh = native.build(tmp_path / "fresh")
    assert fresh.parent == tmp_path / "fresh" and fresh.name == lib.name
    assert (_sha(TRACKED_SO), TRACKED_SO.stat().st_mtime_ns) == before

    monkeypatch.setattr(native, "CXX_FLAGS", ["-O3", "-shared", "-fPIC", "--no-such-flag"])
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "broken")
    native._load.cache_clear()
    try:
        with caplog.at_level(logging.WARNING, logger=native.__name__):
            assert native.get_lib() is None and native.get_lib() is None
        warned = [r for r in caplog.records if "unavailable" in r.getMessage()]
        assert len(warned) == 1 and "no-such-flag" in warned[0].getMessage()
        path = str(_write(tmp_path / "rows.tsv"))
        f = tsv.TSVFile(path, generate_lineidx=True)
        assert f.seek(1) == [s.strip() for s in ROWS[1]] and f._native is False
    finally:
        monkeypatch.undo()
        native._load.cache_clear()
    assert native.get_lib() is not None
