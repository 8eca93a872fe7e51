"""TSV storage stack (reference dat/dataset/tsv_dataset.py, cls_tsv.py,
utils/tsv_file.py, utils/tsv_file_ops.py — SURVEY §2.15).

Random-access TSV-of-base64-images with ``.lineidx`` byte-offset sidecars,
plus the offline manipulation toolkit (writer, labelmap/linelist/hw
generation). File formats are byte-compatible with the reference so existing
datasets load unchanged. Worker-fork safety follows the reference's
pid-checked reopen (tsv_file.py:38-41).

A copy of ``vil_tpu/data/tsv.py``'s Python path. ``vil_tpu`` tries its
native C++ scanner and row reader (``vil_tpu/data/native.py``) first and
falls back to this path on any exception; the port reads in Python only
(the native reader is ROADMAP §A, A6). One file handle is shared by the
loader's threads, so a seek and its read hold a lock.
"""
from __future__ import annotations

import base64
import json
import os
import os.path as op
import threading
from io import BytesIO
from typing import Iterable, Optional

import numpy as np


def create_lineidx(filein: str, idxout: str) -> None:
    """Write byte offsets of each line (reference tsv_file.py:7-16)."""
    idxout_tmp = idxout + ".tmp"
    with open(filein, "rb") as fin, open(idxout_tmp, "w") as fout:
        fsize = os.fstat(fin.fileno()).st_size
        fpos = 0
        while fpos != fsize:
            fout.write(str(fpos) + "\n")
            fin.readline()
            fpos = fin.tell()
    os.rename(idxout_tmp, idxout)


class TSVFile:
    """Random-access TSV reader keyed by a .lineidx offset file."""

    def __init__(self, tsv_file: str, generate_lineidx: bool = False):
        self.tsv_file = tsv_file
        self.lineidx = op.splitext(tsv_file)[0] + ".lineidx"
        self._fp = None
        self._lineidx = None
        self._lock = threading.Lock()
        self.pid = None
        if not op.isfile(self.lineidx) and generate_lineidx:
            create_lineidx(self.tsv_file, self.lineidx)

    def __del__(self):
        if self._fp:
            self._fp.close()

    def __getstate__(self):
        # picklable for process-based loaders: drop the open file handle
        # and the lock; the handle lazily reopens in the worker
        # (_ensure_open is pid-aware)
        state = self.__dict__.copy()
        state["_fp"] = None
        state["pid"] = None
        del state["_lock"]
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._lock = threading.Lock()

    def num_rows(self) -> int:
        self._ensure_lineidx()
        return len(self._lineidx)

    def __len__(self) -> int:
        return self.num_rows()

    def seek(self, idx: int) -> list[str]:
        self._ensure_lineidx()
        with self._lock:  # the loader's threads share the file position
            self._ensure_open()
            self._fp.seek(self._lineidx[idx])
            line = self._fp.readline()
        return [s.strip() for s in line.split("\t")]

    def seek_first_column(self, idx: int) -> str:
        return self.seek(idx)[0]

    def __getitem__(self, idx: int) -> list[str]:
        return self.seek(idx)

    def _ensure_lineidx(self):
        if self._lineidx is None:
            with open(self.lineidx, "r") as f:
                self._lineidx = [int(i.strip()) for i in f]

    def _ensure_open(self):
        # re-open after fork: loader workers each need their own handle
        if self._fp is None or self.pid != os.getpid():
            self._fp = open(self.tsv_file, "r")
            self.pid = os.getpid()


def tsv_writer(values: Iterable[Iterable], tsv_file: str, sep: str = "\t") -> None:
    """Write rows + lineidx atomically (reference tsv_file_ops.py:34-63)."""
    os.makedirs(op.dirname(tsv_file) or ".", exist_ok=True)
    lineidx_file = op.splitext(tsv_file)[0] + ".lineidx"
    tsv_tmp, idx_tmp = tsv_file + ".tmp", lineidx_file + ".tmp"
    idx = 0
    with open(tsv_tmp, "w") as fp, open(idx_tmp, "w") as fpidx:
        for value in values:
            assert value is not None
            row = sep.join(
                v.decode() if isinstance(v, bytes) else str(v) for v in value
            ) + "\n"
            fp.write(row)
            fpidx.write(str(idx) + "\n")
            idx += len(row)
    os.replace(tsv_tmp, tsv_file)
    os.replace(idx_tmp, lineidx_file)


def tsv_reader(tsv_file: str, sep: str = "\t"):
    with open(tsv_file, "r") as fp:
        for line in fp:
            yield [x.strip() for x in line.split(sep)]


def img_from_base64(imagestring: str):
    """base64 string → PIL RGB image (reference tsv_dataset.py:57-63)."""
    from PIL import Image

    jpgbytestring = base64.b64decode(imagestring)
    return Image.open(BytesIO(jpgbytestring)).convert("RGB")


def encode_image_to_base64(img, format: str = "JPEG") -> str:
    buf = BytesIO()
    img.save(buf, format=format)
    return base64.b64encode(buf.getvalue()).decode()


def load_linelist_file(linelist_file: Optional[str]):
    if linelist_file is None:
        return None
    with open(linelist_file, "r") as f:
        return [int(l.strip()) for l in f if l.strip()]


def load_labelmap_file(labelmap_file: Optional[str]):
    if labelmap_file is None or not op.isfile(labelmap_file):
        return None
    label_dict = {}
    with open(labelmap_file, "r") as f:
        for line in f:
            label = line.strip().split("\t")[0]
            if label in label_dict:
                raise ValueError(f"duplicate label {label} in labelmap")
            label_dict[label] = len(label_dict)
    return label_dict


def generate_labelmap_file(label_file: str, save_file: Optional[str] = None) -> str:
    """Collect the class set from a label TSV (tsv_file_ops parity)."""
    rows = tsv_reader(label_file)
    labelmap = []
    for row in rows:
        labelmap.extend(
            set(r["class"] for r in json.loads(row[1])) - set(labelmap)
        )
    save_file = save_file or op.splitext(label_file)[0] + ".labelmap"
    with open(save_file, "w") as f:
        f.write("\n".join(sorted(labelmap)))
    return save_file


def generate_linelist_file(
    label_file: str, save_file: Optional[str] = None, ignore_attrs=()
) -> str:
    """Rows with at least one non-ignored ground truth (tsv_file_ops parity)."""
    line_list = []
    rows = tsv_reader(label_file)
    for i, row in enumerate(rows):
        labels = json.loads(row[1])
        if labels:
            if isinstance(labels, list):
                labels = [
                    lab for lab in labels
                    if not any(lab.get(attr, False) for attr in ignore_attrs)
                ]
                if labels:
                    line_list.append([i])
            else:
                line_list.append([i])
    save_file = save_file or op.splitext(label_file)[0] + ".linelist"
    tsv_writer(line_list, save_file)
    return save_file


def generate_hw_file(img_file: str, save_file: Optional[str] = None) -> str:
    """Per-image [height, width] sidecar (tsv_file_ops parity)."""
    tsv = TSVFile(img_file, generate_lineidx=True)
    rows = []
    for i in range(tsv.num_rows()):
        key, *cols = tsv.seek(i)
        img = img_from_base64(cols[-1])
        rows.append([key, json.dumps([{"height": img.size[1], "width": img.size[0]}])])
    save_file = save_file or op.splitext(img_file)[0] + ".hw.tsv"
    tsv_writer(rows, save_file)
    return save_file


def extract_column(tsv_file: str, col: int = 1,
                   save_file: Optional[str] = None) -> str:
    """Keep [key, row[col]] per row (tsv_file_ops.py:105-114 parity)."""
    save_file = save_file or op.splitext(tsv_file)[0] + f".col.{col}.tsv"
    tsv_writer(
        ([row[0], row[col]] for row in tsv_reader(tsv_file)), save_file
    )
    return save_file


def remove_column(tsv_file: str, col: int = 1,
                  save_file: Optional[str] = None) -> str:
    """Drop column ``col`` from every row (tsv_file_ops.py:117-125)."""

    def rows():
        for row in tsv_reader(tsv_file):
            yield row[:col] + row[col + 1:]

    save_file = save_file or op.splitext(tsv_file)[0] + f".remove.{col}.tsv"
    tsv_writer(rows(), save_file)
    return save_file


def merge_two_label_files(label_file1: str, label_file2: str,
                          save_file: Optional[str] = None) -> str:
    """Concatenate the per-row JSON label lists of two key-aligned label
    TSVs (tsv_file_ops.py:183-194)."""

    def rows():
        for row1, row2 in zip(tsv_reader(label_file1),
                              tsv_reader(label_file2)):
            assert row1[0] == row2[0], (row1[0], row2[0])
            yield [row1[0], json.dumps(json.loads(row1[1])
                                       + json.loads(row2[1]))]

    save_file = save_file or op.splitext(label_file1)[0] + ".merge.tsv"
    tsv_writer(rows(), save_file)
    return save_file


def merge_label_fields(in_tsv1: str, in_tsv2: str, out_tsv: str) -> str:
    """Merge the per-box label dict fields of two key- and box-aligned
    label TSVs (tsv_file_ops.py:266-277)."""

    def rows():
        for row1, row2 in zip(tsv_reader(in_tsv1), tsv_reader(in_tsv2)):
            assert row1[0] == row2[0], (row1[0], row2[0])
            labs1, labs2 = json.loads(row1[1]), json.loads(row2[1])
            assert len(labs1) == len(labs2)
            for lab1, lab2 in zip(labs1, labs2):
                lab1.update(lab2)
            yield [row1[0], json.dumps(labs1)]

    tsv_writer(rows(), out_tsv)
    return out_tsv


def remove_label_fields(in_tsv: str, out_tsv: str, remove_fields) -> str:
    """Delete the named fields from every box's label dict
    (tsv_file_ops.py:280-292)."""
    if isinstance(remove_fields, str):
        remove_fields = [remove_fields]

    def rows():
        for row in tsv_reader(in_tsv):
            labels = json.loads(row[1])
            for lab in labels:
                for field in remove_fields:
                    lab.pop(field, None)
            yield [row[0], json.dumps(labels)]

    tsv_writer(rows(), out_tsv)
    return out_tsv


def is_same_keys_for_files(tsv_file1: str, tsv_file2: str,
                           linelist_file1: Optional[str] = None,
                           linelist_file2: Optional[str] = None) -> bool:
    """Whether two TSVs carry identical keys row-for-row (under optional
    linelists) — tsv_file_ops.py:197-213."""
    tsv1 = TSVFile(tsv_file1, generate_lineidx=True)
    tsv2 = TSVFile(tsv_file2, generate_lineidx=True)
    ll1 = load_linelist_file(linelist_file1) or list(range(tsv1.num_rows()))
    ll2 = load_linelist_file(linelist_file2) or list(range(tsv2.num_rows()))
    assert len(ll1) == len(ll2)
    return all(
        tsv1.seek(i1)[0] == tsv2.seek(i2)[0] for i1, i2 in zip(ll1, ll2)
    )


def reorder_tsv_keys(in_tsv_file: str, ordered_keys, out_tsv_file: str) -> str:
    """Rewrite ``in_tsv_file`` with its rows in ``ordered_keys`` order
    (tsv_file_ops.py:236-244)."""
    tsv = TSVFile(in_tsv_file, generate_lineidx=True)
    key_to_idx = {tsv.seek(i)[0]: i for i in range(tsv.num_rows())}
    tsv_writer(
        (tsv.seek(key_to_idx[key]) for key in ordered_keys), out_tsv_file
    )
    return out_tsv_file


def sort_file_based_on_keys(ref_file: str, tsv_file: str,
                            save_file: Optional[str] = None) -> str:
    """Reorder ``tsv_file`` so its row keys match ``ref_file``'s
    (tsv_file_ops.py:216-233). No-op (returns ``tsv_file``) when the keys
    already agree."""
    if is_same_keys_for_files(ref_file, tsv_file):
        return tsv_file
    save_file = save_file or op.splitext(tsv_file)[0] + ".sorted.tsv"
    ordered = [row[0] for row in tsv_reader(ref_file)]
    return reorder_tsv_keys(tsv_file, ordered, save_file)


class TSVDataset:
    """Image TSV + optional label/hw/linelist sidecars
    (reference tsv_dataset.py:14-100)."""

    def __init__(self, img_file, label_file=None, hw_file=None,
                 linelist_file=None, labelmap_file=None, transforms=None):
        self.img_tsv = TSVFile(img_file, generate_lineidx=True)
        self.label_tsv = None if label_file is None else TSVFile(label_file, True)
        self.hw_tsv = None if hw_file is None else TSVFile(hw_file, True)
        self.line_list = load_linelist_file(linelist_file)
        self.labelmap = load_labelmap_file(labelmap_file)
        self.transforms = transforms

    def __len__(self):
        if self.line_list is None:
            return self.img_tsv.num_rows()
        return len(self.line_list)

    def _line(self, idx):
        if self.line_list is None:
            return idx
        line = self.line_list[idx]
        return line[0] if isinstance(line, list) else line

    def get_image(self, idx):
        row = self.img_tsv.seek(self._line(idx))
        return img_from_base64(row[-1])

    def get_annotations(self, idx):
        src = self.label_tsv if self.label_tsv is not None else self.img_tsv
        row = src.seek(self._line(idx))
        return json.loads(row[1])

    def get_target(self, idx):
        anno = self.get_annotations(idx)
        if isinstance(anno, list):
            label = anno[0]["class"]
            if self.labelmap is not None:
                return self.labelmap[label]
            return int(label)
        return int(anno)

    def get_img_key(self, idx):
        return self.img_tsv.seek(self._line(idx))[0]

    def __getitem__(self, idx):
        img = self.get_image(idx)
        target = self.get_target(idx)
        if self.transforms is not None:
            img = self.transforms(img)
        return img, target


class ClsTsvDataset(TSVDataset):
    """Classification TSV where col1 is the integer (or json) label directly
    (reference cls_tsv.py:9-31, used for ImageNet-22K)."""

    def get_target(self, idx):
        row = self.img_tsv.seek(self._line(idx))
        try:
            return int(row[1])
        except ValueError:
            anno = json.loads(row[1])
            if isinstance(anno, list):
                anno = anno[0]["class"]
            return int(anno)
