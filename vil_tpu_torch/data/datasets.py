"""Datasets (reference dat/loader.py:19-114 + dat/dataset/zipdata.py).

* ``SyntheticDataset`` — deterministic random images; tests/benchmarks.
* ``ZipData``          — ImageNet-in-zip with a tab-separated map file
                         (class@path<TAB>idx), per-worker ZipFile handles.
* ``ImageFolder``      — split/class_x/img.jpeg layout (torchvision-style).
* ``CIFAR10/100``      — python-pickle batch files (no torchvision).
* ``MNIST``            — idx-ubyte files.

All return (PIL image or array after transform, int target).
"""
from __future__ import annotations

import os
import os.path as op
import pickle
import struct
from io import BytesIO
from zipfile import BadZipFile, ZipFile

import numpy as np

_VALID_IMAGE_TYPES = [".jpg", ".jpeg", ".tiff", ".bmp", ".png"]


class SyntheticDataset:
    """Deterministic pseudo-random RGB images with labels."""

    def __init__(self, length=1024, image_size=224, num_classes=1000,
                 transforms=None, seed=0):
        self.length = length
        self.image_size = image_size
        self.num_classes = num_classes
        self.transforms = transforms
        self.seed = seed

    def __len__(self):
        return self.length

    def __getitem__(self, idx):
        from PIL import Image

        rng = np.random.default_rng(self.seed + idx)
        arr = rng.integers(0, 256, (self.image_size, self.image_size, 3),
                           dtype=np.uint8)
        img = Image.fromarray(arr)
        target = int(rng.integers(0, self.num_classes))
        if self.transforms is not None:
            img = self.transforms(img)
        return img, target


class ZipData:
    """Zip-of-images dataset (reference zipdata.py:10-103): map file lines
    are ``something@path<TAB>index``; per-pid ZipFile handles for workers."""

    def __init__(self, path, map_file, transforms=None, extensions=None):
        self._path = path
        extensions = extensions or _VALID_IMAGE_TYPES
        self._zip_file = ZipFile(path)
        self.zip_dict = {}
        self.samples = []
        self.transforms = transforms
        self.class_to_idx = {}
        with open(map_file, "r") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                cls_idx = [l for l in line.split("\t") if l]
                if not cls_idx:
                    continue
                assert len(cls_idx) >= 2, f"invalid line: {line}"
                idx = int(cls_idx[1])
                cls = cls_idx[0]
                at_idx = cls.find("@")
                assert at_idx >= 0, f"invalid class: {cls}"
                cls = cls[at_idx + 1:]
                if cls.startswith("/"):
                    cls = cls[1:]
                prev = self.class_to_idx.get(cls)
                assert prev is None or prev == idx
                self.class_to_idx[cls] = idx
        for fst in self._zip_file.infolist():
            fname = fst.filename
            target = self.class_to_idx.get(fname)
            if target is None:
                continue
            if fname.endswith("/") or fname.startswith(".") or fst.file_size == 0:
                continue
            if op.splitext(fname)[1].lower() in extensions:
                self.samples.append((fname, target))
        assert len(self), f"No images found in: {self._path} with map: {map_file}"

    def __len__(self):
        return len(self.samples)

    def __getstate__(self):
        # picklable for process-based loaders (Grain workers): drop the
        # open ZipFile handles; workers reopen per-pid via _zip_for_pid
        state = self.__dict__.copy()
        state["_zip_file"] = None
        state["zip_dict"] = {}
        return state

    def _zip_for_pid(self):
        pid = os.getpid()
        if pid not in self.zip_dict:
            self.zip_dict[pid] = ZipFile(self._path)
        return self.zip_dict[pid]

    def __getitem__(self, index):
        from PIL import Image

        fname, target = self.samples[index]
        zf = self._zip_for_pid()
        try:
            with zf.open(fname) as f:
                img = Image.open(BytesIO(f.read())).convert("RGB")
        except BadZipFile:
            raise RuntimeError(f"bad zip entry {fname} in {self._path}")
        if self.transforms is not None:
            img = self.transforms(img)
        return img, target


class ImageFolder:
    """split/class_name/image.* layout; classes sorted alphabetically."""

    def __init__(self, root, transforms=None, extensions=None):
        extensions = extensions or _VALID_IMAGE_TYPES
        classes = sorted(
            d for d in os.listdir(root) if op.isdir(op.join(root, d))
        )
        self.class_to_idx = {c: i for i, c in enumerate(classes)}
        self.samples = []
        for c in classes:
            cdir = op.join(root, c)
            for fname in sorted(os.listdir(cdir)):
                if op.splitext(fname)[1].lower() in extensions:
                    self.samples.append((op.join(cdir, fname), self.class_to_idx[c]))
        self.transforms = transforms

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, index):
        from PIL import Image

        path, target = self.samples[index]
        img = Image.open(path).convert("RGB")
        if self.transforms is not None:
            img = self.transforms(img)
        return img, target


class CIFAR:
    """CIFAR-10/100 from the standard python pickle batches (no download)."""

    def __init__(self, root, train=True, num_classes=10, transforms=None):
        if num_classes == 10:
            base = op.join(root, "cifar-10-batches-py")
            files = [f"data_batch_{i}" for i in range(1, 6)] if train else ["test_batch"]
            label_key = b"labels"
        else:
            base = op.join(root, "cifar-100-python")
            files = ["train"] if train else ["test"]
            label_key = b"fine_labels"
        data, labels = [], []
        for fn in files:
            with open(op.join(base, fn), "rb") as f:
                d = pickle.load(f, encoding="bytes")
            data.append(d[b"data"])
            labels.extend(d[label_key])
        self.data = np.vstack(data).reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
        self.targets = labels
        self.transforms = transforms

    def __len__(self):
        return len(self.data)

    def __getitem__(self, index):
        from PIL import Image

        img = Image.fromarray(self.data[index])
        if self.transforms is not None:
            img = self.transforms(img)
        return img, int(self.targets[index])


class MNIST:
    """MNIST from idx-ubyte files (no download)."""

    def __init__(self, root, train=True, transforms=None):
        prefix = "train" if train else "t10k"
        raw = op.join(root, "MNIST", "raw")
        if not op.isdir(raw):
            raw = root
        with open(op.join(raw, f"{prefix}-images-idx3-ubyte"), "rb") as f:
            magic, n, rows, cols = struct.unpack(">IIII", f.read(16))
            self.images = np.frombuffer(f.read(), dtype=np.uint8).reshape(n, rows, cols)
        with open(op.join(raw, f"{prefix}-labels-idx1-ubyte"), "rb") as f:
            struct.unpack(">II", f.read(8))
            self.targets = np.frombuffer(f.read(), dtype=np.uint8)
        self.transforms = transforms

    def __len__(self):
        return len(self.images)

    def __getitem__(self, index):
        from PIL import Image

        img = Image.fromarray(self.images[index], mode="L")
        if self.transforms is not None:
            img = self.transforms(img)
        return img, int(self.targets[index])


class ConcatDataset:
    def __init__(self, datasets):
        self.datasets = list(datasets)
        self.offsets = np.cumsum([len(d) for d in self.datasets])

    def __len__(self):
        return int(self.offsets[-1])

    def __getitem__(self, index):
        ds_idx = int(np.searchsorted(self.offsets, index, side="right"))
        inner = index - (self.offsets[ds_idx - 1] if ds_idx > 0 else 0)
        return self.datasets[ds_idx][int(inner)]
