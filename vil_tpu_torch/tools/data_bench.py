"""Input-pipeline throughput of the port: images decoded and augmented a
second, the counterpart of ``benchmarks/data_bench.py``.

    python -m vil_tpu_torch.tools.data_bench [--root build/data_bench]
        [--images 2048] [--img-size 256] [--batch 256] [--workers 0 4 8 16]
        [--sets tsv zip] [--seed 0] [--out data_bench.json]

Synthetic sets, made from ``--seed`` under ``--root`` (once; reused while
present): a TSV of base64 JPEGs, ImageNet-22k's format (key, label, image;
read through ``ClsTsvDataset`` from a dataset yaml), and a ZIP of the JPEGs
with its map file, ImageNet-1k's (``ZipData``). Each JPEG is a smooth random
image at ``--img-size``², quality 85, which decodes like a photograph.

The loader settings, in order: on the TSV, the threads loader with the
Python reader and with the native one (``data.native``), a thread for each
core this process may use, then DATALOADER.BACKEND 'grain' at each of
``--workers`` worker processes; on the ZIP, the threads loader and 'grain'
at each of ``--workers``. Each setting reads at ``--batch`` images a batch
through ``configs/msvit.yaml``'s train augmentation at 224² (RandAugment
rand-m9-mstd0.5-inc1, RandomErasing 0.25, flips). A loader hands each
worker process or thread a whole batch, so a pass of a few batches would
time one batch's latency under contention: each setting first reads one
shuffled pass of the set (its wait for the first batch, the worker
processes' start included, is printed as its start-up), then, its workers
kept, a timed window of several shuffled passes in a row that gives each
worker or thread at least ``WINDOW_BATCHES`` batches (and a loader without
workers as many). The files were just written, so the reads are warm.
Printed per setting: img/s over the window, the cores seen and img/s per
core; first, each TSV reader alone, µs a row; ``--out`` gets the same as
JSON.
"""
from __future__ import annotations

import argparse
import base64
import io
import json
import os
import os.path as op
import time
import zipfile

import numpy as np

from ..config import get_default_cfg
from ..data import loader
from ..data.datasets import ZipData
from ..data.grain_loader import GrainDataLoader
from ..data.transforms import build_transforms
from ..data.tsv import ClsTsvDataset, tsv_writer

REPO = op.dirname(op.dirname(op.dirname(op.abspath(__file__))))
RECIPE = op.join(REPO, "configs", "msvit.yaml")
TSV_YAML = "imagenet22k_synthetic.yaml"  # the name selects ClsTsvDataset
NUM_CLASSES = 100
WINDOW_BATCHES = 4  # batches a worker or thread takes in the timed window


def cores() -> int:
    """The host cores this process may run on."""
    return len(os.sched_getaffinity(0))


def host() -> str:
    """The cores seen, the hardware threads a core (from sysfs) and the
    cgroup's CPU quota where one is set: what bounds the worker processes."""
    def read(path):
        try:
            with open(path) as f:
                return f.read().strip()
        except OSError:
            return ""

    siblings = read("/sys/devices/system/cpu/cpu0/topology/thread_siblings_list")
    per_core = len([c for part in siblings.split(",") if part
                    for c in (range(int(part.split("-")[0]), int(part.split("-")[-1]) + 1))])
    quota = read("/sys/fs/cgroup/cpu.max").split()
    limit = (f"{int(quota[0]) / int(quota[1]):g} cores" if len(quota) == 2 and quota[0] != "max"
             else "none")
    return (f"{cores()} cores seen, {per_core or 'unknown'} hardware threads a core, cgroup "
            f"quota {limit}")


def random_jpeg(rng: np.random.Generator, size: int) -> bytes:
    """A smooth random RGB image at size², JPEG at quality 85."""
    from PIL import Image

    small = rng.integers(0, 256, (size // 8, size // 8, 3), dtype=np.uint8)
    img = Image.fromarray(small).resize((size, size), Image.BILINEAR)
    buf = io.BytesIO()
    img.save(buf, format="JPEG", quality=85)
    return buf.getvalue()


def make_tsv(root: str, n: int, size: int, seed: int) -> str:
    """``root``'s TSV set of ``n`` images: the dataset yaml's path."""
    yaml_path = op.join(root, TSV_YAML)
    if not op.isfile(yaml_path):
        os.makedirs(root, exist_ok=True)
        rng = np.random.default_rng(seed)
        tsv_writer(([f"img{i}", str(i % NUM_CLASSES),
                     base64.b64encode(random_jpeg(rng, size)).decode()] for i in range(n)),
                   op.join(root, "train.tsv"))
        with open(yaml_path, "w") as f:
            f.write("img: train.tsv\n")
    return yaml_path


def make_zip(root: str, n: int, size: int, seed: int) -> tuple[str, str]:
    """``root``'s ZIP set of ``n`` images: (zip path, map file path)."""
    zpath, mpath = op.join(root, "train.zip"), op.join(root, "train_map.txt")
    if not (op.isfile(zpath) and op.isfile(mpath)):
        os.makedirs(root, exist_ok=True)
        rng = np.random.default_rng(seed + 1)
        with zipfile.ZipFile(zpath + ".tmp", "w", zipfile.ZIP_STORED) as zf, \
                open(mpath, "w") as mf:
            for i in range(n):
                name = f"img_{i:06d}.jpg"
                zf.writestr(name, random_jpeg(rng, size))
                mf.write(f"x@{name}\t{i % NUM_CLASSES}\n")
        os.replace(zpath + ".tmp", zpath)
    return zpath, mpath


def train_transform(img_size: int = 224):
    """configs/msvit.yaml's train augmentation at ``img_size``²."""
    cfg = get_default_cfg()
    cfg.merge_from_file(RECIPE)
    cfg.merge_from_list(["INPUT.IMAGE_SIZE", str(img_size)])
    return build_transforms(cfg, is_train=True)


def tsv_dataset(yaml_path: str, transforms, native_reader: bool = True) -> ClsTsvDataset:
    args, _ = loader.config_tsv_dataset_args(None, yaml_path)
    dataset = ClsTsvDataset(transforms=transforms, **args)
    if not native_reader:
        dataset.img_tsv._native = False  # the Python reader
    return dataset


def reader_us(yaml_path: str, native_reader: bool) -> float:
    """Microseconds a row of the TSV reader alone: every row read once, in
    order, on one thread (after one read of the file to warm it)."""
    rows = tsv_dataset(yaml_path, None, native_reader).img_tsv
    n = rows.num_rows()
    for i in range(n):
        rows.seek(i)
    t0 = time.perf_counter()
    for i in range(n):
        rows.seek(i)
    return (time.perf_counter() - t0) / n * 1e6


class Passes:
    """A sampler: ``passes`` shuffled passes over ``n`` indices in a row, drawn
    from ``seed``, so that one loader pass holds many batches."""

    def __init__(self, n: int, seed: int):
        self.n, self.seed, self.passes = n, seed, 1

    def __iter__(self):
        rng = np.random.default_rng(self.seed)
        for _ in range(self.passes):
            yield from rng.permutation(self.n).tolist()

    def __len__(self) -> int:
        return self.n * self.passes


def _pass(batches) -> tuple[int, float, float]:
    """(images, seconds to the first batch, seconds) of one whole pass."""
    t0 = time.perf_counter()
    first, images = None, 0
    for x, _ in batches:
        first = first or time.perf_counter() - t0
        images += len(x)
    return images, first, time.perf_counter() - t0


def measure(dataset, batch: int, backend: str, workers: int, seed: int = 0) -> dict:
    """One shuffled pass for the start-up (the worker processes' start and
    one batch), then the timed window, its workers kept: passes enough for
    ``WINDOW_BATCHES`` batches a worker or thread, timed from the window's
    start to its last batch."""
    order = Passes(len(dataset), seed)
    cls = GrainDataLoader if backend == "grain" else loader.DataLoader
    batches = cls(dataset, order, batch, drop_last=True, num_workers=workers)
    _, startup, _ = _pass(batches)
    order.passes = -(-WINDOW_BATCHES * max(workers, 1) * batch // len(dataset))
    images, _, seconds = _pass(batches)
    del batches  # the grain loader's worker processes end with it
    return {"img_s": images / seconds, "images": images, "batches": images // batch,
            "seconds": seconds, "startup_s": startup}


def run(root: str, images: int = 2048, img_size: int = 256, batch: int = 256,
        workers=(0, 4, 8, 16), sets=("tsv", "zip"), seed: int = 0,
        report=print, readers=("python", "native")) -> list[dict]:
    """Every loader setting of ``sets``; ``report`` gets a line each. The
    threads loader reads a TSV through each of ``readers`` (the Python
    reader, the native one)."""
    threads = cores()
    transform = train_transform()
    settings = []
    if "tsv" in sets:
        yaml_path = make_tsv(root, images, img_size, seed)
        settings += [("tsv", "threads", reader, threads,
                      lambda native=reader == "native": tsv_dataset(yaml_path, transform,
                                                                    native_reader=native))
                     for reader in readers]
        settings += [("tsv", "grain", "native", w, lambda: tsv_dataset(yaml_path, transform))
                     for w in workers]
    if "zip" in sets:
        zpath, mpath = make_zip(root, images, img_size, seed)
        make = lambda: ZipData(zpath, mpath, transform)  # noqa: E731
        settings += [("zip", "threads", "zip", threads, make)]
        settings += [("zip", "grain", "zip", w, make) for w in workers]
    results = []
    report(f"host: {host()}")
    if "tsv" in sets:
        for native_reader in (False, True):
            us = reader_us(yaml_path, native_reader)
            reader = "native" if native_reader else "python"
            results.append(dict(set="tsv", reader=reader, us_per_row=us))
            report(f"tsv {reader} reader alone: {us:.1f} us a row (one thread, warm)")
    for data, backend, reader, count, make in settings:
        res = dict(set=data, backend=backend, reader=reader, workers=count, batch=batch,
                   cores=cores(), **measure(make(), batch, backend, count, seed))
        res["img_s_per_core"] = res["img_s"] / res["cores"]
        results.append(res)
        report(f"{data} {backend} ({reader} reader, {count} "
               f"{'threads' if backend == 'threads' else 'workers'}): {res['img_s']:.1f} img/s "
               f"at batch {batch} ({res['img_s_per_core']:.1f} a core of {res['cores']}; "
               f"{res['images']} images, {res['batches']} batches, in {res['seconds']:.2f} s; "
               f"start-up {res['startup_s']:.2f} s)")
    return results


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=op.join(REPO, "build", "data_bench"))
    ap.add_argument("--images", type=int, default=2048)
    ap.add_argument("--img-size", type=int, default=256, help="stored JPEG side")
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--workers", type=int, nargs="+", default=[0, 4, 8, 16])
    ap.add_argument("--sets", nargs="+", default=["tsv", "zip"], choices=["tsv", "zip"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    results = run(args.root, args.images, args.img_size, args.batch, tuple(args.workers),
                  tuple(args.sets), args.seed)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    return results


if __name__ == "__main__":
    main()
