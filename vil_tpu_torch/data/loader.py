"""Data loader factory (reference dat/loader.py:19-168).

A copy of ``vil_tpu/data/loader.py``. ``make_epoch_data_loader(cfg,
is_train, ...)`` builds datasets from DATA.TRAIN/DATA.TEST names ('imagenet'
zip layout, '*.yaml' TSV datasets, 'imagenet_folder', 'synthetic', 'mnist',
'cifar', 'cifar100'), wraps them in a sampler and returns an iterable of
(images NHWC float32, or uint8 under INPUT.DEVICE_NORMALIZE, targets int32)
numpy batches with thread-pool prefetching — the reference's worker
processes become threads here since the decode path releases the GIL in PIL
and the consumer is a CUDA step, which copies each batch to the card itself.
In a multi-process run (``is_distributed``) each data replica reads its
shard of the dataset (``num_replicas`` the size of the mesh's data axis,
``rank`` the replica's index, so the spatial ranks of one replica read the
same images) and the batch is the global one divided by the replicas.
DATALOADER.BACKEND 'grain' selects ``grain_loader.GrainDataLoader``, the
same batches assembled in worker processes.
"""
from __future__ import annotations

import logging
import os
import os.path as op
import queue
import threading
from typing import Iterator

import numpy as np

from . import datasets as D
from . import samplers as S
from .transforms import build_transforms
from .tsv import ClsTsvDataset, TSVDataset


def config_tsv_dataset_args(cfg, dataset_file):
    """Reference config_args.py:6-17: choose TSV dataset class + files from
    a .yaml dataset description."""
    import yaml

    with open(dataset_file, "r") as f:
        desc = yaml.safe_load(f)
    root = op.dirname(dataset_file)

    def _p(key):
        v = desc.get(key, None)
        if v is None:
            return None
        return v if op.isabs(v) else op.join(root, v)

    args = dict(
        img_file=_p("img") or _p("img_file"),
        label_file=_p("label") or _p("label_file"),
        hw_file=_p("hw") or _p("hw_file"),
        linelist_file=_p("linelist") or _p("linelist_file"),
        labelmap_file=_p("labelmap") or _p("labelmap_file"),
    )
    # ImageNet-22K-style pure-classification TSVs use ClsTsvDataset
    # (reference config_args.py:14-15)
    name = "ClsTsvDataset" if "imagenet22k" in dataset_file else "TSVDataset"
    return args, name


def build_dataset(cfg, is_train: bool = True):
    """Reference build_dataset (loader.py:19-114)."""
    datasets = []
    names = cfg.DATA.TRAIN if is_train else cfg.DATA.TEST
    for dataset_name in names:
        transforms = build_transforms(cfg, is_train)
        if dataset_name.endswith(".yaml"):
            args, cls_name = config_tsv_dataset_args(
                cfg, op.join(cfg.DATA.PATH, dataset_name)
                if not op.isabs(dataset_name) else dataset_name
            )
            cls = ClsTsvDataset if cls_name == "ClsTsvDataset" else TSVDataset
            dataset = cls(transforms=transforms, **args)
        elif dataset_name == "imagenet":
            split = "train" if is_train else "val"
            datapath = op.join(cfg.DATA.PATH, f"{split}.zip")
            data_map = op.join(cfg.DATA.PATH, f"{split}_map.txt")
            if op.isfile(datapath):
                dataset = D.ZipData(datapath, data_map, transforms)
            else:  # fall back to a directory layout
                dataset = D.ImageFolder(op.join(cfg.DATA.PATH, split), transforms)
        elif dataset_name == "imagenet_folder":
            split = "train" if is_train else "val"
            dataset = D.ImageFolder(op.join(cfg.DATA.PATH, split), transforms)
        elif dataset_name == "synthetic":
            dataset = D.SyntheticDataset(
                length=cfg.DATALOADER.BSZ * 8,
                image_size=cfg.INPUT.IMAGE_SIZE,
                num_classes=cfg.DATA.NUM_CLASSES,
                transforms=transforms,
            )
        elif dataset_name == "mnist":
            dataset = D.MNIST(cfg.DATA.PATH, train=is_train, transforms=transforms)
        elif dataset_name == "cifar":
            dataset = D.CIFAR(cfg.DATA.PATH, train=is_train, num_classes=10,
                              transforms=transforms)
        elif dataset_name == "cifar100":
            dataset = D.CIFAR(cfg.DATA.PATH, train=is_train, num_classes=100,
                              transforms=transforms)
        else:
            raise ValueError(f"Unimplemented dataset: {dataset_name}")
        datasets.append(dataset)

    if not is_train:
        return datasets
    return [datasets[0] if len(datasets) == 1 else D.ConcatDataset(datasets)]


def batch_indices(sampler, batch_size: int, drop_last: bool):
    """The sampler's order cut into batches of indices; a short last batch
    is dropped under ``drop_last``."""
    idxs = list(sampler)
    for i in range(0, len(idxs), batch_size):
        batch = idxs[i : i + batch_size]
        if drop_last and len(batch) < batch_size:
            return
        yield batch


def collate(samples, batch_idxs=None, return_indices: bool = False):
    """One batch of (image, target) samples: (images NHWC, targets int32[,
    dataset indices int64])."""
    # uint8 images (INPUT.DEVICE_NORMALIZE) stay uint8: the model
    # normalises them on the device (vil_tpu's copy casts them to f32)
    imgs = np.stack([np.asarray(s[0]) for s in samples])
    if imgs.dtype != np.uint8:
        imgs = imgs.astype(np.float32, copy=False)
    targets = np.asarray([s[1] for s in samples], dtype=np.int32)
    if imgs.ndim == 3:  # grayscale H,W -> H,W,1
        imgs = imgs[..., None]
    if return_indices:
        return imgs, targets, np.asarray(batch_idxs, dtype=np.int64)
    return imgs, targets


class DataLoader:
    """Batching iterator with background prefetch threads."""

    def __init__(self, dataset, sampler, batch_size: int, drop_last: bool = True,
                 num_workers: int = 4, prefetch: int = 4,
                 return_indices: bool = False):
        self.dataset = dataset
        self.sampler = sampler
        self.batch_size = batch_size
        self.drop_last = drop_last
        self.num_workers = max(0, num_workers)
        self.prefetch = prefetch
        # yield (images, targets, dataset_indices) — used by eval to key
        # per-image results by dataset index / img id (reference results.pth)
        self.return_indices = return_indices

    def __len__(self):
        n = len(self.sampler)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _batches(self):
        return batch_indices(self.sampler, self.batch_size, self.drop_last)

    def _collate(self, samples, batch_idxs=None):
        return collate(samples, batch_idxs, self.return_indices)

    def __iter__(self) -> Iterator:
        if self.num_workers == 0:
            for batch in self._batches():
                yield self._collate([self.dataset[i] for i in batch], batch)
            return

        from concurrent.futures import ThreadPoolExecutor

        def load(batch):
            return self._collate([self.dataset[i] for i in batch], batch)

        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def put_or_stop(item) -> bool:
            """Bounded put that aborts when the consumer abandoned iteration
            (otherwise the producer would block forever on a full queue)."""
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
                    futures = []
                    for batch in self._batches():
                        if stop.is_set():
                            break
                        futures.append(pool.submit(load, batch))
                        while len(futures) >= self.prefetch:
                            if not put_or_stop(futures.pop(0).result()):
                                break
                    for f in futures:
                        if stop.is_set():
                            f.cancel()
                            continue
                        put_or_stop(f.result())
                put_or_stop(None)  # end-of-epoch sentinel (no-op if stopped)
            except BaseException as e:  # surface worker errors to the consumer
                put_or_stop(e)


        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()


def make_epoch_data_loader(cfg, is_train: bool = True, drop_last: bool = True,
                           is_distributed: bool = False, start_iter: int = 0,
                           num_replicas: int = 1, rank: int = 0):
    """Reference make_epoch_data_loader (loader.py:131-168). With
    ``is_distributed`` the samplers shard the dataset over ``num_replicas``
    data replicas (``rank``: this replica's index, not the global rank).
    DATALOADER.BACKEND 'threads' loads in threads, 'grain' in worker
    processes (``grain_loader``); another value raises."""
    backend = cfg.DATALOADER.BACKEND
    if backend == "grain":
        from .grain_loader import GrainDataLoader as loader_cls
    elif backend == "threads":
        loader_cls = DataLoader
    else:
        raise ValueError(f"DATALOADER.BACKEND {backend!r}: one of 'threads', 'grain'")
    datasets = build_dataset(cfg, is_train)
    images_per_batch = cfg.DATALOADER.BSZ
    assert images_per_batch % num_replicas == 0, (
        f"DATALOADER.BSZ ({images_per_batch}) must be divisible by the "
        f"number of data replicas ({num_replicas})"
    )
    images_per_host = images_per_batch // num_replicas
    logging.getLogger(__name__).info(
        "Experiment with %d images per host", images_per_host
    )
    shuffle = True if is_train else bool(is_distributed)

    loaders = []
    for dataset in datasets:
        sampler = S.make_data_sampler(
            len(dataset), shuffle, is_distributed, is_train,
            cfg.AUG.REPEATED_AUG, num_replicas, rank, seed=cfg.TPU.SEED,
        )
        loaders.append(
            loader_cls(
                dataset, sampler, images_per_host, drop_last=drop_last,
                num_workers=cfg.DATALOADER.WORKERS,
            )
        )
    if is_train:
        assert len(loaders) == 1
        return loaders[0]
    return loaders
