"""DATALOADER.BACKEND 'grain' as PyTorch worker processes: the counterpart of
``vil_tpu/data/grain_loader.py``. It imports no ``grain``.

The threads loader (``loader.DataLoader``) decodes in threads, which is
enough while PIL releases the GIL; an augmentation written in Python
(RandAugment and RandomErasing at 384²) holds it, and ``vil_tpu`` then
decodes in grain's worker processes. Here the processes are a
``torch.utils.data.DataLoader``'s, ``DATALOADER.WORKERS`` of them, kept from
epoch to epoch, with batches handed over in shared memory and copied into
pinned memory where a CUDA card is present. They are forked by a fork
server (``forkserver``), a clean process started once, which imports this
module (and the main script, as ``spawn`` would) before it forks any worker:
a fork of the trainer's own process, which runs threads, can hang, and
``spawn`` pays the interpreter's and torch's start-up in every worker (17-28
s for 4-16 workers on an 8-core H100 host, ``chip_smoke.py`` phase 20).

``vil_tpu``'s batch-as-record design stays: the port's sampler gives the
order in the main process, each of its batches of indices goes to a worker
as one record, and the worker assembles the whole batch, so that the batches
and their order are the threads loader's (``DataLoader`` keeps the order in
which it handed the records out). Images stay uint8 under
INPUT.DEVICE_NORMALIZE, the ragged tail batch is kept when ``drop_last`` is
False, and a worker that dies raises ``RuntimeError`` in the consumer
(PyTorch's ``DataLoader`` watches its workers) instead of ending the epoch.
With 0 workers the batches are assembled in the main process.
"""
from __future__ import annotations

import multiprocessing
from typing import Iterator

import torch

from .loader import batch_indices, collate


class _BatchSource(torch.utils.data.Dataset):
    """A record is a whole collated batch: the dataset's samples at one list
    of indices, with the indices."""

    def __init__(self, dataset):
        self.dataset = dataset

    def __getitem__(self, idxs):
        return collate([self.dataset[i] for i in idxs], idxs, return_indices=True)


class _Batches:
    """The batches of indices, drawn anew from the sampler at each pass (so
    that ``sampler.set_epoch`` takes effect)."""

    def __init__(self, sampler, batch_size: int, drop_last: bool):
        self.sampler, self.batch_size, self.drop_last = sampler, batch_size, drop_last

    def __iter__(self):
        return batch_indices(self.sampler, self.batch_size, self.drop_last)

    def __len__(self) -> int:
        n = len(self.sampler)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)


class GrainDataLoader:
    """The threads loader's constructor and iteration contract: numpy
    batches (images, targets[, dataset indices when ``return_indices``])."""

    def __init__(self, dataset, sampler, batch_size: int, drop_last: bool = True,
                 num_workers: int = 4, return_indices: bool = False):
        self.dataset = dataset
        self.sampler = sampler
        self.batch_size = batch_size
        self.drop_last = drop_last
        self.num_workers = max(0, num_workers)
        self.return_indices = return_indices
        self._loader = None  # built at the first pass, its workers kept

    def __len__(self) -> int:
        return len(_Batches(self.sampler, self.batch_size, self.drop_last))

    def _torch_loader(self) -> torch.utils.data.DataLoader:
        if self._loader is None:
            workers, context = self.num_workers, None
            if workers > 0:
                context = multiprocessing.get_context("forkserver")
                # read when the fork server starts, the first time one is used
                context.set_forkserver_preload(["__main__", __name__])
            self._loader = torch.utils.data.DataLoader(
                _BatchSource(self.dataset),
                sampler=_Batches(self.sampler, self.batch_size, self.drop_last), batch_size=None,
                num_workers=workers, pin_memory=torch.cuda.is_available(),
                persistent_workers=workers > 0, multiprocessing_context=context)
        return self._loader

    def __iter__(self) -> Iterator:
        for images, targets, idxs in self._torch_loader():
            batch = (images.numpy(), targets.numpy())
            yield (*batch, idxs.numpy()) if self.return_indices else batch
