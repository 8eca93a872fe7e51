"""Per-host index samplers (reference dat/samplers + DistributedSampler use).

A copy of ``vil_tpu/data/samplers.py``, numpy only. The shard of a process
is its rank in a multi-process run (the reference used torch
DistributedSampler / RASampler keyed on the DDP rank — SURVEY §2.12/2.17);
the port's loader runs one process and uses the distributed samplers only
when asked. Samplers yield dataset indices; the loader batches them.
"""
from __future__ import annotations

import math

import numpy as np


class SequentialSampler:
    def __init__(self, length: int):
        self.length = length

    def set_epoch(self, epoch: int):
        pass

    def __len__(self):
        return self.length

    def __iter__(self):
        return iter(range(self.length))


class RandomSampler:
    def __init__(self, length: int, seed: int = 0):
        self.length = length
        self.seed = seed
        self.epoch = 0

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __len__(self):
        return self.length

    def __iter__(self):
        rng = np.random.default_rng((self.seed, self.epoch))
        return iter(rng.permutation(self.length).tolist())


class DistributedSampler:
    """Per-rank shard with padding, torch-DistributedSampler semantics."""

    def __init__(self, length: int, num_replicas: int, rank: int,
                 shuffle: bool = True, seed: int = 0):
        self.length = length
        self.num_replicas = num_replicas
        self.rank = rank
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0
        self.num_samples = int(math.ceil(length / num_replicas))
        self.total_size = self.num_samples * num_replicas

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __len__(self):
        return self.num_samples

    def __iter__(self):
        if self.shuffle:
            rng = np.random.default_rng((self.seed, self.epoch))
            indices = rng.permutation(self.length).tolist()
        else:
            indices = list(range(self.length))
        indices += indices[: self.total_size - len(indices)]
        return iter(indices[self.rank : self.total_size : self.num_replicas])


class RASampler:
    """Repeated-augmentation sampler (reference ra_sampler.py:12-63): each
    index repeated 3×, different copies land on different ranks, epoch length
    truncated to floor(len // 256 * 256 / world)."""

    def __init__(self, length: int, num_replicas: int, rank: int,
                 shuffle: bool = True, seed: int = 0):
        self.length = length
        self.num_replicas = num_replicas
        self.rank = rank
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0
        self.num_samples = int(math.ceil(length * 3.0 / num_replicas))
        self.total_size = self.num_samples * num_replicas
        self.num_selected_samples = int(math.floor(length // 256 * 256 / num_replicas))

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __len__(self):
        return self.num_selected_samples

    def __iter__(self):
        if self.shuffle:
            rng = np.random.default_rng((self.seed, self.epoch))
            indices = rng.permutation(self.length).tolist()
        else:
            indices = list(range(self.length))
        indices = [e for e in indices for _ in range(3)]
        indices += indices[: self.total_size - len(indices)]
        assert len(indices) == self.total_size
        indices = indices[self.rank : self.total_size : self.num_replicas]
        return iter(indices[: self.num_selected_samples])


def make_data_sampler(length: int, shuffle: bool, distributed: bool,
                      is_train: bool, repeated_aug: bool,
                      num_replicas: int = 1, rank: int = 0, seed: int = 0):
    """Reference make_data_sampler (loader.py:117-128)."""
    if distributed:
        if repeated_aug and is_train:
            return RASampler(length, num_replicas, rank, shuffle=shuffle, seed=seed)
        return DistributedSampler(length, num_replicas, rank, shuffle=shuffle,
                                  seed=seed)
    if shuffle:
        return RandomSampler(length, seed=seed)
    return SequentialSampler(length)
