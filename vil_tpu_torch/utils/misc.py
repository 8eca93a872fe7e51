"""Misc utilities (the reference's utils/miscellaneous.py); a copy of
``vil_tpu/utils/misc.py`` whose ``set_seed`` also seeds torch."""
from __future__ import annotations

import errno
import os
import random
import re

import numpy as np
import torch


def mkdir(path: str) -> None:
    try:
        os.makedirs(path)
    except OSError as e:
        if e.errno != errno.EEXIST:
            raise


def set_seed(seed: int, n_host: int = 0) -> None:
    """Seed python, numpy and torch (reference miscellaneous.py:89-94 seeds
    per-rank). The training step's own draws come from generators keyed by
    (TPU.SEED, step); this covers the host-side data-augmentation RNGs and
    torch's default generators."""
    seed = seed + n_host
    random.seed(seed)
    np.random.seed(seed & 0xFFFFFFFF)
    torch.manual_seed(seed)


def config_iteration(output_dir: str, steps_per_epoch: int) -> int:
    """Recover the start iteration from the last_checkpoint tag
    (reference miscellaneous.py:112-121)."""
    tag = os.path.join(output_dir, "last_checkpoint")
    iteration = -1
    if os.path.exists(tag):
        with open(tag, "r") as f:
            fname = f.read().strip()
        model_name = os.path.basename(fname)
        m = re.search(r"checkpoint_(\d+)", model_name)
        if m:
            iteration = int(m.group(1)) * steps_per_epoch
    return iteration


def save_config(cfg, path: str) -> None:
    with open(path, "w") as f:
        f.write(cfg.dump())
