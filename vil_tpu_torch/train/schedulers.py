"""LR schedules: counterpart of ``vil_tpu/train/schedulers.py``.

Plain ``step -> lr`` functions with the JAX package's warmup and decay
formulas (evaluated in f32, as there):

* warmup factor: wf·(1-α) + α with α = step/warmup_iters (linear) or wf
  (constant) while step < warmup_iters
* multistep:     lr·warmup·γ^(number of milestones ≤ step)
* cosine:        min + (lr-min)·(1+cos(π·step/max_iter))/2 after warmup
                 (the cosine phase uses the RAW step, warmup included)
* linear:        min + (lr-min)·max(0, (max_iter-step)/(max_iter-warmup))
"""
from __future__ import annotations

import logging
import math
from typing import Callable, Optional, Sequence

import numpy as np

Schedule = Callable[[int], float]
_f32 = np.float32


def _warmup_factor(step, warmup_iters: float, warmup_factor: float, method: str):
    if method not in ("constant", "linear"):
        raise ValueError(f"Only 'constant' or 'linear' warmup accepted, got {method}")
    if method == "constant":
        return _f32(warmup_factor)
    alpha = step / _f32(max(warmup_iters, 1))
    return _f32(warmup_factor) * (1 - alpha) + alpha


def warmup_multistep(base_lr: float, milestones: Sequence[int], gamma: float,
                     warmup_factor: float = 1.0 / 3, warmup_iters: float = 500,
                     warmup_method: str = "linear") -> Schedule:
    milestones = sorted(milestones)

    def schedule(step: int) -> float:
        step = _f32(step)
        wf = (_warmup_factor(step, warmup_iters, warmup_factor, warmup_method)
              if step < warmup_iters else _f32(1.0))
        power = sum(step >= m for m in milestones)
        return float(_f32(base_lr) * wf * _f32(gamma) ** power)

    return schedule


def warmup_cosine(base_lr: float, max_iter: int, min_lr: float = 0.0,
                  warmup_factor: float = 1.0 / 3, warmup_iters: float = 500,
                  warmup_method: str = "linear") -> Schedule:
    def schedule(step: int) -> float:
        step = _f32(step)
        if step < warmup_iters:
            return float(_f32(base_lr) * _warmup_factor(step, warmup_iters, warmup_factor,
                                                        warmup_method))
        cos = np.cos(_f32(math.pi) * step / _f32(max_iter))
        return float(_f32(min_lr) + (_f32(base_lr) - _f32(min_lr)) * (1 + cos) / 2)

    return schedule


def warmup_linear(base_lr: float, max_iter: int, min_lr: float = 0.0,
                  warmup_factor: float = 1.0 / 3, warmup_iters: float = 500,
                  warmup_method: str = "linear") -> Schedule:
    def schedule(step: int) -> float:
        step = _f32(step)
        if step < warmup_iters:
            return float(_f32(base_lr) * _warmup_factor(step, warmup_iters, warmup_factor,
                                                        warmup_method))
        rate = max(_f32(0.0), (_f32(max_iter) - step) / max(_f32(1.0),
                                                            _f32(max_iter - warmup_iters)))
        return float(_f32(min_lr) + rate * (_f32(base_lr) - _f32(min_lr)))

    return schedule


def get_lr_schedule(cfg) -> Optional[Schedule]:
    """The JAX package's factory. Returns None (constant LR) for an unknown
    policy, with a warning. Epoch-based schedules advance once per epoch of
    SOLVER.STEPS_PER_EPOCH optimizer steps."""
    lr_policy = cfg.SOLVER.LR_POLICY
    epoch_based = cfg.SOLVER.EPOCH_BASED_SCHEDULE
    if epoch_based:
        warmup_iters = cfg.SOLVER.WARMUP_EPOCHS
        max_iters = int(cfg.OPTIM.EPOCHS)
    else:
        warmup_iters = int(cfg.SOLVER.WARMUP_EPOCHS * cfg.SOLVER.STEPS_PER_EPOCH)
        max_iters = cfg.SOLVER.MAX_ITER
    common = dict(warmup_factor=cfg.SOLVER.WARMUP_FACTOR, warmup_iters=warmup_iters,
                  warmup_method=cfg.SOLVER.WARMUP_METHOD)

    def units(schedule: Schedule) -> Schedule:
        if not epoch_based:
            return schedule
        spe = max(int(cfg.SOLVER.STEPS_PER_EPOCH), 1)
        return lambda step: schedule(step // spe)

    if lr_policy == "multistep":
        freq, epochs = cfg.OPTIM.DROP_FREQ, cfg.OPTIM.EPOCHS
        steps = tuple(range(freq, epochs, freq))
        if not epoch_based:
            steps = tuple(e * cfg.SOLVER.STEPS_PER_EPOCH for e in steps)
        return units(warmup_multistep(cfg.OPTIM.LR, steps, 1.0 / cfg.OPTIM.DROP_FACTOR,
                                      **common))
    if lr_policy == "cosine":
        return units(warmup_cosine(cfg.OPTIM.LR, max_iters, cfg.SOLVER.MIN_LR, **common))
    if lr_policy == "linear":
        return units(warmup_linear(cfg.OPTIM.LR, max_iters, cfg.SOLVER.MIN_LR, **common))
    logging.warning("Only 'multistep', 'cosine' or 'linear' lr policy is accepted, got %s",
                    lr_policy)
    return None
