"""Train and eval steps: counterpart of ``vil_tpu/train/engine.py``.

The train step runs on the card: mixup, the forward in training mode
(stochastic depth and, for random-shift training, one sampled neighbour mode
per attention block), the loss in f32, the backward through the hand-written
attention kernels, the LR from the schedule and the optimizer update. It
returns its metrics as 0-d tensors, so nothing waits for the device. The
neighbour modes are drawn on the host from a CPU generator: they choose the
kernels' arguments, so a draw on the card would make every step wait for it.
"""
from __future__ import annotations

from typing import Callable, Optional, Union

import numpy as np
import torch
from torch import nn

from ..utils.device import resolve_device


def topk_correct(logits: torch.Tensor, targets: torch.Tensor, topk=(1, 5),
                 target_valid: Optional[np.ndarray] = None,
                 overlap_boost: Optional[np.ndarray] = None) -> torch.Tensor:
    """Per-sample top-k correctness (B, len(topk)) f32, with the 22K→1K
    target-map path: ``target_valid`` is a (num_targets, num_classes) bool
    matrix of the classes that count for each target, ``overlap_boost`` a
    bool vector of classes raised above all others before the top-k."""
    if overlap_boost is not None:
        boost = (logits.max() - logits.min() + 10) * torch.as_tensor(
            overlap_boost, device=logits.device).to(logits.dtype)
        logits = logits + boost[None]
    maxk = min(max(topk), logits.shape[-1])
    pred = logits.topk(maxk, dim=-1).indices  # (B, maxk)
    if target_valid is None:
        correct = pred == targets[:, None]
    else:
        valid = torch.as_tensor(target_valid, device=logits.device)
        correct = valid[targets.long()].gather(1, pred)
    return torch.stack([correct[:, :min(k, maxk)].any(dim=1).float() for k in topk], dim=1)


def sample_vil_modes(generator: torch.Generator, depth: int = 0) -> Union[int, list[int]]:
    """Random-shift neighbour mode(s) in [1, 9), drawn on the host from a CPU
    ``generator``: one per attention block (a list of ``depth`` ints) when
    ``depth`` > 0, else one int shared by all blocks. The reference samples a
    fresh mode in every attention forward (longformer2d.py:116-121)."""
    if generator.device.type != "cpu":
        raise ValueError(f"the modes are drawn on the host: generator on {generator.device}")
    draws = torch.randint(1, 9, (max(depth, 1),), generator=generator).tolist()
    return draws if depth > 0 else draws[0]


def make_train_step(model: nn.Module, criterion: Callable, optimizer: torch.optim.Optimizer,
                    schedule: Optional[Callable[[int], float]] = None,
                    mixup_fn: Optional[Callable] = None, device=None,
                    random_shift: bool = False, per_layer_modes: bool = True,
                    mode_generator: Optional[torch.Generator] = None) -> Callable:
    """Returns ``step(images, targets, generator, modes=None) -> metrics``.

    The model is moved to ``device``, the CUDA card unless the caller names
    another (``device="cpu"``). Each call takes NHWC float images and integer
    targets, draws mixup and stochastic depth from ``generator`` (on the
    model's device), sets every parameter group's LR to ``schedule(step)``
    (step counts from 0) and updates the parameters. Metrics: ``loss``, and
    ``top1`` / ``top5`` in percent when the targets are hard labels.

    ``random_shift`` trains at the sampled-neighbour modes (MODE > 0): each
    step draws, with :func:`sample_vil_modes` from the CPU ``mode_generator``,
    one mode per attention block (``per_layer_modes``, the default, as
    TPU.MODE_PER_LAYER) or one for all; ``modes`` given to the step replaces
    the draw. The modes used are returned as the metric ``modes``."""
    device = resolve_device(device)
    model.to(device)
    if random_shift and mode_generator is None:
        raise ValueError("random_shift draws its modes from a CPU mode_generator; give one")
    mode_depth = getattr(model, "depth", 0) if per_layer_modes else 0
    count = 0

    def step(images: torch.Tensor, targets: torch.Tensor, generator: torch.Generator,
             modes: Optional[Union[int, list[int]]] = None) -> dict:
        nonlocal count
        images = images.to(device, non_blocking=True)
        targets = targets.to(device, non_blocking=True)
        if mixup_fn is not None:
            images, targets = mixup_fn(generator, images, targets)
        if modes is None:
            modes = sample_vil_modes(mode_generator, mode_depth) if random_shift else 0
        model.train()
        logits = model(images, generator=generator, mode=modes).float()
        loss = criterion(logits, targets)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        if schedule is not None:
            lr = schedule(count)
            for group in optimizer.param_groups:
                group["lr"] = lr
        optimizer.step()
        count += 1
        metrics = {"loss": loss.detach()}
        if random_shift:
            metrics["modes"] = modes
        if targets.dim() == 1:  # hard labels: accuracy is meaningful
            correct = topk_correct(logits.detach(), targets)
            metrics["top1"] = correct[:, 0].mean() * 100
            metrics["top5"] = correct[:, 1].mean() * 100
        return metrics

    return step


def make_eval_step(model: nn.Module, criterion: Callable,
                   target_valid: Optional[np.ndarray] = None,
                   overlap_boost: Optional[np.ndarray] = None,
                   per_sample_criterion: Optional[Callable] = None) -> Callable:
    """Returns ``step(images, targets, valid) -> metrics`` over a padded
    batch: ``valid`` (B,) float marks the real samples. The loss uses the
    per-sample criterion under the mask when there is one, else the batch
    criterion (exact on full batches)."""

    @torch.no_grad()
    def step(images: torch.Tensor, targets: torch.Tensor, valid: torch.Tensor) -> dict:
        model.eval()
        logits = model(images).float()
        n_valid = valid.sum().clamp(min=1.0)
        if per_sample_criterion is not None:
            loss = (per_sample_criterion(logits, targets) * valid).sum() / n_valid
        else:
            loss = criterion(logits, targets)
        correct = topk_correct(logits, targets, (1, 5), target_valid,
                               overlap_boost) * valid[:, None]
        return {"loss": loss, "top1_sum": correct[:, 0].sum(),
                "top5_sum": correct[:, 1].sum(), "count": n_valid}

    return step


def build_target_map_arrays(target_map: dict[int, list[int]], num_targets: int,
                            num_classes: int):
    """The target map {target: [classes]} as a (num_targets, num_classes)
    validity matrix and the vector of classes any target maps to."""
    valid = np.zeros((num_targets, num_classes), dtype=bool)
    overlap = np.zeros((num_classes,), dtype=bool)
    for t, classes in target_map.items():
        for c in classes:
            valid[int(t), int(c)] = True
            overlap[int(c)] = True
    return valid, overlap
