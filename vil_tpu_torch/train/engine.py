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


def keyed_seed(seed: int, step: int, stream: int) -> int:
    """A 64-bit seed for the generator of ``stream`` at global ``step``: the
    counterpart of ``jax.random.fold_in(rng, step)`` then ``split``. A step
    draws the same whether the run was resumed or not, and no generator
    state needs saving."""
    return int(np.random.SeedSequence([seed, step, stream]).generate_state(1, np.uint64)[0])


class TrainStep:
    """``step(images, targets, generator=None, modes=None) -> metrics``.

    The model is moved to ``device``, the CUDA card unless the caller names
    another (``device="cpu"``). Each call takes NHWC float images and integer
    targets, draws mixup and stochastic depth from ``generator`` (on the
    model's device), sets every parameter group's LR to ``schedule(step)``
    (or to its LR at build time without a schedule) times ``lr_scale``, and
    updates the parameters. Metrics: ``loss``, and ``top1`` / ``top5`` in
    percent when the targets are hard labels.

    ``step`` is the global step of the next update, from ``start_step``: a
    resumed run reads the schedule where it stopped. With a ``seed``, a call
    given no ``generator`` draws from one seeded by (seed, step), and the
    modes of random shift come from another, so that a resumed run draws
    what an uninterrupted one draws (:func:`keyed_seed`).

    ``random_shift`` trains at the sampled-neighbour modes (MODE > 0): each
    step draws, with :func:`sample_vil_modes` from the CPU ``mode_generator``
    (else from the seed), one mode per attention block (``per_layer_modes``,
    the default, as TPU.MODE_PER_LAYER) or one for all; ``modes`` given to
    the step replaces the draw. The modes used are returned as the metric
    ``modes``. A caller may set ``step``, ``lr_scale`` and ``random_shift``
    between updates."""

    def __init__(self, model: nn.Module, criterion: Callable, optimizer: torch.optim.Optimizer,
                 schedule: Optional[Callable[[int], float]] = None,
                 mixup_fn: Optional[Callable] = None, device=None,
                 random_shift: bool = False, per_layer_modes: bool = True,
                 mode_generator: Optional[torch.Generator] = None,
                 start_step: int = 0, seed: Optional[int] = None, lr_scale: float = 1.0):
        if random_shift and mode_generator is None and seed is None:
            raise ValueError("random_shift draws its modes from a CPU mode_generator; give one")
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.criterion, self.optimizer = criterion, optimizer
        self.schedule, self.mixup_fn = schedule, mixup_fn
        self.random_shift = random_shift
        self.mode_depth = getattr(model, "depth", 0) if per_layer_modes else 0
        self.mode_generator = mode_generator
        self.step = start_step
        self.seed = seed
        self.lr_scale = lr_scale
        self.base_lrs = [group["lr"] for group in optimizer.param_groups]
        if seed is not None:
            self.keyed = torch.Generator(device=self.device)
            self.keyed_modes = torch.Generator()

    def __call__(self, images: torch.Tensor, targets: torch.Tensor,
                 generator: Optional[torch.Generator] = None,
                 modes: Optional[Union[int, list[int]]] = None) -> dict:
        model, device = self.model, self.device
        if generator is None:
            if self.seed is None:
                raise ValueError("no generator given and no seed to key one by the step")
            generator = self.keyed.manual_seed(keyed_seed(self.seed, self.step, 0))
        images = images.to(device, non_blocking=True)
        targets = targets.to(device, non_blocking=True)
        if self.mixup_fn is not None:
            images, targets = self.mixup_fn(generator, images, targets)
        if modes is None:
            modes = sample_vil_modes(self._mode_generator(), self.mode_depth) \
                if self.random_shift else 0
        model.train()
        logits = model(images, generator=generator, mode=modes).float()
        loss = self.criterion(logits, targets)
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        lrs = ([self.schedule(self.step)] * len(self.base_lrs) if self.schedule is not None
               else self.base_lrs)
        for group, lr in zip(self.optimizer.param_groups, lrs):
            group["lr"] = lr * self.lr_scale
        self.optimizer.step()
        self.step += 1
        metrics = {"loss": loss.detach()}
        if self.random_shift:
            metrics["modes"] = modes
        if targets.dim() == 1:  # hard labels: accuracy is meaningful
            correct = topk_correct(logits.detach(), targets)
            metrics["top1"] = correct[:, 0].mean() * 100
            metrics["top5"] = correct[:, 1].mean() * 100
        return metrics

    def _mode_generator(self) -> torch.Generator:
        if self.mode_generator is not None:
            return self.mode_generator
        if self.seed is None:
            raise ValueError("random_shift draws its modes from a CPU mode_generator or "
                             "from a seed; give one")
        return self.keyed_modes.manual_seed(keyed_seed(self.seed, self.step, 1))


# the factory's name in the JAX package (``make_train_step``)
make_train_step = TrainStep


def make_eval_step(model: nn.Module, criterion: Callable,
                   target_valid: Optional[np.ndarray] = None,
                   overlap_boost: Optional[np.ndarray] = None,
                   return_scores: bool = False,
                   per_sample_criterion: Optional[Callable] = None,
                   pred_topk: int = 0) -> Callable:
    """Returns ``step(images, targets, valid) -> metrics`` over a padded
    batch: ``valid`` (B,) float marks the real samples. The loss uses the
    per-sample criterion under the mask when there is one, else the batch
    criterion (exact on full batches).

    ``return_scores`` adds each image's top-1/top-5 correctness (B, 2) as
    ``scores``; ``pred_topk`` > 0 adds each image's top-k class ids and their
    logits (``pred_ids``, ``pred_scores``), the per-image results of
    ``results_*.npz``."""

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
        metrics = {"loss": loss, "top1_sum": correct[:, 0].sum(),
                   "top5_sum": correct[:, 1].sum(), "count": n_valid}
        if return_scores:
            metrics["scores"] = correct
        if pred_topk > 0:
            top = logits.topk(min(pred_topk, logits.shape[-1]), dim=-1)
            metrics["pred_ids"] = top.indices.to(torch.int32)
            metrics["pred_scores"] = top.values
        return metrics

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
