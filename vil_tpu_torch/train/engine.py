"""Train and eval steps: counterpart of ``vil_tpu/train/engine.py``.

The train step runs on the card: mixup, the forward in training mode
(stochastic depth and, for random-shift training, one sampled neighbour mode
per attention block), the loss in f32, the backward through the hand-written
attention kernels, the LR from the schedule and the optimizer update. It
returns its metrics as 0-d tensors, so nothing waits for the device. The
neighbour modes are drawn on the host from a CPU generator: they choose the
kernels' arguments, so a draw on the card would make every step wait for it.

On a ('data', 'spatial') mesh (``parallel.Mesh``) every rank of a data
replica takes the replica's whole images, draws mixup, stochastic depth and
dropout alike (keyed by the seed, the step and the replica, not the rank;
each dropout mask is the whole value's, of which a rank keeps its rows), and
runs the model on its rows; the loss is the same on every rank of the
replica, so the ranks' partial gradients sum to D times the replica's, and
one all-reduce of the gradients over every rank, divided by the spatial
ranks with the replicas, makes them the global batch's
(``parallel.average_gradients``).

On a ('data', 'model') mesh the model is each model rank's shard
(TPU.PARAM_SHARDING 'tp', ``parallel/tensor.py``): every rank of a replica
takes the replica's images and draws alike (a dropout mask of the MLP's
hidden features is the whole layer's, of which a rank keeps its columns), the model's collectives make
the logits and the loss the same there, and the gradients are averaged over
the data axis alone (the relative-position tables' parts summed over the
model axis first). Under FSDP (``model.fsdp``, ``parallel.fully_shard``) the
blocks gather their parameters as they run and the step reduce-scatters
their gradients onto the slices before the update.

The two compose with the spatial axis: on a ('data', 'spatial', 'model')
mesh under 'tp' a rank runs its heads of its rows, every rank of a replica
(spatial × model) draws alike, the gradients are divided by D as on the
spatial mesh, and summed over the data and spatial axes
(``Mesh.param_group``); on a ('data', 'spatial') mesh under 'fsdp' the
sliced parameters' row-partial gradients are summed over the spatial group,
then reduce-scattered over the data group of the rank's spatial index.
"""
from __future__ import annotations

from typing import Callable, Optional, Union

import numpy as np
import torch
from torch import nn

from ..parallel.mesh import Mesh, Partial, average_gradients, average_metrics, shard_image
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


def keyed_seed(seed: int, step: int, stream: int, replica: int = 0) -> int:
    """A 64-bit seed for the generator of ``stream`` at global ``step`` on
    data ``replica``: the counterpart of ``jax.random.fold_in(rng, step)``
    then ``split``. A step draws the same whether the run was resumed or
    not, and no generator state needs saving; the spatial ranks of one
    replica draw alike."""
    return int(np.random.SeedSequence([seed, step, stream, replica])
               .generate_state(1, np.uint64)[0])


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
    between updates. On a mesh with a spatial axis every rank of a group
    must attend to the same neighbours, or the halos would not match: there
    the modes are drawn from the seed alone, keyed by (seed, step) and never
    by the rank or the replica (:meth:`_mode_generator`), and a
    ``mode_generator`` raises ``ValueError``.

    On a ``mesh`` (``parallel.Mesh``) the step takes its data replica's
    images whole: with a spatial axis it runs the model on this rank's rows
    (``parallel.shard_image``), with a model axis the model is this rank's
    shard of the heads, and with a process group it averages the gradients
    and the metrics over the replicas; the draws of a seeded step are keyed
    by the replica too. Every rank then takes the same update (of its
    shard). A model under FSDP (``model.fsdp``) has its gradients
    reduce-scattered onto its slices before the update.
    Without a mesh the step is this process's alone, whatever process group
    exists."""

    def __init__(self, model: nn.Module, criterion: Callable, optimizer: torch.optim.Optimizer,
                 schedule: Optional[Callable[[int], float]] = None,
                 mixup_fn: Optional[Callable] = None, device=None,
                 random_shift: bool = False, per_layer_modes: bool = True,
                 mode_generator: Optional[torch.Generator] = None,
                 start_step: int = 0, seed: Optional[int] = None, lr_scale: float = 1.0,
                 mesh: Optional[Mesh] = None):
        if random_shift and mode_generator is None and seed is None:
            raise ValueError("random_shift draws its modes from a CPU mode_generator; give one")
        if mode_generator is not None and mesh is not None and mesh.spatial is not None:
            raise ValueError("on a mesh with a spatial axis the ranks of a group draw the same "
                             "modes, keyed by (seed, step): give a seed, not a mode_generator")
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
        self.mesh = mesh
        self.base_lrs = [group["lr"] for group in optimizer.param_groups]
        if seed is not None:
            self.keyed = torch.Generator(device=self.device)
            self.keyed_modes = torch.Generator()

    def __call__(self, images: torch.Tensor, targets: torch.Tensor,
                 generator: Optional[torch.Generator] = None,
                 modes: Optional[Union[int, list[int]]] = None) -> dict:
        model, device, mesh = self.model, self.device, self.mesh
        if generator is None:
            if self.seed is None:
                raise ValueError("no generator given and no seed to key one by the step")
            generator = self.keyed.manual_seed(
                keyed_seed(self.seed, self.step, 0, mesh.data_rank if mesh else 0))
        images = images.to(device, non_blocking=True)
        targets = targets.to(device, non_blocking=True)
        if self.mixup_fn is not None:
            images, targets = self.mixup_fn(generator, images, targets)
        if modes is None:
            modes = sample_vil_modes(self._mode_generator(), self.mode_depth) \
                if self.random_shift else 0
        model.train()
        spatial = mesh.spatial if mesh else None
        split = {}
        if spatial is not None:  # this rank's rows; the logits alike on the group's ranks
            images = shard_image(images, model, spatial.group)
            split = {"spatial": spatial}
        logits = model(images, generator=generator, mode=modes, **split).float()
        loss = self.criterion(logits, targets)
        self.optimizer.zero_grad(set_to_none=True)
        # a loss computed alike on D ranks: each rank's partial gradients
        # sum to D times the replica's, so the sums below divide by the
        # spatial ranks with the replicas (after the sum, in the gradients'
        # type: a seed of 1/D would be rounded to the f32 loss's)
        loss.backward()
        divide = (mesh.data_size if mesh else 1) * (spatial.size if spatial is not None else 1)
        fsdp = getattr(model, "fsdp", None)
        if fsdp is not None:  # the sliced parameters' gradients onto the slices
            fsdp.reduce_scatter_gradients(divide,
                                          spatial.group if spatial is not None else None)
        if mesh is not None:
            sliced = {id(p) for p in fsdp.params.values()} if fsdp is not None else set()
            partial = ()
            if mesh.model is not None:
                partial = Partial(tuple(model.partial_over_model()), mesh.model.group,
                                  mesh.model.size)
            average_gradients([p for p in model.parameters() if id(p) not in sliced],
                              divide, mesh.param_group, partial)
        lrs = ([self.schedule(self.step)] * len(self.base_lrs) if self.schedule is not None
               else self.base_lrs)
        for group, lr in zip(self.optimizer.param_groups, lrs):
            group["lr"] = lr * self.lr_scale
        self.optimizer.step()
        self.step += 1
        metrics = {"loss": loss.detach()}
        if targets.dim() == 1:  # hard labels: accuracy is meaningful
            correct = topk_correct(logits.detach(), targets)
            metrics["top1"] = correct[:, 0].mean() * 100
            metrics["top5"] = correct[:, 1].mean() * 100
        if mesh is not None:
            # the global batch's: the replicas' mean
            metrics = average_metrics(metrics, mesh.param_group)
        if self.random_shift:
            metrics["modes"] = modes
        return metrics

    def _mode_generator(self) -> torch.Generator:
        """The CPU generator of this step's modes: ``mode_generator``, or
        one seeded by (seed, step) alone, the same on every rank."""
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
                   pred_topk: int = 0, spatial=None) -> Callable:
    """Returns ``step(images, targets, valid) -> metrics`` over a padded
    batch: ``valid`` (B,) float marks the real samples. The loss uses the
    per-sample criterion under the mask when there is one, else the batch
    criterion (exact on full batches).

    ``return_scores`` adds each image's top-1/top-5 correctness (B, 2) as
    ``scores``; ``pred_topk`` > 0 adds each image's top-k class ids and their
    logits (``pred_ids``, ``pred_scores``), the per-image results of
    ``results_*.npz``. With a ``spatial`` context the forward runs on this
    rank's rows of the images (``parallel.spatial_forward``)."""

    @torch.no_grad()
    def step(images: torch.Tensor, targets: torch.Tensor, valid: torch.Tensor) -> dict:
        model.eval()
        split = {}
        if spatial is not None:
            images = shard_image(images, model, spatial.group)
            split = {"spatial": spatial}
        logits = model(images, **split).float()
        if getattr(model, "fsdp", None) is not None:  # back to the slices
            model.fsdp.release()
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
