"""Process-group and mesh set-up, the whole-model spatial forward, and the
gradient reduction of a training step over a ('data', 'spatial'), a
('data', 'model') or a ('data', 'spatial', 'model') mesh.

Counterpart of ``vil_tpu/parallel/mesh.py``. JAX's ``jit_spatial_forward``
and ``jit_train_step`` shard the image's height over a mesh axis and let
GSPMD lower the halo exchange and the gradient sums; PyTorch has no GSPMD,
so the model runs its own modules on this rank's rows with a
:class:`~.spatial.SpatialContext` (:func:`spatial_forward`, and the
training step of ``train.engine``), the attention modules exchange the
halos by hand (``parallel/spatial.py``), and the step sums the parameters'
gradients over every rank once (:func:`average_gradients`).

One process per card, e.g. under ``torchrun --standalone
--nproc_per_node=4``, which gives every job a fresh ``TORCHELASTIC_RUN_ID``;
the store file must be new to the job, or ``init_process_group`` may join a
stale group or hang (``python -m vil_tpu_torch.run_experiment`` does this
under torchrun)::

    import os, tempfile, torch
    from vil_tpu_torch import parallel
    store = os.path.join(tempfile.gettempdir(),
                         f"vil_store.{os.environ['TORCHELASTIC_RUN_ID']}")
    parallel.init_process_group(store, int(os.environ["RANK"]),
                                int(os.environ["WORLD_SIZE"]),
                                local_rank=int(os.environ["LOCAL_RANK"]))
    mesh = parallel.create_mesh((-1, 4), ("data", "spatial"))
    group = mesh.get_group("spatial")
    logits = parallel.spatial_forward(
        model.eval(), parallel.shard_image(images, model, group), group)

A ('data', 'model') mesh (``parallel/tensor.py``) splits each block's heads
over the model axis (``TPU.PARAM_SHARDING 'tp'``): every rank of a data
replica takes the replica's images whole, and the gradients are averaged
over the data axis alone. FSDP (``'fsdp'``) slices the parameters over the
data axis (:func:`fully_shard`).

Both go beside a spatial axis, as ``vil_tpu``'s Trainer runs them under
GSPMD. On a ('data', 'spatial', 'model') mesh under 'tp' a rank holds its
model group's heads of its spatial group's rows: the spatial group is the
ranks with its (data, model) index, the model group those with its (data,
spatial) index, the data group those with its (spatial, model) index, and
the ranks of one data replica (spatial × model) share its images. The
gradients are summed over the ranks that hold the same parameters (the
data and spatial axes, :attr:`Mesh.param_group`), the relative-position
tables' head parts over the model group first. On a ('data', 'spatial')
mesh under 'fsdp' the parameters are sliced over the data axis alone, whole
across the spatial group: the gathers and the reduce-scatter run over the
data group of a rank's spatial index, and each rank's row-partial gradients
are summed over the spatial group before the reduce-scatter.

A ResNet of the zoo runs on every one of these meshes: on a spatial axis
each rank holds whole blocks of 32 image rows (``ResNet.spatial_split``),
its convolutions and max-pool exchange halo rows with the neighbouring
ranks (``parallel.spatial.ConvRows``), and its BatchNorm statistics and
global pool are summed over the ranks that hold different images or rows
(:attr:`Mesh.param_group`); on a model axis it is whole on every rank.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from .collectives import get_world_size, is_distributed
from .spatial import SpatialContext
from .tensor import FSDP_MIN_SIZE, FullyShardedParams, TensorParallel, wide


def check_cards(world_size: int, cards: int) -> None:
    """Refuse more ``nccl`` ranks than the host's ``cards``: two ranks on one
    card make NCCL fail with a duplicate-GPU error, after the group is up."""
    if world_size > cards:
        raise ValueError(f"{world_size} nccl ranks need {world_size} cards, one each; this "
                         f"host has {cards}")


def init_process_group(store_path, rank: int, world_size: int, backend: str = "nccl",
                       local_rank: Optional[int] = None) -> None:
    """Join the default process group through a ``FileStore`` at
    ``store_path`` (a file every rank can reach, new to this job; no
    network). ``nccl`` by default, this rank on card ``local_rank`` (its rank
    when not given); ``gloo`` for the CPU, when the caller asks for it.
    Refuses more ``nccl`` ranks than cards before the group is
    initialised."""
    if backend == "nccl":
        check_cards(world_size, torch.cuda.device_count())
        torch.cuda.set_device(rank if local_rank is None else local_rank)
    store = dist.FileStore(str(store_path), world_size)
    dist.init_process_group(backend, store=store, rank=rank, world_size=world_size)


def create_mesh(mesh_shape: Sequence[int] = (-1,), axis_names: Sequence[str] = ("data",)):
    """A ``torch.distributed`` device mesh over every rank of the default
    group, on the cards under ``nccl`` and on the CPU under ``gloo``; a -1
    entry takes the ranks the others leave. ``mesh.get_group("spatial")`` is
    the group of a ``('data', 'spatial')`` mesh's spatial axis."""
    from torch.distributed.device_mesh import init_device_mesh

    shape = resolve_shape(mesh_shape, dist.get_world_size())
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=tuple(axis_names))


def resolve_shape(mesh_shape: Sequence[int], world: int) -> list[int]:
    """``mesh_shape`` with its -1 entry filled so that it covers ``world``
    ranks; raises if it cannot."""
    shape = [int(n) for n in mesh_shape]
    known = math.prod(s for s in shape if s != -1)
    if -1 in shape:
        shape[shape.index(-1)] = world // known
    if math.prod(shape) != world:
        raise ValueError(f"mesh {tuple(mesh_shape)} does not cover the {world} ranks")
    return shape


@dataclass(frozen=True)
class Mesh:
    """This process's place on a mesh of a data axis and a spatial axis, a
    model axis or both: its data replica ``data_rank`` of ``data_size`` (the
    images it reads); where the mesh has a spatial axis, the context of its
    spatial group (the rows of each image it holds); where it has a model
    axis, the context of its model group (``model``: the heads it holds
    under TPU.PARAM_SHARDING 'tp'). ``data_group`` is the ranks of the data
    axis that hold the same rows and heads (FSDP slices over it; None: every
    rank, on a mesh of the data axis alone); ``param_group`` the ranks that
    hold the same parameters, over which the gradients are summed (None:
    every rank; on a mesh of data and model axes ``data_group``, its
    default); ``replica_group`` the ranks of one data replica where the
    mesh has both a spatial and a model axis. Without a process group: one
    replica, and contexts of one rank that communicate nothing."""

    data_size: int = 1
    data_rank: int = 0
    spatial: Optional[SpatialContext] = None
    model: Optional[TensorParallel] = None
    data_group: Optional[dist.ProcessGroup] = None
    param_group: Optional[dist.ProcessGroup] = None
    replica_group: Optional[dist.ProcessGroup] = None

    def __post_init__(self):
        if self.param_group is None and self.model is not None and self.spatial is None:
            object.__setattr__(self, "param_group", self.data_group)

    @property
    def replica(self):
        """The context of the ranks that share one data replica's images
        (the spatial group, the model group, or both together), or None."""
        if self.spatial is not None and self.model is not None:
            return TensorParallel.of(self.replica_group)
        return self.spatial if self.spatial is not None else self.model


def _flat_group(shape: Sequence[int], kept: Sequence[int]):
    """This rank's group of the ranks that share its index on every axis of
    the mesh of ``shape`` but the ``kept`` ones (``create_mesh`` numbers the
    ranks row-major). Every rank creates every such group, in one order."""
    ranks = np.arange(math.prod(shape)).reshape(shape)
    others = [a for a in range(len(shape)) if a not in kept]
    rows = ranks.transpose(others + list(kept)).reshape(-1, math.prod(shape[a] for a in kept))
    group, _ = dist.new_subgroups_by_enumeration([r.tolist() for r in rows])
    return group


def mesh_from_cfg(cfg) -> Mesh:
    """The :class:`Mesh` of ``TPU.MESH_SHAPE`` / ``TPU.MESH_AXES`` over the
    default group's ranks: the axes ``data``, ``spatial`` and ``model``, in
    any order, each at most once (another raises); a mesh without a data
    axis has one data replica."""
    axes = tuple(cfg.TPU.MESH_AXES)
    if not set(axes) <= {"data", "spatial", "model"} or len(set(axes)) != len(axes):
        raise ValueError(f"TPU.MESH_AXES {list(axes)}: the port's mesh has the axes 'data', "
                         f"'spatial' and 'model'")
    shape = resolve_shape(cfg.TPU.MESH_SHAPE, get_world_size())
    if len(shape) != len(axes):
        raise ValueError(f"TPU.MESH_SHAPE {list(cfg.TPU.MESH_SHAPE)} and TPU.MESH_AXES "
                         f"{list(axes)} differ in length")
    if "data" not in axes:  # one data replica
        axes, shape = ("data", *axes), [1, *shape]
    if not is_distributed():
        return Mesh(spatial=SpatialContext.of(None) if "spatial" in axes else None,
                    model=TensorParallel.of(None) if "model" in axes else None)
    mesh = create_mesh(shape, axes)
    data_size, data_rank = mesh.size(axes.index("data")), mesh.get_local_rank("data")
    spatial = SpatialContext.of(mesh.get_group("spatial")) if "spatial" in axes else None
    model = TensorParallel.of(mesh.get_group("model")) if "model" in axes else None
    data_group = mesh.get_group("data") if len(axes) > 1 else None
    param_group = replica_group = None
    if model is not None and spatial is not None:
        at = axes.index
        param_group = _flat_group(shape, (at("data"), at("spatial")))
        replica_group = _flat_group(shape, (at("spatial"), at("model")))
    return Mesh(data_size, data_rank, spatial, model, data_group, param_group, replica_group)


def average_gradients(params, divide: int, group=None, partial=()) -> None:
    """Sum every parameter's gradient over the ranks of ``group`` (all ranks
    when None) in one all-reduce and divide by ``divide``, the data
    replicas times the spatial ranks: the spatial ranks' partial gradients
    of a loss each computes alike add up to D times their replica's
    (``parallel/spatial.py``), and the replicas' are averaged. On a model
    axis ``group`` is the ranks that hold the same parameters
    (``Mesh.param_group``: the data axis, with the spatial axis where the
    mesh has one): the model ranks hold whole gradients, or their part of
    the weights, and ``partial`` names the parameters of which each holds a
    part (``MsViT.partial_over_model``), summed over the model group
    ``partial.group`` first. Parameters without a gradient are left out,
    alike on every rank. Nothing happens without a process group or at one
    rank."""
    if not is_distributed():
        return
    if partial and partial.size > 1:
        _sum_into([p.grad for p in partial.params if p.grad is not None], partial.group)
    if get_world_size(group) == 1 and divide == 1:
        return
    grads = [p.grad for p in params if p.grad is not None]
    _sum_into(grads, group, divide)


def _sum_into(grads: list, group, divide: int = 1) -> None:
    """Each tensor of ``grads`` replaced by its sum over ``group`` (in one
    all-reduce, in f32, or f64 when a gradient is f64), divided by
    ``divide``."""
    if not grads:
        return
    dtype = wide(*(g.dtype for g in grads))
    flat = torch.cat([g.reshape(-1).to(dtype) for g in grads])
    if get_world_size(group) > 1:
        dist.all_reduce(flat, group=group)
    flat /= divide
    for g, part in zip(grads, flat.split([g.numel() for g in grads])):
        g.copy_(part.view_as(g))


@dataclass(frozen=True)
class Partial:
    """Parameters of which each rank of a model ``group`` of ``size`` holds
    a part of the gradient (:func:`average_gradients`)."""

    params: tuple
    group: Optional[dist.ProcessGroup]
    size: int


def fully_shard(model, mesh: Mesh, min_size: int = FSDP_MIN_SIZE) -> FullyShardedParams:
    """FSDP of ``model`` over ``mesh``'s data axis (TPU.PARAM_SHARDING
    'fsdp', ``parallel/tensor.py``): its large parameters become this
    rank's slices of the data group of its spatial index (whole across the
    spatial group, as ``vil_tpu``'s ``fsdp_sharding`` shards over 'data'
    alone); build the optimizer afterwards. Returns the state
    (``model.fsdp``) that the train and eval steps drive."""
    return FullyShardedParams(model, mesh.data_group, min_size)


def average_metrics(metrics: dict, group=None) -> dict:
    """A dict of 0-d metric tensors averaged over the ranks of ``group``
    (all ranks when None; a mesh's ``param_group``) in one all-reduce: each
    data replica counted once, as its spatial and model ranks hold the same
    values. Returned as it is at one rank."""
    size = get_world_size(group)
    if size == 1:
        return metrics
    stacked = torch.stack([v.float() for v in metrics.values()])
    dist.all_reduce(stacked, group=group)
    return dict(zip(metrics, stacked / size))


def broadcast_replica(t: torch.Tensor, replica) -> torch.Tensor:
    """``t`` as the first rank of the ``replica`` group (``Mesh.replica``)
    holds it, on every rank of the group: a batch
    the ranks of one data replica must share. As it is without a process
    group or on a group of one rank."""
    if replica is None or replica.size == 1 or not is_distributed():
        return t
    t = t.contiguous()
    src = dist.get_global_rank(replica.group or dist.group.WORLD, 0)
    dist.broadcast(t, src=src, group=replica.group)
    return t


def shard_image(x: torch.Tensor, model, group=None) -> torch.Tensor:
    """This rank's rows of an NHWC image batch (B, H, W, C) over the spatial
    ``group`` (the default group when None): the rows that ``model``'s
    chunk-aligned split gives it (``model.spatial_split``)."""
    ctx = SpatialContext.of(group)
    lo, hi = model.spatial_split(ctx.size).image[ctx.rank]
    return x[:, lo:hi].contiguous()


def spatial_forward(model, x_rows: torch.Tensor, group=None, mode=0) -> torch.Tensor:
    """The model's forward with the image's rows split over ``group`` (the
    default group when None): ``x_rows`` is this rank's :func:`shard_image`.
    The chunked stages run on their rows, their sliding-chunk attention at
    ``mode`` (an int, or one per attention block, as the model's forward
    takes it): through the halo kernels at mode 0 (and at modes 1..8,
    which a model in eval mode serves at 0), through the self-only kernels
    on the rows alone at mode -1; the dense stages run whole on every rank.
    Returns the logits, the same on every rank of the group. Raises
    ``ValueError`` when the split would leave a rank no row of a chunked
    stage."""
    return model(x_rows, mode=mode, spatial=SpatialContext.of(group))
