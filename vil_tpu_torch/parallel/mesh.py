"""Process-group and mesh set-up, and the whole-model spatial forward.

Counterpart of the parts of ``vil_tpu/parallel/mesh.py`` that spatial
parallelism needs. JAX's ``jit_spatial_forward`` shards the image's height
over a mesh axis and lets GSPMD lower the halo exchange; PyTorch has no
GSPMD, so :func:`spatial_forward` runs the model's own modules on this
rank's rows with a :class:`~.spatial.SpatialContext`, and the attention
modules exchange the halos by hand (``parallel/spatial.py``).

Launch, one process per card, e.g. with ``torchrun --standalone
--nproc_per_node=4``, which gives every job a fresh ``TORCHELASTIC_RUN_ID``;
the store file must be new to the job, or ``init_process_group`` may join a
stale group or hang::

    import os, tempfile, torch
    from vil_tpu_torch import parallel
    store = os.path.join(tempfile.gettempdir(),
                         f"vil_store.{os.environ['TORCHELASTIC_RUN_ID']}")
    parallel.init_process_group(store, int(os.environ["RANK"]),
                                int(os.environ["WORLD_SIZE"]))
    mesh = parallel.create_mesh((-1, 4), ("data", "spatial"))
    group = mesh.get_group("spatial")
    logits = parallel.spatial_forward(model.eval(), parallel.shard_image(images, group),
                                      group)
"""
from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.distributed as dist

from .spatial import SpatialContext


def init_process_group(store_path, rank: int, world_size: int, backend: str = "nccl") -> None:
    """Join the default process group through a ``FileStore`` at
    ``store_path`` (a file every rank can reach, new to this job; no
    network). ``nccl`` by default, this rank on card ``rank % device_count``;
    ``gloo`` for the CPU, when the caller asks for it."""
    if backend == "nccl":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    store = dist.FileStore(str(store_path), world_size)
    dist.init_process_group(backend, store=store, rank=rank, world_size=world_size)


def create_mesh(mesh_shape: Sequence[int] = (-1,), axis_names: Sequence[str] = ("data",)):
    """A ``torch.distributed`` device mesh over every rank of the default
    group, on the cards under ``nccl`` and on the CPU under ``gloo``; a -1
    entry takes the ranks the others leave. ``mesh.get_group("spatial")`` is
    the group of a ``('data', 'spatial')`` mesh's spatial axis."""
    from torch.distributed.device_mesh import init_device_mesh

    world = dist.get_world_size()
    shape = list(mesh_shape)
    known = math.prod(s for s in shape if s != -1)
    if -1 in shape:
        shape[shape.index(-1)] = world // known
    if math.prod(shape) != world:
        raise ValueError(f"mesh {tuple(mesh_shape)} does not cover the {world} ranks")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=tuple(axis_names))


def shard_image(x: torch.Tensor, group=None) -> torch.Tensor:
    """This rank's rows of an NHWC image batch (B, H, W, C): the rank-th of
    the spatial group's equal blocks of H."""
    return SpatialContext.of(group).rows(x, dim=1).contiguous()


def spatial_forward(model, x_rows: torch.Tensor, group=None) -> torch.Tensor:
    """The model's eval forward with the image's rows split over ``group``
    (the default group when None): ``x_rows`` is this rank's
    :func:`shard_image`. The chunked stages run on their rows, their
    sliding-chunk attention through the halo kernels; the dense stages run
    whole on every rank. Returns the logits, the same on every rank of the
    group. Raises unless the group's size divides the chunk rows of every
    chunked stage."""
    ctx = SpatialContext.of(group)
    model.check_spatial_split(ctx.size)
    return model(x_rows, spatial=ctx)
