"""Cross-process communication helpers over ``torch.distributed``.

Counterpart of ``vil_tpu/parallel/collectives.py`` (itself the JAX form of
the reference's ``utils/comm.py``): rank helpers, a barrier, a gather of
pickled objects, a sum of dicts of scalars, a gather of equal-shape arrays
and the merge of per-image predictions on every rank. With no initialised
process group, or a world of one process, each acts as at one process and
communicates nothing.
"""
from __future__ import annotations

import contextlib
from typing import Any, Dict

import numpy as np
import torch.distributed as dist

# the torch.distributed calls the port's collectives make, and the argument
# that holds the buffer a rank hands over
_COUNTED = {"all_reduce": 0, "all_gather": 1, "all_gather_into_tensor": 1,
            "reduce_scatter_tensor": 1, "broadcast": 0, "batch_isend_irecv": 0}


def is_distributed() -> bool:
    """Whether a process group is initialised."""
    return dist.is_available() and dist.is_initialized()


def get_world_size(group=None) -> int:
    """Ranks in ``group`` (the default group when None); 1 without one."""
    return dist.get_world_size(group) if is_distributed() else 1


def get_rank(group=None) -> int:
    """This process's rank in ``group``; 0 without a process group."""
    return dist.get_rank(group) if is_distributed() else 0


def is_main_process() -> bool:
    return get_rank() == 0


def synchronize() -> None:
    """Barrier across processes."""
    if get_world_size() > 1:
        dist.barrier()


def all_gather(data: Any) -> list:
    """Gather picklable objects from all processes, in rank order (pickled
    into byte tensors, padded to the longest, gathered)."""
    if get_world_size() == 1:
        return [data]
    out: list = [None] * get_world_size()
    dist.all_gather_object(out, data)
    return out


def all_gather_arrays(array: np.ndarray) -> np.ndarray:
    """Gather an equal-shape array from every process, stacked on a new
    leading axis in rank order."""
    return np.stack([np.asarray(a) for a in all_gather(np.asarray(array))])


def reduce_dict(input_dict: Dict[str, float], average: bool = True) -> Dict[str, float]:
    """Sum (or mean) a dict of scalars across processes."""
    world = get_world_size()
    if world == 1:
        return dict(input_dict)
    keys = sorted(input_dict)
    vals = np.asarray([float(input_dict[k]) for k in keys], dtype=np.float64)
    total = all_gather_arrays(vals).sum(axis=0)
    if average:
        total = total / world
    return dict(zip(keys, total.tolist()))


def accumulate_predictions(predictions_per_rank: dict) -> dict:
    """Merge the per-image prediction dicts of all ranks, keyed by dataset
    index (reference comm.py:172-184, ``vil_tpu``'s
    ``accumulate_predictions``): an index that several ranks hold (the
    evaluation sampler's padded repeats, or the spatial ranks of one data
    replica) is counted once. Every rank gets the merge, where ``vil_tpu``'s
    non-master hosts get {}, so that all ranks take the same decisions from
    it."""
    merged: dict = {}
    for d in all_gather(predictions_per_rank):
        merged.update(d)
    return merged


@contextlib.contextmanager
def count_collectives():
    """Record every collective this process issues inside the block, in
    order, as (name, bytes): ``all_reduce``, ``all_gather``,
    ``all_gather_into_tensor``, ``reduce_scatter_tensor``, ``broadcast``
    (the bytes of the buffer this rank hands over) and
    ``batch_isend_irecv`` (one entry a batch, the bytes it sends). Yields
    the list. Instrumentation: it wraps ``torch.distributed``'s functions,
    through which every collective of ``parallel/`` goes, for the block."""
    log: list = []
    originals = {name: getattr(dist, name) for name in _COUNTED}

    def counted(name, fn):
        def call(*args, **kwargs):
            arg = args[_COUNTED[name]]
            if name == "batch_isend_irecv":
                sent = sum(op.tensor.numel() * op.tensor.element_size() for op in arg
                           if op.op in (dist.isend, dist.send))
            else:
                sent = arg.numel() * arg.element_size()
            log.append((name, sent))
            return fn(*args, **kwargs)
        return call

    for name, fn in originals.items():
        setattr(dist, name, counted(name, fn))
    try:
        yield log
    finally:
        for name, fn in originals.items():
            setattr(dist, name, fn)

