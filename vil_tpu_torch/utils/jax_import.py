"""Load ``vil_tpu`` (flax) parameters into a ``vil_tpu_torch`` model.

Counterpart of ``vil_tpu/utils/torch_import.py``, in the other direction. The
port's modules carry the flax names, so the mapping is per leaf:

* Dense ``kernel`` (in, out)        → Linear ``weight`` (out, in)
* Conv ``kernel`` (kh, kw, I, O)    → Conv2d ``weight`` (O, I, kh, kw)
* LayerNorm ``scale``               → ``weight``
* everything else keeps its name and layout.

A sharded model (TPU.PARAM_SHARDING 'tp' or 'fsdp': ``model.param_shards``)
takes each cut parameter's slice of the whole leaf, so that both packages
start from the same weights.

Strict both ways: a port parameter left unfilled or a JAX leaf left unused
raises. The flax ``buffers`` collection (the performer's
``projection_matrix``), given as ``buffers=``, fills the port's buffers of
the same names, as strictly: a model with buffers and no ``buffers=``
raises too. JAX itself is not imported: leaves are anything
``np.asarray`` accepts.
"""
from __future__ import annotations

from collections.abc import Mapping
from typing import Optional

import numpy as np
import torch
from torch import nn


def _flatten(tree: Mapping, prefix: str = ""):
    for key, val in tree.items():
        name = f"{prefix}{key}"
        if isinstance(val, Mapping):
            yield from _flatten(val, name + ".")
        else:
            yield name, np.asarray(val)


def _to_torch_leaf(name: str, arr: np.ndarray) -> tuple[str, np.ndarray]:
    base, _, leaf = name.rpartition(".")
    prefix = base + "." if base else ""
    if leaf == "kernel":
        if arr.ndim == 2:
            return prefix + "weight", arr.T
        if arr.ndim == 4:
            return prefix + "weight", arr.transpose(3, 2, 0, 1)
        raise ValueError(f"{name}: kernel of rank {arr.ndim} has no mapping")
    if leaf == "scale":
        return prefix + "weight", arr
    return name, arr


def _copy_tree(tree: Mapping, targets: dict, what: str, shards: Optional[dict] = None) -> None:
    """Copy every leaf of ``tree`` into the tensor of ``targets`` that its
    mapped name names (its slice, for a name in ``shards``); raise unless
    each leaf and each target is used."""
    shards = shards or {}
    filled = set()
    unused = []
    for name, arr in _flatten(tree):
        tname, tarr = _to_torch_leaf(name, arr)
        if tname not in targets:
            unused.append(name)
            continue
        p, shard = targets[tname], shards.get(tname)
        whole = tuple(p.shape) if shard is None else shard.full_shape(p.shape)
        if whole != tarr.shape:
            raise ValueError(f"{name} → {tname}: shape {tarr.shape} != {whole}")
        value = torch.from_numpy(np.array(tarr, dtype=np.float32, order="C"))
        p.copy_(value if shard is None else shard.local(value))
        filled.add(tname)
    missing = sorted(set(targets) - filled)
    if unused or missing:
        raise KeyError(f"{what} trees differ: unused JAX leaves {unused}, "
                       f"unfilled port {what}s {missing}")


@torch.no_grad()
def load_jax_params(model: nn.Module, params: Mapping,
                    buffers: Optional[Mapping] = None) -> nn.Module:
    """Copy the flax parameter tree ``params`` (nested mappings of arrays)
    into ``model`` in place, casting to each parameter's dtype and device,
    and the flax ``buffers`` collection into the model's buffers. A model
    that has buffers needs ``buffers``."""
    targets = dict(model.named_buffers())
    if buffers is None and targets:
        raise KeyError(f"the model has buffers {sorted(targets)}: give the flax "
                       f"'buffers' collection as buffers=")
    _copy_tree(params, dict(model.named_parameters()), "parameter",
               getattr(model, "param_shards", {}))
    _copy_tree(buffers or {}, targets, "buffer")
    return model
