"""Load ``vil_tpu`` (flax) parameters into a ``vil_tpu_torch`` model.

Counterpart of ``vil_tpu/utils/torch_import.py``, in the other direction. The
port's modules carry the flax names, so the mapping is per leaf:

* Dense ``kernel`` (in, out)        → Linear ``weight`` (out, in)
* Conv ``kernel`` (kh, kw, I, O)    → Conv2d ``weight`` (O, I, kh, kw)
* LayerNorm and BatchNorm ``scale`` → ``weight``
* everything else keeps its name and layout.

The ResNet zoo's modules carry torchvision's names, so its tree maps by
module too: ``layerI_J`` → ``layerI.J``, ``downsample_conv`` /
``downsample_bn`` → ``downsample.0`` / ``downsample.1``; its
``batch_stats`` collection (``mean``, ``var``) fills the BatchNorms'
``running_mean`` and ``running_var`` (``batch_stats=``).

A sharded model (TPU.PARAM_SHARDING 'tp' or 'fsdp': ``model.param_shards``)
takes each cut parameter's slice of the whole leaf, so that both packages
start from the same weights.

Strict both ways: a port parameter left unfilled or a JAX leaf left unused
raises. The flax ``buffers`` collection (the performer's
``projection_matrix``), given as ``buffers=``, fills the port's buffers of
the same names, as strictly: a model with buffers and no ``buffers=``
raises too. JAX itself is not imported: leaves are anything
``np.asarray`` accepts.

The optimizer state of a ``vil_tpu`` checkpoint maps too
(:func:`optimizer_state_dict`, :func:`vil_tpu_payload`): every optimizer
that ``vil_tpu/train/optim.py::get_opt`` builds, inside the trainer's
``{"inner", "lr_scale"}`` wrapper (``lr_scalable``). Flax writes an optax
chain as a map keyed ``'0'``, ``'1'``, ...; ``with_wd0``'s extra element
nests the chain once more; a ``MaskedState`` is ``{"inner_state": ...}``,
and the ``add_decayed_weights`` it masks holds no state, so no masked-out
leaf is written; an ``EmptyState`` is ``{}``; a learning-rate schedule's
``count`` is the step's. What holds moments:

* SGD's ``trace``                         → ``momentum_buffer``
* Adam's and AdamW's ``mu``, ``nu``, ``count`` → ``exp_avg``, ``exp_avg_sq``,
  ``step`` (``scale_by_adam``; the port's ``torch.optim.Adam``)
* QHM's ``h``                             → ``h`` (the port's ``QHM``)
* LAMB's ``mu``, ``nu``, ``count``        → ``m``, ``v``, ``step`` (``Lamb``)

each moment leaf under its parameter's name and layout (``kernel`` →
``weight``, transposed). As strict as the parameters: a moment for no
parameter, a parameter with none, or an optax state the port's optimizer
does not keep raises. A state written under TPU.FLAT_OPT or STACKED_OPT
(its moments keyed by dtype group, not by parameter) raises naming A13.
"""
from __future__ import annotations

import re
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


_RESNET_MODULES = ((re.compile(r"(^|\.)layer(\d+)_(\d+)(?=\.)"), r"\1layer\2.\3"),
                   (re.compile(r"(^|\.)downsample_conv(?=\.)"), r"\1downsample.0"),
                   (re.compile(r"(^|\.)downsample_bn(?=\.)"), r"\1downsample.1"))
_BATCH_STATS = {"mean": "running_mean", "var": "running_var"}


def _module_path(name: str) -> str:
    """The port's module path of a flax leaf path: the ResNet zoo's blocks
    and downsample pairs renamed to torchvision's (no MsViT path holds
    those names)."""
    for pattern, repl in _RESNET_MODULES:
        name = pattern.sub(repl, name)
    return name


def _stats_tree(batch_stats: Mapping) -> dict:
    """A flax ``batch_stats`` collection as a buffer tree of the port's
    leaf names: ``mean`` → ``running_mean``, ``var`` → ``running_var``."""
    out = {}
    for name, arr in _flatten(batch_stats):
        base, _, leaf = name.rpartition(".")
        if leaf not in _BATCH_STATS:
            raise KeyError(f"batch_stats leaf {name}: a BatchNorm holds mean and var")
        out[f"{base}.{_BATCH_STATS[leaf]}"] = arr
    return out


def _to_torch_leaf(name: str, arr: np.ndarray) -> tuple[str, np.ndarray]:
    base, _, leaf = _module_path(name).rpartition(".")
    prefix = base + "." if base else ""
    if leaf == "kernel":
        if arr.ndim == 2:
            return prefix + "weight", arr.T
        if arr.ndim == 4:
            return prefix + "weight", arr.transpose(3, 2, 0, 1)
        raise ValueError(f"{name}: kernel of rank {arr.ndim} has no mapping")
    if leaf == "scale":
        return prefix + "weight", arr
    return prefix + leaf, arr


def _whole_tree(tree: Mapping, shapes: dict, what: str) -> dict:
    """Every leaf of ``tree`` under its mapped name, as an f32 CPU tensor of
    the whole shape that ``shapes`` gives that name; raise unless each leaf
    and each name is used."""
    out = {}
    unused = []
    for name, arr in _flatten(tree):
        tname, tarr = _to_torch_leaf(name, arr)
        if tname not in shapes:
            unused.append(name)
            continue
        if tuple(shapes[tname]) != tarr.shape:
            raise ValueError(f"{name} → {tname}: shape {tarr.shape} != {tuple(shapes[tname])}")
        out[tname] = torch.from_numpy(np.array(tarr, dtype=np.float32, order="C"))
    missing = sorted(set(shapes) - set(out))
    if unused or missing:
        raise KeyError(f"{what} trees differ: unused JAX leaves {unused}, "
                       f"unfilled port {what}s {missing}")
    return out


def _whole_shapes(model: nn.Module) -> dict:
    """{parameter name: its whole shape}: a sharded one's before the cut."""
    shards = getattr(model, "param_shards", {})
    return {n: (shards[n].full_shape(p.shape) if n in shards else tuple(p.shape))
            for n, p in model.named_parameters()}


def _buffers(model: nn.Module, buffers: Optional[Mapping],
             batch_stats: Optional[Mapping]) -> dict:
    """The model's buffers from the flax ``buffers`` collection and the
    ``batch_stats`` one, f32 CPU tensors by name, strictly: a model that has
    buffers needs one of them."""
    targets = {n: tuple(b.shape) for n, b in model.named_buffers()}
    if buffers is None and batch_stats is None and targets:
        raise KeyError(f"the model has buffers {sorted(targets)}: give the flax "
                       f"'buffers' collection as buffers= (a ResNet's 'batch_stats' as "
                       f"batch_stats=)")
    tree = dict(buffers or {})
    tree.update(_stats_tree(batch_stats or {}))
    return _whole_tree(tree, targets, "buffer")


@torch.no_grad()
def load_jax_params(model: nn.Module, params: Mapping, buffers: Optional[Mapping] = None,
                    batch_stats: Optional[Mapping] = None) -> nn.Module:
    """Copy the flax parameter tree ``params`` (nested mappings of arrays)
    into ``model`` in place, casting to each parameter's dtype and device,
    and the flax ``buffers`` collection (or a ResNet's ``batch_stats``) into
    the model's buffers. A model that has buffers needs one of them."""
    state = _buffers(model, buffers, batch_stats)
    shards = getattr(model, "param_shards", {})
    targets = dict(model.named_parameters())
    for name, value in _whole_tree(params, _whole_shapes(model), "parameter").items():
        targets[name].copy_(value if name not in shards else shards[name].local(value))
    targets = dict(model.named_buffers())
    for name, value in state.items():
        targets[name].copy_(value)
    return model


def model_state_dict(model: nn.Module, params: Mapping, buffers: Optional[Mapping] = None,
                     batch_stats: Optional[Mapping] = None) -> dict:
    """The flax ``params`` and ``buffers`` (or ``batch_stats``) collections
    as the port's whole (replicated-format) ``state_dict`` of ``model``, f32
    on the CPU."""
    state = _whole_tree(params, _whole_shapes(model), "parameter")
    state.update(_buffers(model, buffers, batch_stats))
    return state


# ---------------------------------------------------------------- optimizer state

# the optax state that holds a port optimizer's moments: its fields, and the
# port's state keys each moment goes to
_MOMENTS = {
    "SGD": ({"trace"}, {"momentum_buffer": "trace"}),
    "Adam": ({"count", "mu", "nu"}, {"exp_avg": "mu", "exp_avg_sq": "nu"}),
    "QHM": ({"h"}, {"h": "h"}),
    "Lamb": ({"count", "mu", "nu"}, {"m": "mu", "v": "nu"}),
}
# the keys FLAT_OPT and STACKED_OPT give a moment tree: dtype groups, not parameters
_GROUPED = re.compile(r"(wd|nd)_[a-z0-9]+(_[0-9x]*)?|leaf[0-9]+")


def _chain_states(node, where: str = "opt_state") -> list:
    """The states of an optax chain as flax wrote it, flat and in order:
    chains (maps keyed '0'..'n-1') and ``MaskedState``s opened, ``EmptyState``s
    dropped; each state a (path, map) pair."""
    if not isinstance(node, Mapping):
        raise ValueError(f"{where}: an optax state is a map, got {type(node).__name__}")
    if not node:
        return []
    if set(node) == {"inner_state"}:
        inner = _chain_states(node["inner_state"], where + ".inner_state")
        if inner:
            raise ValueError(f"{where}: a masked transform with state; vil_tpu masks only "
                             f"add_decayed_weights, which has none")
        return []
    if set(node) == {str(i) for i in range(len(node))}:
        return [s for i in range(len(node)) for s in _chain_states(node[str(i)], f"{where}.{i}")]
    return [(where, node)]


def optimizer_state_dict(model: nn.Module, optimizer, opt_state: Mapping,
                         step: int) -> tuple[dict, float]:
    """``vil_tpu``'s optax state ``opt_state`` (the trainer's ``{"inner",
    "lr_scale"}`` wrapper, or a bare chain) as the port's whole
    (replicated-format) state dict of ``optimizer`` over ``model``, and the
    plateau multiplier ``lr_scale``. ``step`` is the checkpoint's step, which
    a learning-rate schedule's count must equal: the port takes its LR from
    the step."""
    lr_scale = 1.0
    if isinstance(opt_state, Mapping) and set(opt_state) == {"inner", "lr_scale"}:
        lr_scale = float(np.asarray(opt_state["lr_scale"]))
        opt_state = opt_state["inner"]
    kind = type(optimizer).__name__
    if kind not in _MOMENTS:
        raise ValueError(f"the port's {kind} has no counterpart in vil_tpu's optimizers")
    fields, moments = _MOMENTS[kind]
    held = []
    for where, state in _chain_states(opt_state):
        keys = set(state)
        if keys == {"count"}:  # a schedule's count (scale_by_schedule)
            if int(np.asarray(state["count"])) != step:
                raise ValueError(f"{where}: the schedule's count {int(np.asarray(state['count']))} "
                                 f"!= the step {step}; the port takes the LR from the step")
            continue
        if keys != fields:
            raise ValueError(f"{where}: optax state with fields {sorted(keys)}; the port's "
                             f"{kind} keeps {sorted(fields)}")
        held.append(state)
    if len(held) != 1:
        raise ValueError(f"{len(held)} optax states with fields {sorted(fields)}; want 1 for the "
                         f"port's {kind}")
    state = held[0]
    for field in sorted(fields - {"count"}):
        if isinstance(state[field], Mapping) and state[field] and all(
                _GROUPED.fullmatch(k) for k in state[field]):
            raise NotImplementedError(
                "the optimizer state was written under TPU.FLAT_OPT or STACKED_OPT (moments "
                "by dtype group, not by parameter), which is not ported (ROADMAP.md §A, A13)")
    shapes = _whole_shapes(model)
    trees = {key: _whole_tree(state[field], shapes, f"{kind} {field}")
             for key, field in moments.items()}
    count = int(np.asarray(state["count"])) if "count" in state else None
    index = {id(p): i for i, p in enumerate(p for g in optimizer.param_groups
                                            for p in g["params"])}
    per_param = {}
    for name, p in model.named_parameters():
        if id(p) not in index:
            continue
        st = {key: tree[name] for key, tree in trees.items()}
        if kind == "Adam":  # torch keeps Adam's step as an f32 tensor on the host
            st["step"] = torch.tensor(float(count), dtype=torch.float32)
        elif kind == "Lamb":
            st["step"] = count
        per_param[index[id(p)]] = st
    if len(per_param) != len(index):
        raise KeyError("the optimizer holds parameters that the model does not name")
    return {"state": per_param, "param_groups": optimizer.state_dict()["param_groups"]}, lr_scale


def vil_tpu_payload(model: nn.Module, optimizer, payload: Mapping) -> dict:
    """A ``vil_tpu`` checkpoint's payload (``{"params", "opt_state",
    "buffers", "step"}``, as ``vil_tpu/utils/checkpoint.py`` writes it) as the
    port's whole-state payload: ``{"model": state dict, "optimizer": state
    dict, "step", "lr_scale"}``; with ``optimizer=None`` the model's alone
    (a load that does not resume takes the parameters and buffers only). A
    ResNet's ``batch_stats`` fill its BatchNorms' running statistics."""
    missing = {"params", "buffers", "step"} - set(payload)
    if missing or (optimizer is not None and "opt_state" not in payload):
        raise ValueError(f"not a vil_tpu checkpoint payload: keys {sorted(payload)}")
    collections = dict(payload["buffers"] or {})
    unknown = set(collections) - {"buffers", "batch_stats"}
    if unknown:
        raise ValueError(f"the checkpoint's collections {sorted(unknown)} have no port "
                         f"counterpart")
    out = {"model": model_state_dict(model, payload["params"], collections.get("buffers", {}),
                                     collections.get("batch_stats")),
           "step": int(np.asarray(payload["step"])), "lr_scale": 1.0}
    if optimizer is not None:
        out["optimizer"], out["lr_scale"] = optimizer_state_dict(
            model, optimizer, payload["opt_state"], out["step"])
    return out
