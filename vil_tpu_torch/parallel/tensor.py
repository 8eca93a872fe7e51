"""Parameter sharding: tensor parallelism over heads (Megatron's cut) on a
``model`` axis, and FSDP over the ``data`` axis.

Counterpart of ``vil_tpu/parallel/tensor.py`` and of ``fsdp_sharding`` in
``vil_tpu/parallel/mesh.py``. There, both are sharding annotations that
GSPMD turns into collectives, and ``shard_map`` puts the Pallas kernels on
each model rank's heads. PyTorch has no GSPMD, so the port builds each
rank's shard of the model and writes the collectives by hand:

**Tensor parallelism** (``TPU.PARAM_SHARDING 'tp'``). A layer built with a
:class:`TensorParallel` context of n ranks holds this rank's part of its
weights:

* column-parallel ``qkv``, ``query``, ``kv``, ``query_global``,
  ``kv_global``, ``fc1``: this rank's output features, i.e. its H/n heads.
  A packed projection (``qkv`` 3C, ``kv`` and ``kv_global`` 2C) splits by
  block: rank r holds its slice of q, of k and of v, packed in that order,
  so ``Linear.part`` cuts the local weight as it cuts the whole one;
* row-parallel ``proj``, ``proj_global``, ``fc2``: this rank's input
  features; the partial products are summed over the model group and the
  bias is added once, after the sum.

The input of a column-parallel layer passes :meth:`TensorParallel.copy`
(identity forward, all-reduce of the gradient backward), the output of a
row-parallel one :meth:`TensorParallel.reduce` (all-reduce forward,
identity backward). Everything outside those regions (patch embeddings,
LayerNorms, the head, the residual stream) computes the same values on
every model rank, and its parameters get the same, whole gradient there. A
layer whose heads (or hidden features) do not divide by n keeps its weights
whole and computes whole on every model rank, logged once, as ``_tp_spec``
falls back to replicated. The relative-position tables stay whole and each
split layer reads its heads' columns, and the linformer's sequence
projections stay whole and each split layer applies them to its heads'
channels, so each model rank holds a part of their gradient: the training
step sums those over the model group (:meth:`MsViT.partial_over_model`,
``parallel.average_gradients``) and every other gradient over the data
replicas alone. The attention families (``models/attention_efficient.py``)
and the unshared global weights use the same names and the same cuts.

**FSDP** (``TPU.PARAM_SHARDING 'fsdp'``, :class:`FullyShardedParams`). A
parameter of at least ``min_size`` elements that divides by the data axis
is held, with its optimizer moments, as this rank's 1/D slice between
steps, along the dimension ``vil_tpu``'s rule picks (:func:`fsdp_dim`).
Each block's parameters are all-gathered in one collective before the
block runs and stay gathered until the step's end; after the backward their
gradients are reduce-scattered, averaged over the replicas, onto the
shards, and the gathered copies are let go. Beside a spatial axis the data
group is that of a rank's spatial index, and each rank's row-partial
gradients are summed over the spatial group before the reduce-scatter.
Written by hand over
``torch.distributed`` (``all_gather_into_tensor``, ``reduce_scatter_tensor``:
``nccl``, and ``gloo`` on CPU and CUDA tensors alike).

Both kinds of shard are described leaf by leaf by a :class:`Shard` in the
model's ``param_shards`` (its plan). Checkpoints (:func:`full_state_dict`,
:func:`load_full_state_dict` and their optimizer counterparts) gather the
whole state in the format of a replicated run and give each rank its
slice, so a sharded run and a replicated one resume each other.
"""
from __future__ import annotations

import functools
import logging
import math
from dataclasses import dataclass
from typing import Any, Iterable, Optional

import torch
import torch.distributed as dist
from torch import nn

from .collectives import get_rank, get_world_size, is_distributed

logger = logging.getLogger(__name__)

# Linear layers whose OUTPUT features are split (column parallel) and whose
# INPUT features are split (row parallel), by their flax module names
# (``vil_tpu``'s COLUMN_PARALLEL lacks query_global and kv_global: it keeps
# them whole, where the port cuts them as the shared ones are cut; the math
# and the whole-state checkpoints are the same)
COLUMN_PARALLEL = ("qkv", "query", "kv", "query_global", "kv_global", "fc1")
ROW_PARALLEL = ("proj", "proj_global", "fc2")
# packed projections: the output concatenates q/k/v (k/v) blocks, each split
PACK_FACTOR = {"qkv": 3, "kv": 2, "kv_global": 2}
FSDP_MIN_SIZE = 2 ** 14  # vil_tpu's fsdp_sharding default


# ---------------------------------------------------------------- collectives

def wide(*dtypes: torch.dtype) -> torch.dtype:
    """The type a sum over ranks of values of ``dtypes`` is taken in: f32,
    or f64 where one of them is f64."""
    return functools.reduce(torch.promote_types, dtypes, torch.float32)


def _all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``t`` over ``group``, taken in at least f32 and returned
    in t's type."""
    out = t.to(wide(t.dtype)).contiguous().clone()
    dist.all_reduce(out, group=group)
    return out.to(t.dtype)


class _CopyToModel(torch.autograd.Function):
    """Identity forward; the backward sums the gradient over the model group
    (each rank's columns gave a part of the input's gradient)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    """The sum of the partial products over the model group forward; the
    gradient of the sum reaches every partial as it is."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SumOverGroup(torch.autograd.Function):
    """The sum over a group forward and backward: each rank's value enters
    every rank's sum, so each rank's input gradient sums every rank's
    upstream gradient."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


def sum_over(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over the ranks of ``group`` (the default group when
    None), differentiably: the BatchNorm statistics of the global batch on a
    data axis (``models/resnet.py``)."""
    return _SumOverGroup.apply(x, group)


def all_gather_flat(local: torch.Tensor, group) -> list[torch.Tensor]:
    """Every rank's equal-length flat ``local``, in rank order."""
    size = dist.get_world_size(group)
    out = local.new_empty(size * local.numel())
    dist.all_gather_into_tensor(out, local.contiguous(), group=group)
    return list(out.chunk(size))


def reduce_scatter_flat(flat: torch.Tensor, group) -> torch.Tensor:
    """This rank's block of the sum over ``group`` of the flat ``flat``, cut
    into as many equal blocks as the group has ranks."""
    out = flat.new_empty(flat.numel() // dist.get_world_size(group))
    dist.reduce_scatter_tensor(out, flat.contiguous(), group=group)
    return out


# ---------------------------------------------------------------- the plan

@dataclass(frozen=True)
class Shard:
    """How a parameter is cut: along ``dim`` into ``size`` parts, this rank
    holding part ``rank`` of each of ``pack`` equal blocks (a packed
    projection's q, k, v), over the process group ``group``."""

    dim: int
    size: int
    rank: int
    group: Any = None
    pack: int = 1

    def local(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's part of the whole tensor ``full``."""
        return self.local_of(full, self.rank)

    def local_of(self, full: torch.Tensor, rank: int) -> torch.Tensor:
        """Rank ``rank``'s part of the whole tensor ``full``."""
        blocks = full.chunk(self.pack, self.dim)
        return torch.cat([b.chunk(self.size, self.dim)[rank] for b in blocks], self.dim)

    def full_shape(self, local_shape) -> tuple:
        shape = list(local_shape)
        shape[self.dim] *= self.size
        return tuple(shape)

    def assemble(self, parts: list) -> torch.Tensor:
        """The whole tensor from every rank's part, in rank order."""
        blocks = [p.chunk(self.pack, self.dim) for p in parts]
        return torch.cat([torch.cat([b[i] for b in blocks], self.dim)
                          for i in range(self.pack)], self.dim)

    def gather(self, local: torch.Tensor) -> torch.Tensor:
        """The whole tensor, on every rank of the group (a collective); as
        it is without a process group."""
        if not is_distributed():
            return local
        flat = all_gather_flat(local.detach().reshape(-1), self.group)
        return self.assemble([f.view(local.shape) for f in flat])


@dataclass(frozen=True)
class TensorParallel:
    """This rank's place in the model group: rank ``rank`` of ``size``."""

    group: Optional[dist.ProcessGroup]
    size: int
    rank: int

    @classmethod
    def of(cls, group=None) -> "TensorParallel":
        return cls(group, get_world_size(group), get_rank(group))

    def splits(self, n: int, what: str) -> bool:
        """Whether ``n`` heads or features of the layer ``what`` divide over
        the group; a layer that does not keeps its weights whole (logged)."""
        if self.size <= 1:
            return False
        if n % self.size == 0:
            return True
        logger.warning("tp: %s stays whole: %d does not divide by the model axis (%d); it "
                       "computes whole on every model rank", what, n, self.size)
        return False

    def copy(self, x):
        """Identity; the gradient summed over the model group (before a
        column-parallel layer). None passes."""
        if x is None or not is_distributed():
            return x
        return _CopyToModel.apply(x, self.group)

    def reduce(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of the partial products over the model group (after a
        row-parallel layer), in f32 (f64 for f64)."""
        x = x.to(wide(x.dtype))
        if not is_distributed():
            return x
        return _ReduceFromModel.apply(x, self.group)

    def heads(self, num_heads: int) -> slice:
        """This rank's heads of ``num_heads``."""
        n = num_heads // self.size
        return slice(self.rank * n, (self.rank + 1) * n)


def tp_plan(model: nn.Module) -> dict:
    """{parameter name: :class:`Shard` or None} of a model built with a
    tensor-parallel context: the Megatron cut of each split Linear, None
    (whole) for every other parameter."""
    shards = getattr(model, "param_shards", {})
    return {name: shards.get(name) for name, _ in model.named_parameters()}


def _flax_order(name: str, ndim: int) -> list[int]:
    """The port's dimensions of a parameter in the order of its flax leaf:
    a Linear weight (out, in) is flax's (in, out), a Conv2d weight (O, I, kh,
    kw) flax's (kh, kw, I, O)."""
    if name.endswith("weight") and ndim == 2:
        return [1, 0]
    if name.endswith("weight") and ndim == 4:
        return [2, 3, 1, 0]
    return list(range(ndim))


def fsdp_dim(name: str, shape, size: int, min_size: int = FSDP_MIN_SIZE) -> Optional[int]:
    """The dimension of the port's parameter ``name`` of ``shape`` that FSDP
    over ``size`` ranks cuts, or None (replicated): ``vil_tpu``'s rule, the
    largest dimension that divides by ``size`` (on a tie the later one) of a
    leaf of at least ``min_size`` elements, taken on the flax layout of the
    same leaf, so that both packages cut the same axis."""
    if not len(shape) or math.prod(shape) < min_size:
        return None
    order = _flax_order(name, len(shape))
    cands = [(shape[d], i) for i, d in enumerate(order) if shape[d] % size == 0]
    if not cands:
        return None
    return order[max(cands)[1]]


def fsdp_plan(model: nn.Module, size: int, min_size: int = FSDP_MIN_SIZE) -> dict:
    """{parameter name: dimension FSDP over ``size`` ranks cuts, or None}."""
    return {name: fsdp_dim(name, tuple(p.shape), size, min_size)
            for name, p in model.named_parameters()}


# ---------------------------------------------------------------- FSDP

class FullyShardedParams:
    """FSDP of ``model`` over the data ``group`` (the default group when
    None): each parameter of :func:`fsdp_plan` becomes this rank's slice,
    the same ``nn.Parameter`` holding it (its ``.data`` swapped), so that
    an optimizer built afterwards keeps its moments at the slice's size.

    A forward pre-hook on each block (each child of the model) gathers its
    sliced parameters in one all-gather; :meth:`reduce_scatter_gradients`
    (the training step, after the backward) sums their gradients over the
    group onto the slices, divided by ``data_size``, and :meth:`release`
    returns every parameter to its slice (the eval step, after the
    forward). ``model.param_shards`` gets each slice's :class:`Shard`."""

    def __init__(self, model: nn.Module, group=None, min_size: int = FSDP_MIN_SIZE):
        self.model, self.group = model, group
        self.size, self.rank = get_world_size(group), get_rank(group)
        plan = fsdp_plan(model, self.size, min_size)
        params = dict(model.named_parameters())
        self.shards = {n: Shard(d, self.size, self.rank, group)
                       for n, d in plan.items() if d is not None}
        self.params = {n: params[n] for n in self.shards}
        self.local = {}  # name → this rank's slice, while the parameter is gathered
        with torch.no_grad():
            for n, p in self.params.items():
                p.data = self.shards[n].local(p.data).contiguous()
        shards = dict(getattr(model, "param_shards", {}))
        shards.update(self.shards)
        model.param_shards = shards
        model.fsdp = self
        # the blocks: each child of the model gathers its own parameters
        self.units = []
        for child_name, child in model.named_children():
            names = [f"{child_name}.{n}" for n, _ in child.named_parameters()]
            unit = [n for n in names if n in self.shards]
            if unit:
                self.units.append(unit)
                child.register_forward_pre_hook(self._gather_hook(unit))
        # parameters of the model itself, outside any child
        top = [n for n, _ in model.named_parameters(recurse=False) if n in self.shards]
        if top:
            self.units.append(top)
            model.register_forward_pre_hook(self._gather_hook(top))

    def _gather_hook(self, names):
        def hook(module, args):
            self.gather(names)
        return hook

    @torch.no_grad()
    def gather(self, names: Iterable[str]) -> None:
        """All-gather the slices of ``names`` not gathered yet, in one
        collective."""
        names = [n for n in names if n not in self.local]
        if not names:
            return
        flat = torch.cat([self.params[n].data.reshape(-1) for n in names])
        parts = all_gather_flat(flat, self.group) if is_distributed() else [flat]
        sizes = [self.params[n].numel() for n in names]
        pieces = [p.split(sizes) for p in parts]  # by rank, then by name
        for i, n in enumerate(names):
            p = self.params[n]
            self.local[n] = p.data
            p.data = self.shards[n].assemble([pr[i].view(p.shape) for pr in pieces])

    @torch.no_grad()
    def release(self) -> None:
        """Every gathered parameter back to its slice."""
        for n, local in self.local.items():
            self.params[n].data = local
        self.local = {}

    @torch.no_grad()
    def reduce_scatter_gradients(self, divide: int, partial_group=None) -> None:
        """The gathered parameters' gradients summed over the group in one
        reduce-scatter, divided by ``divide`` (the data replicas, times the
        spatial ranks beside a spatial axis), onto the slices; then
        every parameter back to its slice with its slice's gradient. With a
        ``partial_group`` (the spatial group, on a mesh with a spatial axis)
        each rank holds a part of every gradient: they are summed over it in
        one all-reduce first."""
        names = [n for n in self.local if self.params[n].grad is not None]
        if names:
            dtype = wide(*(self.params[n].grad.dtype for n in names))
            if partial_group is not None and get_world_size(partial_group) > 1:
                grads = [self.params[n].grad for n in names]
                flat = torch.cat([g.reshape(-1).to(dtype) for g in grads])
                dist.all_reduce(flat, group=partial_group)
                for g, part in zip(grads, flat.split([g.numel() for g in grads])):
                    g.copy_(part.view_as(g))
            # rank-major: block r holds every parameter's part r, flat, in
            # f32 (f64 when a gradient is f64)
            send = torch.cat([torch.cat([
                self.shards[n].local_of(self.params[n].grad, r).reshape(-1).to(dtype)
                for n in names]) for r in range(self.size)])
            mine = reduce_scatter_flat(send, self.group) if is_distributed() else send
            mine /= divide
            sizes = [self.local[n].numel() for n in names]
            grads = {n: g.view(self.local[n].shape).to(self.params[n].grad.dtype)
                     for n, g in zip(names, mine.split(sizes))}
        else:
            grads = {}
        for n in grads:
            self.params[n].grad = None
        self.release()
        for n, g in grads.items():
            self.params[n].grad = g


# ---------------------------------------------------------------- checkpoints

def full_state_dict(model: nn.Module) -> dict:
    """``model.state_dict()`` with every sharded parameter whole (a
    collective over its group, on every rank): the format of a replicated
    run."""
    shards = getattr(model, "param_shards", {})
    state = model.state_dict()
    return {k: shards[k].gather(v) if k in shards else v for k, v in state.items()}


@torch.no_grad()
def load_full_state_dict(model: nn.Module, state: dict) -> None:
    """Fill ``model`` from a whole (replicated-format) state dict, each
    sharded parameter taking its slice."""
    shards = getattr(model, "param_shards", {})
    model.load_state_dict({k: shards[k].local(v) if k in shards else v
                           for k, v in state.items()})


def _param_shards_by_index(model: nn.Module, optimizer) -> dict:
    """{index in the optimizer's state dict: Shard} of the sharded
    parameters: the optimizer numbers its parameters group by group."""
    shards = getattr(model, "param_shards", {})
    by_id = {id(p): shards[n] for n, p in model.named_parameters() if n in shards}
    params = [p for g in optimizer.param_groups for p in g["params"]]
    return {i: by_id[id(p)] for i, p in enumerate(params) if id(p) in by_id}


def full_optimizer_state(optimizer, model: nn.Module) -> dict:
    """``optimizer.state_dict()`` with the moments of sharded parameters
    whole (a collective, on every rank)."""
    sd = optimizer.state_dict()
    shards = _param_shards_by_index(model, optimizer)
    state = {}
    for i, st in sd["state"].items():
        s = shards.get(i)
        state[i] = {k: (s.gather(v) if s is not None and torch.is_tensor(v) and v.dim() > 0
                        else v) for k, v in st.items()}
    return {"state": state, "param_groups": sd["param_groups"]}


def load_full_optimizer_state(optimizer, model: nn.Module, sd: dict) -> None:
    """Load a whole (replicated-format) optimizer state dict, each sharded
    parameter's moments taking their slice."""
    shards = _param_shards_by_index(model, optimizer)
    state = {}
    for i, st in sd["state"].items():
        s = shards.get(int(i))
        state[i] = {k: (s.local(v) if s is not None and torch.is_tensor(v) and v.dim() > 0
                        else v) for k, v in st.items()}
    optimizer.load_state_dict({"state": state, "param_groups": sd["param_groups"]})


def param_bytes(model: nn.Module, optimizer=None) -> tuple[int, int]:
    """(bytes of the parameters, bytes of the optimizer's tensors) this
    rank holds."""
    params = sum(p.numel() * p.element_size() for p in model.parameters())
    moments = 0
    if optimizer is not None:
        for st in optimizer.state.values():
            moments += sum(v.numel() * v.element_size() for v in st.values()
                           if torch.is_tensor(v) and v.dim() > 0)
    return params, moments
