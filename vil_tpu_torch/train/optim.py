"""Optimizers: counterpart of ``vil_tpu/train/optim.py``.

``get_opt`` builds a ``torch.optim`` optimizer with the JAX package's two
weight-decay groups: parameters whose name holds one of the model's no-decay
substrings get WD0, the rest get WD. optax's ``adamw`` is
``torch.optim.Adam`` with ``decoupled_weight_decay`` (torch's AdamW:
bias-corrected moments, eps outside the square root, decay decoupled and
applied to the pre-update parameter, both scaled by the same LR); optax's WD0
is a coupled L2 term on the no-decay group, which is
``decoupled_weight_decay=False`` on that group (``torch.optim.AdamW`` itself
would set it True again when a checkpoint is loaded). ``adam`` and ``sgd`` take WD
and WD0 as coupled L2, as the JAX package's do. ``qhm`` and ``lamb`` are the
JAX package's optax transforms as ``torch.optim.Optimizer`` subclasses
(:class:`QHM`, :class:`Lamb`), in plain PyTorch.

The plateau drop of the trainer (``vil_tpu``'s ``lr_scalable`` and
``drop_lr``, which scale every update) is the train step's ``lr_scale``,
which multiplies every group's LR from the schedule (:func:`drop_lr`).

Under parameter sharding (TPU.PARAM_SHARDING 'tp' or 'fsdp') each rank
holds its shard of a cut parameter and of its moments. AdamW, Adam, SGD and
QHM act elementwise and need nothing more; LAMB's trust ratio takes the
norms of whole tensors, so it sums the squares of a cut parameter's shards
over their group (``model.param_shards``).

The TPU layout knobs FLAT_OPT and STACKED_OPT have no counterpart here
(``train.trainer.check_ported`` refuses them).
"""
from __future__ import annotations

from typing import Union

import torch
import torch.distributed as dist
from torch import nn

from ..models.msvit import NO_WEIGHT_DECAY_SUBSTRINGS


def decay_mask(model: nn.Module, no_decay_substrings=NO_WEIGHT_DECAY_SUBSTRINGS
               ) -> dict[str, bool]:
    """{parameter name: True where weight decay applies}."""
    return {name: not any(nd in name for nd in no_decay_substrings)
            for name, _ in model.named_parameters()}


def param_groups(model: nn.Module, wd: float, wd0: float, decoupled: bool = False) -> list:
    """The decay group (weight decay ``wd``) and the no-decay group (``wd0``,
    coupled L2 whatever ``decoupled`` says of the decay group)."""
    mask = decay_mask(model)
    params = dict(model.named_parameters())
    decay = [p for n, p in params.items() if mask[n]]
    no_decay = [p for n, p in params.items() if not mask[n]]
    groups = [{"params": decay, "weight_decay": wd}]
    if no_decay:
        groups.append({"params": no_decay, "weight_decay": wd0})
        if decoupled:
            groups[-1]["decoupled_weight_decay"] = False
    return groups


def get_opt(cfg, model: nn.Module, lr: Union[float, None] = None) -> torch.optim.Optimizer:
    """The optimizer of ``cfg.OPTIM`` over ``model``'s parameters, at the
    constant ``lr`` (default OPTIM.LR); a schedule is applied by the train
    step, which sets each group's LR before every update."""
    lr = cfg.OPTIM.LR if lr is None else lr
    name = cfg.OPTIM.OPT
    wd, wd0 = cfg.OPTIM.WD, cfg.OPTIM.WD0
    betas = (cfg.OPTIM.ADAM.BETA1, cfg.OPTIM.ADAM.BETA2)
    eps = cfg.OPTIM.ADAM.EPS
    if name == "sgd":  # coupled L2 before momentum, no dampening
        return torch.optim.SGD(param_groups(model, wd, wd0), lr=lr, momentum=cfg.OPTIM.MOM)
    if name == "adam":  # coupled L2
        return torch.optim.Adam(param_groups(model, wd, wd0), lr=lr, betas=betas, eps=eps)
    if name == "adamw":
        # torch's AdamW, whose load_state_dict sets every group decoupled, is
        # Adam with decoupled_weight_decay: a resumed run keeps WD0 coupled
        return torch.optim.Adam(param_groups(model, wd, wd0, decoupled=True), lr=lr,
                                betas=betas, eps=eps, decoupled_weight_decay=True)
    if name == "qhm":  # L2 on the decay group only: no WD0, as the JAX package's
        groups = param_groups(model, wd, 0.0)
        return QHM(groups, lr=lr, momentum=cfg.OPTIM.MOM, nu=cfg.OPTIM.NU)
    if name == "lamb":
        groups = param_groups(model, wd, 0.0)
        if len(groups) > 1:
            groups[1]["l2"] = wd0  # WD0: coupled L2 on the no-decay group
        shards = getattr(model, "param_shards", {})
        cut = {id(p): shards[n].group for n, p in model.named_parameters() if n in shards}
        return Lamb(groups, lr=lr, betas=betas, eps=eps, cut=cut)
    raise ValueError(f"Optimizer {name} not supported!")


class QHM(torch.optim.Optimizer):
    """Quasi-hyperbolic momentum (the reference's qhm.py:8-124) with coupled
    L2 weight decay, as ``vil_tpu.train.optim.qhm``:

        g ← g + wd·p,  h ← (1-β)·g + β·h,  d ← (1-ν)·g + ν·h,  p ← p - lr·d
    """

    def __init__(self, params, lr: float, momentum: float = 0.9, nu: float = 1.0,
                 weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, momentum=momentum, nu=nu,
                                      weight_decay=weight_decay))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            beta, nu, wd, lr = group["momentum"], group["nu"], group["weight_decay"], group["lr"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad + wd * p if wd else p.grad
                state = self.state[p]
                if "h" not in state:
                    state["h"] = torch.zeros_like(p)
                h = state["h"]
                h.copy_((1 - beta) * g + beta * h)
                p.add_((1 - nu) * g + nu * h, alpha=-lr)


class Lamb(torch.optim.Optimizer):
    """LAMB as ``optax.lamb``: Adam's bias-corrected direction m̂ / (√v̂ + ε),
    plus ``weight_decay``·p, scaled per tensor by the trust ratio ‖p‖ / ‖u‖
    (1 where either norm is 0), then by -lr. ``l2`` adds a coupled L2 term
    to the gradient first (the JAX package's WD0 on the no-decay group).
    ``cut`` maps the id of a parameter held as a shard to its process group:
    its norms are those of the whole tensor, the squares summed over the
    group."""

    def __init__(self, params, lr: float, betas=(0.9, 0.999), eps: float = 1e-6,
                 weight_decay: float = 0.0, l2: float = 0.0, cut: dict = None):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps,
                                      weight_decay=weight_decay, l2=l2))
        self.cut = cut or {}

    def _norm(self, p: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        """‖t‖ of the whole tensor that ``t`` is p's shard of."""
        if id(p) not in self.cut or not dist.is_initialized():
            return t.norm()
        sq = t.float().square().sum()
        dist.all_reduce(sq, group=self.cut[id(p)])
        return sq.sqrt().to(t.dtype)

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            (b1, b2), eps, lr = group["betas"], group["eps"], group["lr"]
            wd, l2 = group["weight_decay"], group["l2"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad + l2 * p if l2 else p.grad
                state = self.state[p]
                if not state:
                    state["step"] = 0
                    state["m"] = torch.zeros_like(p)
                    state["v"] = torch.zeros_like(p)
                state["step"] += 1
                t = state["step"]
                m, v = state["m"], state["v"]
                m.copy_((1 - b1) * g + b1 * m)
                v.copy_((1 - b2) * g.square() + b2 * v)
                u = (m / (1 - b1 ** t)) / ((v / (1 - b2 ** t)).sqrt() + eps)
                if wd:
                    u = u + wd * p
                p_norm, u_norm = self._norm(p, p), self._norm(p, u)
                ratio = torch.where((p_norm == 0) | (u_norm == 0), torch.ones_like(p_norm),
                                    p_norm / u_norm)
                p.add_(u * ratio, alpha=-lr)


def drop_lr(step, factor: float) -> None:
    """The plateau drop: divide the train step's ``lr_scale`` by ``factor``
    (``vil_tpu.train.trainer.drop_lr`` on its ``lr_scalable`` state)."""
    step.lr_scale = step.lr_scale / factor

