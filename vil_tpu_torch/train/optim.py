"""Optimizers: counterpart of ``vil_tpu/train/optim.py``.

``get_opt`` builds a ``torch.optim`` optimizer with the JAX package's two
weight-decay groups: parameters whose name holds one of the model's no-decay
substrings get WD0, the rest get WD. optax's ``adamw`` is
``torch.optim.AdamW`` (bias-corrected moments, eps outside the square root,
decay decoupled and applied to the pre-update parameter, both scaled by the
same LR); optax's WD0 is a coupled L2 term on the no-decay group, which is
``decoupled_weight_decay=False`` on that group. ``adam`` and ``sgd`` take WD
and WD0 as coupled L2, as the JAX package's do.

Not ported yet: ``qhm`` and ``lamb``; the TPU layout knobs FLAT_OPT and
STACKED_OPT have no counterpart here.
"""
from __future__ import annotations

from typing import Union

import torch
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
        return torch.optim.AdamW(param_groups(model, wd, wd0, decoupled=True), lr=lr,
                                 betas=betas, eps=eps)
    if name in ("qhm", "lamb"):
        raise NotImplementedError(f"optimizer {name!r} is not ported yet")
    raise ValueError(f"Optimizer {name} not supported!")

