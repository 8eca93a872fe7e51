"""Loss zoo: counterpart of ``vil_tpu/train/loss.py``.

Every criterion is a function ``(logits, targets) -> scalar`` in the dtype of
the logits (the train step passes f32). ``get_criterion`` keeps the JAX
package's dispatch, including the mixup rule: soft-target CE for training
and plain CE for eval when MIXUP_PROB > 0.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F

Criterion = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def cross_entropy_per_sample(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    logp = F.log_softmax(logits, dim=-1)
    return -logp.gather(-1, targets[:, None].long())[:, 0]


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean CE with integer labels."""
    return cross_entropy_per_sample(logits, targets).mean()


def label_smoothing_per_sample(logits: torch.Tensor, targets: torch.Tensor,
                               epsilon: float = 0.1) -> torch.Tensor:
    n = logits.shape[-1]
    uniform = -F.log_softmax(logits, dim=-1).sum(dim=-1) / n
    return epsilon * uniform + (1.0 - epsilon) * cross_entropy_per_sample(logits, targets)


def label_smoothing_cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                                  epsilon: float = 0.1) -> torch.Tensor:
    """ε·uniform + (1-ε)·nll."""
    n = logits.shape[-1]
    uniform = (-F.log_softmax(logits, dim=-1).sum(dim=-1)).mean() / n
    return epsilon * uniform + (1.0 - epsilon) * cross_entropy(logits, targets)


def soft_target_cross_entropy(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Soft-target CE for mixup; targets are distributions."""
    return (-targets * F.log_softmax(logits, dim=-1)).sum(dim=-1).mean()


def _bce_with_logits(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Elementwise binary CE with logits (numerically stable)."""
    return logits.clamp(min=0) - logits * targets + torch.log1p(torch.exp(-logits.abs()))


def focal_loss(logits: torch.Tensor, targets: torch.Tensor, alpha: float = 1.0,
               gamma: float = 0.5, normalize: bool = True) -> torch.Tensor:
    """Class-balanced focal loss; targets are multi-hot."""
    ce = _bce_with_logits(logits, targets)
    if gamma == 0.0:
        modulator = 1.0
    else:
        modulator = torch.exp(-gamma * targets * logits
                              - gamma * torch.log1p(torch.exp(-logits)))
    total = (alpha * modulator * ce).sum()
    return total / targets.sum() if normalize else total


def multi_softmax_cross_entropy(logits: torch.Tensor, soft_targets: torch.Tensor,
                                label_smoothing: float = 0.0) -> torch.Tensor:
    """Multi-label softmax CE with vectorised label smoothing."""
    if label_smoothing > 0.0:
        n = soft_targets.shape[-1]
        pos = (soft_targets > 0).to(soft_targets.dtype)
        pos_count = pos.sum(dim=-1, keepdim=True)
        neg_p = label_smoothing / (n - pos_count)
        pos_p = label_smoothing / pos_count.clamp(min=1)
        soft_targets = torch.where(pos > 0, soft_targets - pos_p, soft_targets + neg_p)
        soft_targets = torch.where(pos_count > 0, soft_targets, soft_targets * 0)
    logp = F.log_softmax(logits, dim=-1)
    return (-soft_targets * logp).sum() / soft_targets.sum()


def multilabel_soft_margin(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """``nn.MultiLabelSoftMarginLoss(reduction='sum')``."""
    per_class = targets * F.logsigmoid(logits) + (1 - targets) * F.logsigmoid(-logits)
    return (-per_class.mean(dim=-1)).sum()


def bce(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    return _bce_with_logits(logits, targets).mean()


def mse(preds: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    return (preds - targets).square().mean()


def get_per_sample_criterion(cfg) -> Optional[Criterion]:
    """Per-sample eval loss (for masked, padded eval batches); None for
    losses without a per-sample form (focal and multisoftmax normalise over
    the whole batch)."""
    name = cfg.LOSS.LOSS
    if name == "xentropy":
        if cfg.AUG.MIXUP_PROB > 0.0 or cfg.LOSS.LABEL_SMOOTHING <= 0.0:
            return cross_entropy_per_sample
        eps = cfg.LOSS.LABEL_SMOOTHING
        return lambda lo, t: label_smoothing_per_sample(lo, t, eps)
    if name == "sigmoid":
        return lambda lo, t: -(t * F.logsigmoid(lo) + (1 - t) * F.logsigmoid(-lo)).mean(dim=-1)
    if name == "bce":
        return lambda lo, t: _bce_with_logits(lo, t).mean(dim=-1)
    if name == "mse":
        return lambda lo, t: (lo - t).square().mean(dim=-1)
    return None


def get_criterion(cfg, train: bool = True) -> Criterion:
    """The JAX package's dispatch on LOSS.LOSS, LABEL_SMOOTHING and MIXUP_PROB."""
    name = cfg.LOSS.LOSS
    if cfg.AUG.MIXUP_PROB > 0.0 and name == "xentropy":
        return soft_target_cross_entropy if train else cross_entropy
    if cfg.LOSS.LABEL_SMOOTHING > 0.0 and name == "xentropy":
        eps = cfg.LOSS.LABEL_SMOOTHING
        return lambda lo, t: label_smoothing_cross_entropy(lo, t, eps)
    if name == "xentropy":
        return cross_entropy
    if name == "sigmoid":
        return multilabel_soft_margin
    if name == "focal":
        a, g, n = cfg.LOSS.FOCAL.ALPHA, cfg.LOSS.FOCAL.GAMMA, cfg.LOSS.FOCAL.NORMALIZE
        return lambda lo, t: focal_loss(lo, t, a, g, n)
    if name == "multisoftmax":
        return multi_softmax_cross_entropy
    if name == "bce":
        return bce
    if name == "mse":
        return mse
    raise ValueError(f"Unknown loss {name}")
