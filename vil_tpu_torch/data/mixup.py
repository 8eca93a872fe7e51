"""Mixup / CutMix on the device: counterpart of ``vil_tpu/data/mixup.py``.

timm ``Mixup`` semantics in batch mode: one λ per batch, a switch between
mixup and cutmix, labels folded into smoothed soft targets. The step is
split in two so that a test can feed the JAX package's draws into the port
(the two frameworks' random streams differ):

* :func:`sample_mixup` draws from a ``torch.Generator`` whether to apply,
  whether to cut, the mixup λ and the cutmix box, as 0-d tensors on the
  generator's device: nothing waits for the device;
* :func:`apply_mixup` blends the images and the targets from those draws,
  computing both branches and selecting, as the JAX package does.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import torch
import torch.nn.functional as F

_CANDIDATES = 32  # rejection-sampling proposals per Gamma draw


@dataclass
class MixupDraws:
    """One batch's draws; every field is a 0-d tensor."""

    apply: torch.Tensor       # bool: blend at all (probability ``prob``)
    use_cutmix: torch.Tensor  # bool: cutmix rather than mixup
    lam: torch.Tensor         # f32: the mixup λ ~ Beta(α, α)
    box: tuple                # int (y0, x0, y1, x1): the cutmix box, end exclusive


def one_hot(targets: torch.Tensor, num_classes: int, on: float, off: float) -> torch.Tensor:
    return F.one_hot(targets.long(), num_classes).float() * (on - off) + off


def _gamma(shape: float, generator: torch.Generator, device) -> torch.Tensor:
    """One Gamma(shape, 1) draw (Marsaglia and Tsang), as a 0-d f32 tensor.

    The rejection loop is unrolled over a fixed number of proposals and the
    first accepted one is kept, so there is no data-dependent host branch.
    Each proposal is accepted with probability above 0.95; all of them fail
    with probability below 1e-40. Shapes below 1 use Gamma(a+1)·U^(1/a)."""
    boost = shape < 1.0
    a = shape + 1.0 if boost else shape
    d = a - 1.0 / 3.0
    c = 1.0 / (9.0 * d) ** 0.5
    x = torch.randn(_CANDIDATES, generator=generator, device=device)
    u = torch.rand(_CANDIDATES, generator=generator, device=device)
    v = (1.0 + c * x) ** 3
    ok = (v > 0) & (torch.log(u) < 0.5 * x * x + d - d * v + d * torch.log(v.clamp(min=1e-30)))
    first = torch.argmax(ok.to(torch.int32))  # the first accepted proposal
    g = d * v[first]
    if boost:
        g = g * torch.rand((), generator=generator, device=device) ** (1.0 / shape)
    return g


def _beta(alpha: float, generator: torch.Generator, device) -> torch.Tensor:
    """One Beta(α, α) draw as X / (X + Y) with X, Y ~ Gamma(α)."""
    x = _gamma(alpha, generator, device)
    y = _gamma(alpha, generator, device)
    return x / (x + y)


def rand_bbox(h: int, w: int, lam: torch.Tensor, cy: torch.Tensor, cx: torch.Tensor):
    """CutMix box of area ratio about (1-λ) centred at (cy, cx), clipped to
    the image; returns (y0, x0, y1, x1), the JAX package's ``_rand_bbox``."""
    ratio = torch.sqrt(1.0 - lam.float())
    bh = (h * ratio).to(torch.int32)
    bw = (w * ratio).to(torch.int32)
    y0 = (cy - bh // 2).clamp(0, h)
    x0 = (cx - bw // 2).clamp(0, w)
    y1 = (cy + bh // 2).clamp(0, h)
    x1 = (cx + bw // 2).clamp(0, w)
    return y0, x0, y1, x1


def sample_mixup(generator: torch.Generator, h: int, w: int, mixup_alpha: float = 0.8,
                 cutmix_alpha: float = 1.0, prob: float = 1.0,
                 switch_prob: float = 0.5) -> MixupDraws:
    """Draw one batch's mixup / cutmix decisions for (h, w) images."""
    dev = generator.device
    u = torch.rand(2, generator=generator, device=dev)
    apply = u[0] < prob
    if cutmix_alpha <= 0:
        use_cutmix = torch.zeros((), dtype=torch.bool, device=dev)
    elif mixup_alpha <= 0:
        use_cutmix = torch.ones((), dtype=torch.bool, device=dev)
    else:
        use_cutmix = u[1] < switch_prob
    one = torch.ones((), device=dev)
    lam = _beta(mixup_alpha, generator, dev) if mixup_alpha > 0 else one
    lam_cut = _beta(cutmix_alpha, generator, dev) if cutmix_alpha > 0 else one
    cy = torch.randint(0, h, (), generator=generator, device=dev, dtype=torch.int32)
    cx = torch.randint(0, w, (), generator=generator, device=dev, dtype=torch.int32)
    return MixupDraws(apply, use_cutmix, lam, rand_bbox(h, w, lam_cut, cy, cx))


def apply_mixup(images: torch.Tensor, targets: torch.Tensor, draws: MixupDraws,
                num_classes: int, label_smoothing: float = 0.1):
    """Blend NHWC float ``images`` with the batch flipped, and turn integer
    ``targets`` into soft targets (B, num_classes) f32. Cutmix corrects λ to
    the box's true area."""
    b, h, w, _ = images.shape
    off = label_smoothing / num_classes
    on = 1.0 - label_smoothing + off
    y = one_hot(targets, num_classes, on, off)
    flipped = images.flip(0)

    lam_m = draws.lam.to(images.dtype)
    mixed_mix = images * lam_m + flipped * (1 - lam_m)

    y0, x0, y1, x1 = (t.to(images.device) for t in draws.box)
    yy = torch.arange(h, device=images.device)[None, :, None, None]
    xx = torch.arange(w, device=images.device)[None, None, :, None]
    in_box = (yy >= y0) & (yy < y1) & (xx >= x0) & (xx < x1)
    mixed_cut = torch.where(in_box, flipped, images)
    lam_cut = 1.0 - ((y1 - y0) * (x1 - x0)) / (h * w)

    use_cutmix = draws.use_cutmix.to(images.device)
    apply = draws.apply.to(images.device)
    mixed = torch.where(use_cutmix, mixed_cut, mixed_mix)
    lam = torch.where(use_cutmix, lam_cut.float(), draws.lam.float().to(images.device))
    y_out = y * lam + y.flip(0) * (1 - lam)
    return torch.where(apply, mixed, images), torch.where(apply, y_out, y)


def make_mixup_fn(mixup_alpha: float = 0.8, cutmix_alpha: float = 1.0, prob: float = 1.0,
                  switch_prob: float = 0.5, label_smoothing: float = 0.1,
                  num_classes: int = 1000) -> Callable:
    """Returns fn(generator, images NHWC, int targets) -> (images, soft targets)."""

    def mixup_fn(generator, images, targets):
        _, h, w, _ = images.shape
        draws = sample_mixup(generator, h, w, mixup_alpha, cutmix_alpha, prob, switch_prob)
        return apply_mixup(images, targets, draws, num_classes, label_smoothing)

    return mixup_fn


def mixup_from_cfg(cfg) -> Optional[Callable]:
    """Active when MIXUP_PROB > 0 and (MIXUP > 0 or MIXCUT > 0)."""
    aug = cfg.AUG
    if aug.MIXUP_PROB <= 0.0 or (aug.MIXUP <= 0.0 and aug.MIXCUT <= 0.0):
        return None
    return make_mixup_fn(mixup_alpha=aug.MIXUP, cutmix_alpha=aug.MIXCUT,
                         prob=aug.MIXUP_PROB, switch_prob=aug.MIXUP_SWITCH_PROB,
                         label_smoothing=cfg.LOSS.LABEL_SMOOTHING,
                         num_classes=cfg.DATA.NUM_CLASSES)
