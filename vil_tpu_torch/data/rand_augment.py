"""RandAugment + RandomErasing (timm-equivalent training augmentation).

The reference wires timm's ``create_transform`` with
``rand-m9-mstd0.5-inc1`` + RandomErasing (reference build.py:35-57,
config/msvit.yaml AUG.TIMM_AUG). This is a from-scratch PIL/numpy
implementation of the same policy semantics: 2 layers, uniformly-chosen ops
applied with prob 0.5, gaussian-jittered magnitude (mstd), the
"increasing-severity" level maps (inc1), and pixel-mode RandomErasing after
normalization.
"""
from __future__ import annotations

import math
import random
import re
from typing import Callable

import numpy as np
from PIL import Image, ImageEnhance, ImageOps

from .transforms import (
    Compose,
    RandomHorizontalFlip,
    RandomResizedCrop,
    ToNormalizedArray,
    to_interp,
)

_FILL = (124, 116, 104)
_MAX_LEVEL = 10.0


def _randomly_negate(v):
    return -v if random.random() > 0.5 else v


# --- op implementations ----------------------------------------------------
def _shear_x(img, factor):
    return img.transform(img.size, Image.AFFINE, (1, factor, 0, 0, 1, 0),
                         fillcolor=_FILL)


def _shear_y(img, factor):
    return img.transform(img.size, Image.AFFINE, (1, 0, 0, factor, 1, 0),
                         fillcolor=_FILL)


def _translate_x(img, pct):
    pixels = pct * img.size[0]
    return img.transform(img.size, Image.AFFINE, (1, 0, pixels, 0, 1, 0),
                         fillcolor=_FILL)


def _translate_y(img, pct):
    pixels = pct * img.size[1]
    return img.transform(img.size, Image.AFFINE, (1, 0, 0, 0, 1, pixels),
                         fillcolor=_FILL)


def _rotate(img, degrees):
    return img.rotate(degrees, fillcolor=_FILL)


def _auto_contrast(img, _):
    return ImageOps.autocontrast(img)


def _invert(img, _):
    return ImageOps.invert(img)


def _equalize(img, _):
    return ImageOps.equalize(img)


def _solarize(img, thresh):
    return ImageOps.solarize(img, thresh)


def _solarize_add(img, add, thresh=128):
    arr = np.asarray(img, dtype=np.int32)
    added = np.clip(arr + add, 0, 255)
    return Image.fromarray(np.where(arr < thresh, added, arr).astype(np.uint8))


def _posterize(img, bits):
    if bits >= 8:
        return img
    return ImageOps.posterize(img, max(1, int(bits)))


def _color(img, factor):
    return ImageEnhance.Color(img).enhance(factor)


def _contrast(img, factor):
    return ImageEnhance.Contrast(img).enhance(factor)


def _brightness(img, factor):
    return ImageEnhance.Brightness(img).enhance(factor)


def _sharpness(img, factor):
    return ImageEnhance.Sharpness(img).enhance(factor)


# --- level maps ("increasing severity" variants, timm inc1) -----------------
def _lv_rotate(level):
    return _randomly_negate(level / _MAX_LEVEL * 30.0)


def _lv_shear(level):
    return _randomly_negate(level / _MAX_LEVEL * 0.3)


def _lv_translate(level):
    return _randomly_negate(level / _MAX_LEVEL * 0.45)


def _lv_enhance_inc(level):
    return 1.0 + _randomly_negate(level / _MAX_LEVEL * 0.9)


def _lv_posterize_inc(level):
    return 4 - int(level / _MAX_LEVEL * 4)


def _lv_solarize_inc(level):
    return 256 - int(level / _MAX_LEVEL * 256)


def _lv_solarize_add(level):
    return int(level / _MAX_LEVEL * 110)


_RAND_OPS = [
    ("AutoContrast", _auto_contrast, None),
    ("Equalize", _equalize, None),
    ("Invert", _invert, None),
    ("Rotate", _rotate, _lv_rotate),
    ("Posterize", _posterize, _lv_posterize_inc),
    ("Solarize", _solarize, _lv_solarize_inc),
    ("SolarizeAdd", _solarize_add, _lv_solarize_add),
    ("Color", _color, _lv_enhance_inc),
    ("Contrast", _contrast, _lv_enhance_inc),
    ("Brightness", _brightness, _lv_enhance_inc),
    ("Sharpness", _sharpness, _lv_enhance_inc),
    ("ShearX", _shear_x, _lv_shear),
    ("ShearY", _shear_y, _lv_shear),
    ("TranslateXRel", _translate_x, _lv_translate),
    ("TranslateYRel", _translate_y, _lv_translate),
]


class RandAugment:
    """timm 'rand-mN-mstdS[-incD]' policy."""

    def __init__(self, magnitude: float = 9, num_layers: int = 2,
                 mstd: float = 0.5, prob: float = 0.5):
        self.magnitude = magnitude
        self.num_layers = num_layers
        self.mstd = mstd
        self.prob = prob

    def __call__(self, img: Image.Image) -> Image.Image:
        for _ in range(self.num_layers):
            if random.random() > self.prob:
                continue
            name, op, level_fn = random.choice(_RAND_OPS)
            m = self.magnitude
            if self.mstd > 0:
                m = random.gauss(m, self.mstd)
            m = min(_MAX_LEVEL, max(0, m))
            arg = level_fn(m) if level_fn is not None else 0
            img = op(img, arg)
        return img


def parse_rand_augment(spec: str) -> RandAugment:
    """Parse e.g. 'rand-m9-mstd0.5-inc1'."""
    if not spec.startswith("rand"):
        raise ValueError(f"Unsupported auto_augment spec {spec!r}")
    magnitude, mstd, num_layers = 10.0, 0.0, 2
    for token in spec.split("-")[1:]:
        m = re.match(r"([a-z]+)([0-9.]+)", token)
        if not m:
            continue
        key, val = m.group(1), float(m.group(2))
        if key == "m":
            magnitude = val
        elif key == "mstd":
            mstd = val
        elif key == "n":
            num_layers = int(val)
        elif key == "inc":
            pass  # increasing level maps are the default here
        elif key == "p":
            pass
    return RandAugment(magnitude=magnitude, num_layers=num_layers, mstd=mstd)


class RandomErasing:
    """timm RandomErasing (pixel mode) on normalized HWC float arrays."""

    def __init__(self, prob: float = 0.25, mode: str = "pixel", count: int = 1,
                 min_area: float = 0.02, max_area: float = 1 / 3,
                 min_aspect: float = 0.3):
        self.prob = prob
        self.mode = mode
        self.count = count
        self.min_area = min_area
        self.max_area = max_area
        self.log_aspect = (math.log(min_aspect), math.log(1 / min_aspect))

    def __call__(self, arr: np.ndarray) -> np.ndarray:
        if random.random() > self.prob:
            return arr
        h, w, c = arr.shape
        area = h * w
        out = arr.copy()
        for _ in range(self.count):
            for _ in range(10):
                target = random.uniform(self.min_area, self.max_area) * area / self.count
                aspect = math.exp(random.uniform(*self.log_aspect))
                eh = int(round(math.sqrt(target * aspect)))
                ew = int(round(math.sqrt(target / aspect)))
                if eh < h and ew < w:
                    top = random.randint(0, h - eh)
                    left = random.randint(0, w - ew)
                    if self.mode == "pixel":
                        out[top:top + eh, left:left + ew] = np.random.randn(
                            eh, ew, c
                        ).astype(arr.dtype)
                    elif self.mode == "const":
                        out[top:top + eh, left:left + ew] = 0
                    else:  # 'rand': one random value per region
                        out[top:top + eh, left:left + ew] = np.random.randn()
                    break
        return out


class RandomFlips:
    def __init__(self, hflip: float = 0.5, vflip: float = 0.0):
        self.hflip = hflip
        self.vflip = vflip

    def __call__(self, img: Image.Image) -> Image.Image:
        if self.hflip > 0 and random.random() < self.hflip:
            img = img.transpose(Image.FLIP_LEFT_RIGHT)
        if self.vflip > 0 and random.random() < self.vflip:
            img = img.transpose(Image.FLIP_TOP_BOTTOM)
        return img


def build_timm_transform(cfg) -> Compose:
    """timm create_transform(is_training=True) equivalent
    (reference build.py:35-57)."""
    t = cfg.AUG.TIMM_AUG
    interp = to_interp(cfg.INPUT.INTERPOLATION)
    ts: list[Callable] = [
        RandomResizedCrop(
            cfg.INPUT.IMAGE_SIZE, scale=tuple(cfg.AUG.SCALE),
            ratio=tuple(cfg.AUG.RATIO), interpolation=interp,
        ),
        RandomFlips(t.get("HFLIP", 0.5), t.get("VFLIP", 0.0)),
    ]
    aa = t.get("AUTO_AUGMENT", None)
    if aa:
        ts.append(parse_rand_augment(aa))
    # timm disables separate color jitter when auto-augment is active
    ts.append(ToNormalizedArray(cfg.INPUT.MEAN, cfg.INPUT.STD))
    re_prob = t.get("RE_PROB", 0.0)
    if re_prob > 0:
        ts.append(
            RandomErasing(
                prob=re_prob,
                mode=t.get("RE_MODE", "pixel"),
                count=t.get("RE_COUNT", 1),
            )
        )
    return Compose(ts)
