"""Image transforms (the reference's dat/transforms/build.py); a copy of
``vil_tpu/data/transforms.py``.

PIL + numpy reimplementations of the torchvision/timm transforms the
reference uses, producing float32 HWC arrays (the models' NHWC layout, the
normalize folded in). The timm training path (RandAugment + RandomErasing)
lives in rand_augment.py.

INPUT.INTERPOLATION uses PIL codes like the reference: 2=bilinear, 3=bicubic.
"""
from __future__ import annotations

import math
import random
from typing import Callable, Sequence

import numpy as np
from PIL import Image, ImageFilter

_PIL_INTERP = {
    0: Image.NEAREST,
    2: Image.BILINEAR,
    3: Image.BICUBIC,
    4: Image.BOX,
    5: Image.HAMMING,
    1: Image.LANCZOS,
}


def to_interp(code: int):
    return _PIL_INTERP.get(int(code), Image.BILINEAR)


class Compose:
    def __init__(self, transforms: Sequence[Callable]):
        self.transforms = list(transforms)

    def __call__(self, img):
        for t in self.transforms:
            img = t(img)
        return img


class Resize:
    """Short-side resize (torchvision T.Resize with int size)."""

    def __init__(self, size: int, interpolation=Image.BILINEAR):
        self.size = size
        self.interpolation = interpolation

    def __call__(self, img: Image.Image) -> Image.Image:
        w, h = img.size
        if (w <= h and w == self.size) or (h <= w and h == self.size):
            return img
        if w < h:
            ow = self.size
            oh = int(self.size * h / w)
        else:
            oh = self.size
            ow = int(self.size * w / h)
        return img.resize((ow, oh), self.interpolation)


class CenterCrop:
    def __init__(self, size: int):
        self.size = size

    def __call__(self, img: Image.Image) -> Image.Image:
        w, h = img.size
        th = tw = self.size
        i = int(round((h - th) / 2.0))
        j = int(round((w - tw) / 2.0))
        return img.crop((j, i, j + tw, i + th))


class RandomCrop:
    def __init__(self, size, padding: int = 0):
        self.size = size if isinstance(size, tuple) else (size, size)
        self.padding = padding

    def __call__(self, img: Image.Image) -> Image.Image:
        if self.padding:
            canvas = Image.new(
                img.mode,
                (img.size[0] + 2 * self.padding, img.size[1] + 2 * self.padding),
            )
            canvas.paste(img, (self.padding, self.padding))
            img = canvas
        w, h = img.size
        th, tw = self.size
        if w == tw and h == th:
            return img
        i = random.randint(0, max(0, h - th))
        j = random.randint(0, max(0, w - tw))
        return img.crop((j, i, j + tw, i + th))


class RandomResizedCrop:
    """torchvision RandomResizedCrop semantics (scale/ratio sampling)."""

    def __init__(self, size: int, scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3),
                 interpolation=Image.BILINEAR):
        self.size = size
        self.scale = scale
        self.ratio = ratio
        self.interpolation = interpolation

    def __call__(self, img: Image.Image) -> Image.Image:
        w, h = img.size
        area = w * h
        for _ in range(10):
            target_area = area * random.uniform(*self.scale)
            log_ratio = (math.log(self.ratio[0]), math.log(self.ratio[1]))
            aspect = math.exp(random.uniform(*log_ratio))
            cw = int(round(math.sqrt(target_area * aspect)))
            ch = int(round(math.sqrt(target_area / aspect)))
            if 0 < cw <= w and 0 < ch <= h:
                j = random.randint(0, w - cw)
                i = random.randint(0, h - ch)
                return img.crop((j, i, j + cw, i + ch)).resize(
                    (self.size, self.size), self.interpolation
                )
        # fallback: center crop to in-bounds aspect
        in_ratio = w / h
        if in_ratio < self.ratio[0]:
            cw, ch = w, int(round(w / self.ratio[0]))
        elif in_ratio > self.ratio[1]:
            ch, cw = h, int(round(h * self.ratio[1]))
        else:
            cw, ch = w, h
        j, i = (w - cw) // 2, (h - ch) // 2
        return img.crop((j, i, j + cw, i + ch)).resize(
            (self.size, self.size), self.interpolation
        )


class RandomHorizontalFlip:
    def __init__(self, p: float = 0.5):
        self.p = p

    def __call__(self, img: Image.Image) -> Image.Image:
        if random.random() < self.p:
            return img.transpose(Image.FLIP_LEFT_RIGHT)
        return img


class RandomApply:
    def __init__(self, transforms: Sequence[Callable], p: float):
        self.transforms = list(transforms)
        self.p = p

    def __call__(self, img):
        if random.random() < self.p:
            for t in self.transforms:
                img = t(img)
        return img


class ColorJitter:
    """brightness/contrast/saturation/hue jitter (torchvision semantics)."""

    def __init__(self, brightness=0, contrast=0, saturation=0, hue=0):
        self.brightness = brightness
        self.contrast = contrast
        self.saturation = saturation
        self.hue = hue

    @staticmethod
    def _factor(amount):
        return random.uniform(max(0, 1 - amount), 1 + amount)

    def __call__(self, img: Image.Image) -> Image.Image:
        from PIL import ImageEnhance

        ops = []
        if self.brightness > 0:
            f = self._factor(self.brightness)
            ops.append(lambda im: ImageEnhance.Brightness(im).enhance(f))
        if self.contrast > 0:
            f2 = self._factor(self.contrast)
            ops.append(lambda im: ImageEnhance.Contrast(im).enhance(f2))
        if self.saturation > 0:
            f3 = self._factor(self.saturation)
            ops.append(lambda im: ImageEnhance.Color(im).enhance(f3))
        if self.hue > 0:
            hf = random.uniform(-self.hue, self.hue)

            def _hue(im, hf=hf):
                hsv = np.array(im.convert("HSV"), dtype=np.int16)
                hsv[..., 0] = (hsv[..., 0] + int(hf * 255)) % 256
                return Image.fromarray(hsv.astype(np.uint8), "HSV").convert("RGB")

            ops.append(_hue)
        random.shuffle(ops)
        for op in ops:
            img = op(img)
        return img


class RandomGrayscale:
    def __init__(self, p: float):
        self.p = p

    def __call__(self, img: Image.Image) -> Image.Image:
        if random.random() < self.p:
            return img.convert("L").convert("RGB")
        return img


class GaussianBlur:
    """SimCLR-style random-σ blur (reference build.py:14-23)."""

    def __init__(self, sigma=(0.1, 2.0)):
        self.sigma = sigma

    def __call__(self, img: Image.Image) -> Image.Image:
        sigma = random.uniform(self.sigma[0], self.sigma[1])
        return img.filter(ImageFilter.GaussianBlur(radius=sigma))


class ToNormalizedArray:
    """PIL → float32 HWC in [0,1] → channel-normalized."""

    def __init__(self, mean, std):
        self.mean = np.asarray(mean, dtype=np.float32)
        self.std = np.asarray(std, dtype=np.float32)

    def __call__(self, img) -> np.ndarray:
        if isinstance(img, Image.Image):
            if img.mode != "RGB":
                img = img.convert("RGB")
            arr = np.asarray(img, dtype=np.float32) / 255.0
        else:
            arr = np.asarray(img, dtype=np.float32)
        return (arr - self.mean) / self.std


class ToUint8Array:
    """PIL → uint8 HWC, normalization deferred to the device
    (INPUT.DEVICE_NORMALIZE): 4× smaller host→device transfers and no
    host-side float pass; PatchEmbed folds (x/255 − mean)/std into one
    fused cast·scale+offset on device."""

    def __call__(self, img) -> np.ndarray:
        if isinstance(img, Image.Image):
            if img.mode != "RGB":
                img = img.convert("RGB")
            return np.asarray(img, dtype=np.uint8)
        arr = np.asarray(img)
        if arr.dtype != np.uint8:
            # float [0,1] (synthetic datasets) → uint8
            arr = np.clip(arr * 255.0 + 0.5, 0, 255).astype(np.uint8)
        return arr


def build_transforms(cfg, is_train: bool = True) -> Compose:
    """Reference build_transforms (build.py:32-112)."""
    interp = to_interp(cfg.INPUT.INTERPOLATION)
    # DEVICE_NORMALIZE ships uint8 and defers (x/255 − mean)/std to the
    # model (PatchEmbed); the timm-aug train path keeps host normalization
    # (RandomErasing operates on the normalized scale)
    if cfg.INPUT.DEVICE_NORMALIZE:
        normalize = ToUint8Array()
    else:
        normalize = ToNormalizedArray(cfg.INPUT.MEAN, cfg.INPUT.STD)
    size = cfg.INPUT.IMAGE_SIZE

    if cfg.AUG.TIMM_AUG.USE_TRANSFORM and is_train:
        from .rand_augment import build_timm_transform

        return build_timm_transform(cfg)

    if is_train:
        if cfg.FINETUNE.FINETUNE and not cfg.FINETUNE.USE_TRAIN_AUG:
            precrop = int(size / cfg.INPUT.CROP_PCT)
            return Compose([
                Resize(precrop, interp),
                RandomCrop((size, size)),
                RandomHorizontalFlip(),
                normalize,
            ])
        aug = cfg.AUG
        ts = [
            RandomResizedCrop(size, scale=tuple(aug.SCALE), ratio=tuple(aug.RATIO),
                              interpolation=interp),
            RandomHorizontalFlip(),
        ]
        cj = aug.COLOR_JITTER
        if cj[-1] > 0.0:
            ts.append(RandomApply([ColorJitter(*cj[:-1])], p=cj[-1]))
        if aug.GRAY_SCALE > 0.0:
            ts.append(RandomGrayscale(aug.GRAY_SCALE))
        if aug.GAUSSIAN_BLUR > 0.0:
            ts.append(RandomApply([GaussianBlur((0.1, 2.0))], p=aug.GAUSSIAN_BLUR))
        ts.append(normalize)
        return Compose(ts)

    return Compose([
        Resize(int(size / cfg.INPUT.CROP_PCT), interp),
        CenterCrop(size),
        normalize,
    ])
