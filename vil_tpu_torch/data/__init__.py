"""Data pipeline: datasets, transforms, samplers, loader (host side, numpy
and PIL), mixup / cutmix (on the device) and the TSV stack."""
from .loader import build_dataset, make_epoch_data_loader
from .mixup import make_mixup_fn, mixup_from_cfg
from .transforms import build_transforms

__all__ = [
    "build_dataset",
    "build_transforms",
    "make_epoch_data_loader",
    "make_mixup_fn",
    "mixup_from_cfg",
]
