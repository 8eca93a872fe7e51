"""Data-side transforms that run on the device: mixup / cutmix."""
