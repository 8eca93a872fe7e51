"""Checkpointer: counterpart of ``vil_tpu/utils/checkpoint.py``.

The reference's on-disk conventions (its checkpoint.py:162-187, :232-251),
as ``vil_tpu`` keeps them: per-epoch ``checkpoint_{epoch}.ckpt`` (or a single
``checkpoint_last.ckpt`` under ONLY_SAVE_LAST), a ``model_best.ckpt`` copy, a
``.json`` header beside each (``arch``, ``epoch``, ``best_acc``), and a
``last_checkpoint`` tag file naming the newest checkpoint, relative to the
save directory, for auto-resume. A run that starts from nothing saves its
random init as ``model_init.ckpt``.

The payload is written with ``torch.save`` through a ``.tmp`` file and
``os.replace``: ``{"model": model.state_dict(), "optimizer":
optimizer.state_dict(), "step": global step, "lr_scale": the plateau
multiplier}``. The model's lazily built mask tables and its relative-position
serving cache are not parameters and are not saved. Loading also accepts a
reference ``.pth`` (through ``utils.torch_import``). A checkpoint written by
``vil_tpu`` (flax msgpack or an orbax directory) raises: reading one needs
flax (ROADMAP §A, A6); so does CKPT_BACKEND 'orbax' (``trainer.check_ported``).
"""
from __future__ import annotations

import json
import logging
import os
import os.path as op
import shutil
import zipfile
from typing import Optional

import torch

logger = logging.getLogger(__name__)


class Checkpointer:
    def __init__(self, save_dir: str = "", arch: str = "",
                 only_save_last: bool = False, is_test: bool = False,
                 data_dir: str = ""):
        self.save_dir = save_dir
        self.arch = arch
        self.only_save_last = only_save_last
        self.is_test = is_test
        self.data_dir = data_dir

    # -- tag file (checkpoint.py:232-251) ------------------------------------
    def _tag_path(self) -> str:
        return op.join(self.save_dir, "last_checkpoint")

    def has_checkpoint(self) -> bool:
        return op.exists(self._tag_path())

    def get_checkpoint_file(self) -> str:
        try:
            with open(self._tag_path(), "r") as f:
                last_saved = f.read().strip()
            # stored relative to save_dir for portability
            if not op.isabs(last_saved):
                last_saved = op.join(self.save_dir, last_saved)
            return last_saved
        except IOError:
            return ""

    def tag_last_checkpoint(self, path: str) -> None:
        with open(self._tag_path(), "w") as f:
            f.write(op.basename(path))

    # -- save -----------------------------------------------------------------
    def save(self, name_or_epoch, model, optimizer, step: int, lr_scale: float = 1.0,
             best_acc: float = 0.0, is_best: bool = False, **extra) -> Optional[str]:
        if not self.save_dir:
            return None
        os.makedirs(self.save_dir, exist_ok=True)
        if isinstance(name_or_epoch, int):
            name = "checkpoint_last" if self.only_save_last else f"checkpoint_{name_or_epoch}"
            epoch = name_or_epoch
        else:
            name, epoch = name_or_epoch, extra.pop("epoch", 0)
        payload = {
            "model": model.state_dict(),
            "optimizer": optimizer.state_dict(),
            "step": int(step),
            "lr_scale": float(lr_scale),
        }
        path = op.join(self.save_dir, f"{name}.ckpt")
        torch.save(payload, path + ".tmp")
        os.replace(path + ".tmp", path)
        header = {"arch": self.arch, "epoch": epoch, "best_acc": float(best_acc)}
        header.update(extra)
        with open(path + ".json", "w") as f:
            json.dump(header, f)
        self.tag_last_checkpoint(path)
        if is_best:
            best = op.join(self.save_dir, "model_best.ckpt")
            shutil.copyfile(path, best)
            shutil.copyfile(path + ".json", best + ".json")
        logger.info("Saved checkpoint to %s", path)
        return path

    # -- load -----------------------------------------------------------------
    def load(self, model, optimizer, model_path: str = "", resume: bool = True) -> dict:
        """Fill ``model`` (and, when resuming, ``optimizer``) in place and
        return the header, with the payload's ``step`` and ``lr_scale`` added
        when resuming ({} when nothing was loaded). Prefers the
        last_checkpoint tag over ``model_path`` (checkpoint.py:199-227);
        falls back to a DATA_DIR join for test-time paths (:175-176);
        imports a reference .pth."""
        path = model_path
        if resume and self.has_checkpoint() and not self.is_test:
            path = self.get_checkpoint_file()
        if not path:
            logger.info("No checkpoint found. Initializing model from scratch")
            # save the random init so a crash before the first epoch can
            # still resume deterministically (reference checkpoint.py:206-211)
            if not self.is_test and self.save_dir:
                self.save("model_init", model, optimizer, 0, epoch=0)
            return {}
        if not op.exists(path) and self.data_dir:
            alt = op.join(self.data_dir, path)
            if op.exists(alt):
                path = alt
        if not op.exists(path):
            logger.warning("Checkpoint %s not found; training from scratch", path)
            return {}

        if path.endswith(".pth"):
            from .torch_import import load_into_model

            logger.info("Importing torch checkpoint %s", path)
            load_into_model(path, model)
            return {}
        if op.isdir(path) or path.endswith(".orbax"):
            raise NotImplementedError(
                f"{path} is an orbax checkpoint of vil_tpu; reading one needs flax "
                f"(ROADMAP §A, A6)")
        if not zipfile.is_zipfile(path):  # torch.save writes a zip archive
            raise NotImplementedError(
                f"{path} is not a checkpoint of the port; a vil_tpu msgpack checkpoint "
                f"needs flax to read (ROADMAP §A, A6)")
        payload = torch.load(path, map_location="cpu", weights_only=True)
        model.load_state_dict(payload["model"])
        header = {}
        if op.isfile(path + ".json"):
            with open(path + ".json", "r") as f:
                header = json.load(f)
        if resume:
            optimizer.load_state_dict(payload["optimizer"])
            header.update(step=payload["step"], lr_scale=payload["lr_scale"])
        logger.info("Loaded checkpoint %s (epoch %s)", path, header.get("epoch"))
        return header
