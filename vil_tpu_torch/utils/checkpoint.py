"""Checkpointer: counterpart of ``vil_tpu/utils/checkpoint.py``.

The reference's on-disk conventions (its checkpoint.py:162-187, :232-251),
as ``vil_tpu`` keeps them: per-epoch ``checkpoint_{epoch}.ckpt`` (or a single
``checkpoint_last.ckpt`` under ONLY_SAVE_LAST), a ``model_best.ckpt`` copy, a
``.json`` header beside each (``arch``, ``epoch``, ``best_acc``), and a
``last_checkpoint`` tag file naming the newest checkpoint, relative to the
save directory, for auto-resume. A run that starts from nothing saves its
random init as ``model_init.ckpt``.

The payload is written with ``torch.save`` through a ``.tmp`` file and
``os.replace``, by rank 0 alone in a multi-process run: ``{"model":
model.state_dict(), "optimizer": optimizer.state_dict(), "step": global
step, "lr_scale": the plateau multiplier}``. The model's lazily built mask
tables and its relative-position serving cache are not parameters and are
not saved. Under parameter sharding (TPU.PARAM_SHARDING 'tp' or 'fsdp', the
model's ``param_shards``) every rank takes part in the save, which gathers
the whole model and optimizer state, and rank 0 writes it in the format of
a replicated run; on load each rank takes its slice. A sharded run and a
replicated one therefore resume each other's checkpoints. Loading also accepts a reference ``.pth`` (through
``utils.torch_import``) and a checkpoint that ``vil_tpu`` wrote with its
default backend, a flax msgpack file (``utils.flax_msgpack``, mapped by
``utils.jax_import.vil_tpu_payload``): from MODEL.MODEL_PATH, from the
``last_checkpoint`` tag of a ``vil_tpu`` OUTPUT_DIR or as
``model_best.ckpt``. Its header must name the model's ``arch``; a load that
resumes takes the optimizer's moments, the step and ``lr_scale`` too, one
that does not the parameters and buffers alone, as ``vil_tpu``'s does. The
port goes on writing its own format. An orbax directory (CKPT_BACKEND
'orbax') raises: orbax writes OCDBT, which only tensorstore reads, and the
card's host has no tensorstore (ROADMAP §A, A6).
"""
from __future__ import annotations

import json
import logging
import os
import os.path as op
import shutil
import time
import zipfile
from typing import Optional

import torch

from ..parallel import tensor
from ..parallel.collectives import all_gather, is_main_process
from . import flax_msgpack, jax_import

logger = logging.getLogger(__name__)

ORBAX_REFUSED = (
    "{} is an orbax checkpoint of vil_tpu (CKPT_BACKEND 'orbax'): orbax writes OCDBT "
    "(manifest.ocdbt, ocdbt.process_*/), which only tensorstore reads, and the card's host "
    "has no tensorstore (ROADMAP.md §A, A6)")


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
        """Write the checkpoint (rank 0 alone). A sharded model's state is
        gathered first, a collective that every rank enters."""
        if not self.save_dir:
            return None
        sharded = bool(getattr(model, "param_shards", None))
        if sharded:
            model_state = tensor.full_state_dict(model)
            optim_state = tensor.full_optimizer_state(optimizer, model)
        if not is_main_process():
            return None
        if not sharded:
            model_state, optim_state = model.state_dict(), optimizer.state_dict()
        os.makedirs(self.save_dir, exist_ok=True)
        if isinstance(name_or_epoch, int):
            name = "checkpoint_last" if self.only_save_last else f"checkpoint_{name_or_epoch}"
            epoch = name_or_epoch
        else:
            name, epoch = name_or_epoch, extra.pop("epoch", 0)
        payload = {
            "model": model_state,
            "optimizer": optim_state,
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
        imports a reference .pth. In a run of several processes every rank
        takes rank 0's choice of file, made before anyone writes, and a
        sharded model takes its slices."""
        path = model_path
        if resume and self.has_checkpoint() and not self.is_test:
            path = self.get_checkpoint_file()
        path = all_gather(path)[0]
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
            raise NotImplementedError(ORBAX_REFUSED.format(path))
        header = {}
        if op.isfile(path + ".json"):
            with open(path + ".json", "r") as f:
                header = json.load(f)
        if zipfile.is_zipfile(path):  # torch.save writes a zip archive
            payload = torch.load(path, map_location="cpu", weights_only=True)
        elif flax_msgpack.starts_a_map(path):
            if self.arch and header.get("arch", self.arch) != self.arch:
                raise ValueError(f"{path} holds arch {header['arch']!r}, the model is "
                                 f"{self.arch!r}")
            t0 = time.perf_counter()
            payload = jax_import.vil_tpu_payload(model, optimizer if resume else None,
                                                 flax_msgpack.load(path))
            logger.info("Read vil_tpu checkpoint %s (%.1f MB) in %.2f s", path,
                        op.getsize(path) / 1e6, time.perf_counter() - t0)
        else:
            raise ValueError(f"{path} is neither a checkpoint of the port (a zip archive) "
                             f"nor one of vil_tpu (a flax msgpack file)")
        tensor.load_full_state_dict(model, payload["model"])
        if resume:
            tensor.load_full_optimizer_state(optimizer, model, payload["optimizer"])
            header.update(step=payload["step"], lr_scale=payload["lr_scale"])
        logger.info("Loaded checkpoint %s (epoch %s)", path, header.get("epoch"))
        return header
