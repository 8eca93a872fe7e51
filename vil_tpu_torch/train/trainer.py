"""Experiment orchestration: counterpart of ``vil_tpu/train/trainer.py``.

One ``Trainer`` builds the data, model, criterion, optimizer and checkpointer
from a config and runs the epoch loop with the reference's training-strategy
details, as ``vil_tpu`` does:

* VIL random-shift mode until ``VIL_MODE_SWITCH · EPOCHS``, then full mode
  (the reference's run_experiment.py:223-230) — one train step whose
  ``random_shift`` is set per epoch;
* plateau LR drop for sgd/qhm when OPTIM.VAL and no improvement
  (run_experiment.py:253-260) — the train step's ``lr_scale``;
* a checkpoint every epoch, resume from the ``last_checkpoint`` tag (global
  step and ``lr_scale`` included; the step's draws are keyed by (TPU.SEED,
  step), so a resumed run draws what an uninterrupted one draws);
* best-checkpoint tracking + final best-checkpoint eval
  (run_experiment.py:264-279); under EVALUATE, ``results_{i}.npz``;
* under ``performer``, the projection redraw before a step when the
  ``1 + 5·epoch`` schedule says so (``train.redraw``; vil_tpu's trainer.py
  :235-246), each redraw drawn from a generator keyed by (TPU.SEED, step),
  so the draw itself is the same in a resumed run; the schedule's count
  starts afresh in a new Trainer, as ``vil_tpu``'s does. The projections
  ride in the checkpoint's ``state_dict``.

One process per card. On a ``TPU.MESH_SHAPE`` / ``TPU.MESH_AXES`` mesh of
``data``, ``spatial`` and ``model`` axes over the default process group
(``parallel.mesh_from_cfg``; ``run_experiment`` joins one under torchrun)
each data replica reads its shard of the data, its spatial ranks split each
image's rows (the training step and the eval step of ``train.engine``), the
gradients are averaged over the replicas, and the evaluation counts each
image once. The random-shift epochs (MODEL.VIT.MSVIT.MODE 1) run on a
spatial axis too, through the sampled-neighbour halo kernels, their
per-block modes keyed by (TPU.SEED, step) alone, so that every rank of a
spatial group draws the same ones; SHARE_W False runs there as well.
TPU.PARAM_SHARDING 'tp' builds each model rank's shard of the
heads (a ``model`` axis is needed: ``ValueError`` without one, as in
``vil_tpu``), 'fsdp' slices the large parameters and their moments over
the data axis (``parallel.fully_shard``), as ``vil_tpu``'s trainer
shards its state; both beside a spatial axis too: 'tp' on a ('data',
'spatial', 'model') mesh (a rank's heads of a rank's rows), 'fsdp' on a
('data', 'spatial') mesh (the slices over the data group of a rank's
spatial index). Rank 0 alone writes checkpoints (gathered whole under
sharding), ``config.yaml`` and the TensorBoard logs; every rank loads on
resume. Keys that select what the port lacks raise (:func:`check_ported`),
each naming its ROADMAP item: orbax (A6) and the flat or stacked optimizer
states (A13). TPU.REMAT and MODEL.VIT.DROP run on
every mesh: the recompute of a block re-issues its collectives, and each
rank keeps its part of the masks the one-rank step draws. The linformer,
srformer and performer attentions, ONLY_GLOBAL and SHARE_W False run under
'tp' too, a rank holding its heads. A ResNet of the zoo (MODEL.ARCH
``resnet50`` ...) trains and evaluates as a ViL does, on a data axis, on a
spatial axis (a rank's rows, halo convolutions and pooling, BatchNorm and
the pool summed over the data and spatial ranks), under 'fsdp' and whole
on every rank of a model axis, its BatchNorm buffers updated by the step
and read by the eval; the random-shift switch never fires for it.
The Trainer builds on the CUDA card unless it is given ``device="cpu"``.
"""
from __future__ import annotations

import json
import logging
import os.path as op
import time
from typing import Optional

import numpy as np
import torch

from .. import parallel
from ..data import make_epoch_data_loader, mixup_from_cfg
from ..models import RESNET_ZOO, build_model
from ..utils.checkpoint import Checkpointer
from ..utils.device import resolve_device
from ..utils.metric_logger import TensorboardLogger
from ..utils.misc import mkdir, save_config, set_seed
from ..utils.profiling import peak_memory_mb
from . import engine
from .loss import get_criterion, get_per_sample_criterion
from .optim import drop_lr, get_opt
from .redraw import RedrawSchedule, redraw_projections
from .schedulers import get_lr_schedule

logger = logging.getLogger(__name__)


def check_ported(cfg) -> None:
    """Raise ``NotImplementedError`` for a key that selects something the
    port lacks, naming its ROADMAP §A item; such a key is never ignored:
    orbax checkpoints (A6) and the flat or stacked optimizer states (A13).
    Every model of the zoo passes on every mesh: random shift, mode -1,
    SHARE_W False, TPU.REMAT and MODEL.VIT.DROP on a spatial axis, under
    'tp' and 'fsdp', and beside a spatial axis; a ResNet on a spatial axis
    (replicated, 'fsdp' and, whole on every model rank, 'tp'); the
    linformer, srformer and performer attentions, ONLY_GLOBAL and SHARE_W
    False under 'tp'. The fused block under the split raises in the model
    (A12), ``--multi-host`` in ``run_experiment`` (A12).
    TPU.PARAM_SHARDING 'tp' without a model axis raises ``ValueError``, as
    ``vil_tpu``'s trainer does."""
    tpu = cfg.TPU
    axes = list(tpu.MESH_AXES)
    if tpu.PARAM_SHARDING not in ("replicated", "fsdp", "tp"):
        raise ValueError(f"TPU.PARAM_SHARDING {tpu.PARAM_SHARDING!r}: one of 'replicated', "
                         f"'fsdp', 'tp'")
    if tpu.PARAM_SHARDING == "tp" and "model" not in axes:
        raise ValueError("PARAM_SHARDING 'tp' needs a 'model' axis in TPU.MESH_AXES")
    refused = [
        (cfg.CKPT_BACKEND == "orbax",
         "CKPT_BACKEND 'orbax' (orbax writes OCDBT, which only tensorstore reads, and the "
         "card's host has no tensorstore: A6)"),
        (bool(tpu.FLAT_OPT) or bool(tpu.STACKED_OPT), "TPU.FLAT_OPT / STACKED_OPT (A13)"),
    ]
    for bad, what in refused:
        if bad:
            raise NotImplementedError(f"{what} is not ported (ROADMAP.md §A)")


def merge_replica_results(results: dict) -> dict:
    """Every rank's per-image eval results (arrays by name, ``indices``
    among them, one row an image), merged on every rank by dataset index:
    each image once, in index order (``parallel.accumulate_predictions``)."""
    names = sorted(results)
    mine = {int(i): tuple(results[k][n] for k in names)
            for n, i in enumerate(results["indices"])}
    merged = parallel.accumulate_predictions(mine)
    rows = [merged[i] for i in sorted(merged)]
    return {k: np.stack([row[c] for row in rows]) for c, k in enumerate(names)}


class Trainer:
    def __init__(self, cfg, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        check_ported(cfg)
        self.mesh = parallel.mesh_from_cfg(cfg)
        # the data pipeline's draws differ between replicas; the model's
        # weights are drawn below from the seed alone, the same everywhere
        set_seed(cfg.TPU.SEED, self.mesh.data_rank)
        if cfg.SOLVER.DETECT_ANOMALY:
            # the reference's torch.autograd.set_detect_anomaly
            # (run_experiment.py:233)
            torch.autograd.set_detect_anomaly(True)
        # under 'tp' this model rank's shard of the weights drawn from the seed
        self.model = build_model(cfg, device=self.device, mesh=self.mesh,
                                 generator=torch.Generator().manual_seed(cfg.TPU.SEED))
        if cfg.TPU.PARAM_SHARDING == "fsdp":  # before the optimizer: moments at the slices
            parallel.fully_shard(self.model, self.mesh)
        self.mixup_fn = mixup_from_cfg(cfg)
        self.criterion = get_criterion(cfg, train=True)
        self.criterion_eval = get_criterion(cfg, train=False)

        # each data replica reads its shard (the spatial ranks of one the same)
        shard = dict(is_distributed=self.mesh.data_size > 1,
                     num_replicas=self.mesh.data_size, rank=self.mesh.data_rank)
        self.testloaders = make_epoch_data_loader(cfg, is_train=False, drop_last=False, **shard)
        self.trainloader = None
        if not cfg.EVALUATE:
            self.trainloader = make_epoch_data_loader(cfg, is_train=True, **shard)
            if cfg.SOLVER.STEPS_PER_EPOCH == 0:
                was_frozen = cfg.is_frozen()
                if was_frozen:
                    cfg.defrost()
                cfg.SOLVER.STEPS_PER_EPOCH = len(self.trainloader)
                cfg.SOLVER.MAX_ITER = len(self.trainloader) * cfg.OPTIM.EPOCHS
                if was_frozen:
                    cfg.freeze()

        schedule = get_lr_schedule(cfg)
        self.lr_schedule = schedule or (lambda step: cfg.OPTIM.LR)
        self.optimizer = get_opt(cfg, self.model)

        self.checkpointer = Checkpointer(
            save_dir=cfg.OUTPUT_DIR,
            arch=cfg.MODEL.VIT.MSVIT.ARCH,
            only_save_last=bool(cfg.ONLY_SAVE_LAST),
            is_test=cfg.EVALUATE,
            data_dir=cfg.DATA.DATA_DIR,
        )
        # every rank loads the file rank 0 chose (starting from nothing, the
        # initial checkpoint is written, gathered under sharding)
        header = self.checkpointer.load(self.model, self.optimizer, cfg.MODEL.MODEL_PATH,
                                        resume=not cfg.EVALUATE)
        parallel.synchronize()
        self.start_epoch = int(header.get("epoch", 0))
        self.best_acc = float(header.get("best_acc", 0.0))
        self.train_step = engine.make_train_step(
            self.model, self.criterion, self.optimizer, self.lr_schedule, self.mixup_fn,
            device=self.device, per_layer_modes=bool(cfg.TPU.MODE_PER_LAYER),
            start_step=int(header.get("step", 0)), seed=cfg.TPU.SEED,
            lr_scale=float(header.get("lr_scale", 1.0)), mesh=self.mesh)
        self._eval_step = None
        # what the run did: one record per logged train step and per
        # validate call, and the counts a caller checks launches against
        self.steps_log: list[dict] = []
        self.evals: list[dict] = []
        self.steps_run = {False: 0, True: 0}  # train steps, by random shift
        self.eval_batches = 0
        self.best_evaluated = False
        # the performer's redraws: the schedule, and the global steps before
        # which a redraw ran
        self.redraw_schedule = RedrawSchedule()
        self.redraw_steps: list[int] = []

    # ------------------------------------------------------------------
    def _get_eval_step(self):
        if self._eval_step is None:
            target_valid = overlap = None
            if self.cfg.DATA.TARGETMAP:
                with open(self.cfg.DATA.TARGETMAP) as f:
                    raw = json.load(f)
                tmap = {int(k): [int(c) for c in v] for k, v in raw.items()}
                target_valid, overlap = engine.build_target_map_arrays(
                    tmap, max(tmap) + 1, self.cfg.DATA.NUM_CLASSES)
            self._eval_step = engine.make_eval_step(
                self.model, self.criterion_eval, target_valid, overlap,
                return_scores=self._collect_scores(),
                per_sample_criterion=get_per_sample_criterion(self.cfg),
                # per-image predictions for results_*.npz (reference
                # results.pth, engine.py:264-268)
                pred_topk=5 if self.cfg.EVALUATE else 0, spatial=self.mesh.spatial,
            )
        return self._eval_step

    def _random_shift_active(self, epoch: int) -> bool:
        cfg = self.cfg
        if cfg.MODEL.ARCH in RESNET_ZOO:  # a ResNet has no neighbour mode
            return False
        if cfg.MODEL.VIT.MSVIT.ATTN_TYPE.startswith("longformer"):
            switch = cfg.MODEL.VIT.MSVIT.VIL_MODE_SWITCH * cfg.OPTIM.EPOCHS
            return cfg.MODEL.VIT.MSVIT.MODE > 0 and epoch < switch
        return False

    def _to_device(self, array: np.ndarray) -> torch.Tensor:
        """A host batch on the trainer's device, through pinned memory, the
        same on every rank of a data replica: the replica's first rank (of
        its spatial group, model group, or both) sends its own (the loaders' augmentations draw from Python's
        ``random`` in their threads, so two ranks that read the same indices
        need not draw alike)."""
        t = torch.from_numpy(array)
        if self.device.type == "cuda":
            t = t.pin_memory()
        return parallel.mesh.broadcast_replica(t.to(self.device, non_blocking=True),
                                               self.mesh.replica)

    # ------------------------------------------------------------------
    def train_epoch(self, epoch: int, meters: Optional[TensorboardLogger] = None):
        cfg = self.cfg
        self.trainloader.sampler.set_epoch(epoch)
        step = self.train_step
        step.random_shift = self._random_shift_active(epoch)
        is_performer = cfg.MODEL.VIT.MSVIT.ATTN_TYPE == "performer"
        if is_performer:
            self.redraw_schedule.set_epoch(epoch)
        log_freq = max(1, cfg.LOG_FREQ)
        t_end = time.time()
        for i, (images, targets) in enumerate(self.trainloader):
            data_time = time.time() - t_end
            if is_performer and self.redraw_schedule.should_redraw():
                generator = torch.Generator().manual_seed(
                    engine.keyed_seed(cfg.TPU.SEED, step.step, 2))
                redraw_projections(self.model, generator)
                self.redraw_steps.append(step.step)
            lr = self.lr_schedule(step.step) * step.lr_scale
            metrics = step(self._to_device(images), self._to_device(targets))
            self.steps_run[step.random_shift] += 1
            if i % log_freq == 0:
                # reading the metrics waits for the step, so a logged step's
                # batch_time is its wall time, data included
                host = {k: float(v) for k, v in metrics.items() if k != "modes"}
                batch_time = time.time() - t_end
                self.steps_log.append(dict(epoch=epoch, step=step.step - 1, lr=lr,
                                           data_time=data_time, batch_time=batch_time,
                                           random_shift=step.random_shift, **host))
                if meters is not None:
                    meters.update(step.step, data_time=data_time, batch_time=batch_time,
                                  learning_rate=lr, **host)
                logger.info(
                    "epoch %d it %d/%d loss %.4f lr %.2e %s",
                    epoch, i, len(self.trainloader), host.get("loss", 0), lr,
                    " ".join(f"{k} {v:.2f}" for k, v in host.items() if k != "loss"),
                )
            t_end = time.time()

    def validate(self, loader, meters=None, global_step: int = 0,
                 save_results: Optional[str] = None) -> float:
        eval_step = self._get_eval_step()
        totals = {"loss": 0.0, "top1_sum": 0.0, "top5_sum": 0.0, "count": 0.0}
        nbatch = 0
        # several data replicas: each image's result is gathered by its index
        # and counted once (the sampler pads the replicas' shards with repeats)
        merge = self.mesh.data_size > 1
        collect = self._collect_scores()
        parts = {k: [] for k in ("scores", "targets", "indices", "pred_ids", "pred_scores")}
        if collect:
            loader.return_indices = True
        for batch in loader:
            images, targets_np = batch[0], batch[1]
            valid = torch.ones(len(targets_np), device=self.device)
            m = eval_step(self._to_device(images), self._to_device(targets_np), valid)
            for k in totals:
                totals[k] += float(m[k])
            nbatch += 1
            self.eval_batches += 1
            if collect:
                parts["scores"].append(m["scores"].cpu().numpy())
                parts["targets"].append(np.asarray(targets_np))
                parts["indices"].append(np.asarray(batch[2]))
                if "pred_ids" in m:
                    parts["pred_ids"].append(m["pred_ids"].cpu().numpy())
                    parts["pred_scores"].append(m["pred_scores"].cpu().numpy())
        results = {k: np.concatenate(v) for k, v in parts.items() if v}
        if merge:
            # every rank merges every replica's images, so that all take the
            # same decisions (best checkpoint, plateau drop) from them; the
            # loss is the mean of every replica's batch losses
            results = merge_replica_results(results)
            totals.update(top1_sum=results["scores"][:, 0].sum(),
                          top5_sum=results["scores"][:, 1].sum(),
                          count=len(results["indices"]))
            summed = parallel.reduce_dict({"loss": totals["loss"], "n": nbatch}, average=False)
            totals["loss"], nbatch = summed["loss"], summed["n"]
        top1 = 100.0 * totals["top1_sum"] / max(totals["count"], 1)
        top5 = 100.0 * totals["top5_sum"] / max(totals["count"], 1)
        loss = totals["loss"] / max(nbatch, 1)
        logger.info("eval: top1 %.3f top5 %.3f loss %.4f (%d images, peak memory %.0f MB)",
                    top1, top5, loss, int(totals["count"]), peak_memory_mb())
        self.evals.append(dict(step=global_step, top1=top1, top5=top5, loss=loss,
                               images=int(totals["count"])))
        if collect and results and parallel.is_main_process():
            scores, targets_cat = results["scores"], results["targets"]
            indices = results["indices"]
            if self.cfg.OUTPUT_PERCLASS_ACC:
                # reference output_metrics per-class path (engine.py:47-56)
                for label in range(int(targets_cat.max()) + 1):
                    sel = scores[targets_cat == label]
                    if len(sel):
                        logger.info("class %d: top1 %.2f top5 %.2f (n=%d)", label,
                                    100 * sel[:, 0].mean(), 100 * sel[:, 1].mean(), len(sel))
            if save_results:
                # per-image results keyed by dataset index / img key
                # (reference saves results.pth keyed by get_img_key,
                # engine.py:264-268, :323-325)
                extra = {"indices": indices}
                get_key = getattr(loader.dataset, "get_img_key", None)
                if get_key is not None:
                    extra["img_keys"] = np.asarray([str(get_key(int(i))) for i in indices])
                if "pred_ids" in results:
                    extra["pred_ids"] = results["pred_ids"]
                    extra["pred_scores"] = results["pred_scores"]
                np.savez(save_results, scores=scores, targets=targets_cat, top1=top1,
                         top5=top5, **extra)
                logger.info("Saved per-image eval results to %s", save_results)
        if meters is not None:
            meters.update(global_step, top1=top1, top5=top5, loss=loss)
        return top1

    def _collect_scores(self) -> bool:
        """Whether the eval keeps each image's result: to save or break them
        down, or to merge the data replicas'."""
        cfg = self.cfg
        return bool(cfg.EVALUATE) or bool(cfg.OUTPUT_PERCLASS_ACC) or self.mesh.data_size > 1

    # ------------------------------------------------------------------
    def fit(self, train_meters=None, test_meters=None) -> list:
        cfg = self.cfg
        if cfg.EVALUATE:
            return [
                self.validate(l, save_results=f"{cfg.OUTPUT_DIR}/results_{i}.npz"
                              if cfg.OUTPUT_DIR else None)
                for i, l in enumerate(self.testloaders)
            ]

        step = self.train_step
        for epoch in range(self.start_epoch, cfg.OPTIM.EPOCHS):
            logger.info("PROGRESS: %.1f%%", 100 * epoch / cfg.OPTIM.EPOCHS)
            self.train_epoch(epoch, train_meters)
            accs = [
                self.validate(l, test_meters[i] if test_meters else None, step.step)
                for i, l in enumerate(self.testloaders)
            ]
            is_best = accs[0] > self.best_acc
            if is_best:
                self.best_acc = accs[0]
            elif cfg.OPTIM.VAL and cfg.OPTIM.OPT in ("sgd", "qhm"):
                logger.info("DROPPING LEARNING RATE")
                drop_lr(step, cfg.OPTIM.DROP_FACTOR)
            self.checkpointer.save(epoch + 1, self.model, self.optimizer, step.step,
                                   step.lr_scale, best_acc=self.best_acc, is_best=is_best)
            parallel.synchronize()  # rank 0's files are written before anyone reads them

        # final: evaluate the best checkpoint (run_experiment.py:264-279), on
        # every rank if rank 0 wrote one
        best = op.join(cfg.OUTPUT_DIR, "model_best.ckpt")
        if parallel.all_gather(op.isfile(best))[0]:
            logger.info("Evaluating the best checkpoint: %s", best)
            self.checkpointer.is_test = True
            self.checkpointer.load(self.model, self.optimizer, best, resume=False)
            self.best_evaluated = True
            return [self.validate(l) for l in self.testloaders]
        return []


def run_experiment(cfg, device=None) -> Trainer:
    """Full experiment (the CLI's body): the config snapshot, the Trainer,
    its metric loggers and ``fit``; on a mesh, rank 0 alone writes the
    snapshot and the logs. Returns the Trainer, whose ``evals`` end with
    the final accuracies."""
    main = parallel.is_main_process()
    if main:
        mkdir(cfg.OUTPUT_DIR)
        save_config(cfg, f"{cfg.OUTPUT_DIR}/config.yaml")
    parallel.synchronize()
    trainer = Trainer(cfg, device=device)
    train_meters, test_meters = None, None
    if main:
        train_meters = TensorboardLogger(f"{cfg.OUTPUT_DIR}/tb_logs/train")
        test_meters = [TensorboardLogger(f"{cfg.OUTPUT_DIR}/tb_logs/{name}_{i}")
                       for i, name in enumerate(cfg.DATA.TEST)]
    try:
        trainer.fit(train_meters, test_meters)
    finally:
        for m in [train_meters, *(test_meters or [])]:
            if m is not None:
                m.close()
    return trainer
