"""The port's experiment entry point, one process per CUDA card.

    python -m vil_tpu_torch.run_experiment --config-file configs/msvit.yaml \
        [--data DIR] [--output_dir DIR] [--seed N] [KEY VALUE]...
    torchrun --standalone --nproc_per_node=N -m vil_tpu_torch.run_experiment ... \
        TPU.MESH_AXES "['data','spatial']" TPU.MESH_SHAPE "[a,b]"
    torchrun --standalone --nproc_per_node=N -m vil_tpu_torch.run_experiment ... \
        TPU.MESH_AXES "['data','model']" TPU.MESH_SHAPE "[a,b]" TPU.PARAM_SHARDING tp
    torchrun --standalone --nproc_per_node=N -m vil_tpu_torch.run_experiment ... \
        TPU.MESH_AXES "['data']" TPU.MESH_SHAPE "[N]" TPU.PARAM_SHARDING fsdp
    torchrun --standalone --nproc_per_node=N -m vil_tpu_torch.run_experiment ... \
        TPU.MESH_AXES "['data','spatial','model']" TPU.MESH_SHAPE "[a,b,c]" \
        TPU.PARAM_SHARDING tp
    torchrun --standalone --nproc_per_node=N -m vil_tpu_torch.run_experiment ... \
        TPU.MESH_AXES "['data','spatial']" TPU.MESH_SHAPE "[a,b]" TPU.PARAM_SHARDING fsdp

The counterpart of the repository's ``run_experiment.py`` for ``vil_tpu``:
the same arguments and the same config handling (the yaml, then the dotted
KEY VALUE overrides, then ``--data``, ``--output_dir`` and ``--seed``), then
``train.trainer.run_experiment``. Under torchrun (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK`` and ``TORCHELASTIC_RUN_ID`` in the environment) each process
joins an ``nccl`` group through a ``FileStore`` in the temporary directory,
named by the run id, takes card ``LOCAL_RANK`` and trains over the
config's mesh (a·b = N, a·b·c = N): data and spatial axes (at every
neighbour mode: the random-shift epochs of MODEL.VIT.MSVIT.MODE 1 too), or
data and model axes with TPU.PARAM_SHARDING 'tp' (each rank b's share of the
heads), or FSDP over the data axis ('fsdp'), or both beside a spatial axis:
'tp' on data, spatial and model axes (a rank's heads of its rows), 'fsdp'
on data and spatial axes; TPU.REMAT and MODEL.VIT.DROP on each of them;
the linformer, srformer, performer, only-global and unshared-global
attentions under 'tp'; and a ResNet of the zoo on every one of these
meshes (on a spatial axis a rank's rows, whole on every model rank); rank
0 alone logs and writes checkpoints, whole, which a run of any mesh or
sharding resumes. Without torchrun it runs on one card in one process. To
run on the CPU, build ``train.trainer.Trainer(cfg, device="cpu")`` instead.
Still raising, each naming its ROADMAP item: ``--multi-host`` (one host's
cards, A12); orbax checkpoints (A6) and TPU.FLAT_OPT / STACKED_OPT (A13)
(``train.trainer.check_ported``); the fused attention block under the
spatial split (A12, in the model).
"""
from __future__ import annotations

import argparse
import logging
import os
import tempfile


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="vil_tpu_torch experiment")
    parser.add_argument("--config-file", default="", metavar="FILE",
                        help="path to config file")
    parser.add_argument("--data", default=os.getenv("PT_DATA_DIR", "./datasets"),
                        help="dataset directory")
    parser.add_argument("--output_dir", default=os.getenv("PT_OUTPUT_DIR", "/tmp"),
                        help="output directory")
    parser.add_argument("--seed", default=42, type=int, help="random seed")
    parser.add_argument("--multi-host", action="store_true",
                        help="not ported: the processes of one host, one card each")
    parser.add_argument("opts", default=None, nargs=argparse.REMAINDER,
                        help="dotted config overrides: KEY VALUE ...")
    return parser.parse_args(argv)


def config_from_args(args):
    """The frozen config of ``args``: defaults, the yaml, the overrides, then
    the data and output directories and the seed."""
    from vil_tpu_torch.config import get_default_cfg

    cfg = get_default_cfg()
    if args.config_file:
        cfg.merge_from_file(args.config_file)
    if args.opts:
        cfg.merge_from_list(args.opts)
    cfg.DATA.PATH = args.data
    cfg.OUTPUT_DIR = args.output_dir
    cfg.TPU.SEED = args.seed
    cfg.freeze()
    return cfg


def main(argv=None):
    """Parse ``argv`` (default: the command line), run the experiment and
    return its ``Trainer``. Under torchrun, join the process group first,
    unless the caller already has, and leave it at the end."""
    args = parse_args(argv)
    if args.multi_host:
        raise NotImplementedError("--multi-host is not ported (ROADMAP §A, A12): the "
                                  "processes of one host, one card each")
    from vil_tpu_torch import parallel
    from vil_tpu_torch.train.trainer import run_experiment

    joined = "WORLD_SIZE" in os.environ and not parallel.collectives.is_distributed()
    if joined:
        store = os.path.join(tempfile.gettempdir(),
                             f"vil_store.{os.environ['TORCHELASTIC_RUN_ID']}")
        parallel.init_process_group(store, int(os.environ["RANK"]),
                                    int(os.environ["WORLD_SIZE"]),
                                    local_rank=int(os.environ["LOCAL_RANK"]))
    logging.basicConfig(level=logging.INFO if parallel.is_main_process() else logging.WARNING,
                        format="%(asctime)s %(levelname)s %(name)s: %(message)s")
    try:
        return run_experiment(config_from_args(args))
    finally:
        if joined:
            import torch.distributed as dist

            dist.destroy_process_group()


if __name__ == "__main__":
    main()
