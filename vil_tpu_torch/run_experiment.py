"""The port's experiment entry point, on one CUDA card.

    python -m vil_tpu_torch.run_experiment --config-file configs/msvit.yaml \
        [--data DIR] [--output_dir DIR] [--seed N] [KEY VALUE]...

The counterpart of the repository's ``run_experiment.py`` for ``vil_tpu``:
the same arguments and the same config handling (the yaml, then the dotted
KEY VALUE overrides, then ``--data``, ``--output_dir`` and ``--seed``), then
``train.trainer.run_experiment``. It runs on the card; to run on the CPU,
build ``train.trainer.Trainer(cfg, device="cpu")`` instead. ``--multi-host``
raises: one process drives one card (ROADMAP §A, A12).
"""
from __future__ import annotations

import argparse
import logging
import os


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
                        help="not ported: one process drives one card")
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
    return its ``Trainer``."""
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(name)s: %(message)s")
    if args.multi_host:
        raise NotImplementedError("--multi-host is not ported (ROADMAP §A, A12): one "
                                  "process drives one card")
    from vil_tpu_torch.train.trainer import run_experiment

    return run_experiment(config_from_args(args))


if __name__ == "__main__":
    main()
