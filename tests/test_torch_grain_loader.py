"""DATALOADER.BACKEND 'grain' in the port (``vil_tpu_torch/data/grain_loader.py``,
PyTorch worker processes forked by a fork server) on the CPU:

* with 2 workers against the threads loader on the same dataset and
  sampler: the same indices and targets in the same order and the images
  bit for bit under the eval transform, with a ragged tail batch; uint8
  under INPUT.DEVICE_NORMALIZE; two passes (the workers kept between them)
  follow ``set_epoch``;
* the order against ``vil_tpu``'s ``GrainDataLoader`` (grain, in-process);
* the config path: ``check_ported`` takes 'grain' and ``make_epoch_data_loader``
  builds the grain loader;
* a worker that dies raises in the consumer.

Each test that starts workers runs under a time limit of its own
(``WORKER_TIMEOUT``): a hang fails the test instead of stalling the run.
"""
import sys
import threading

import numpy as np
import pytest

from vil_tpu.data.grain_loader import GrainDataLoader as JaxGrainDataLoader

from vil_tpu_torch.config import get_default_cfg
from vil_tpu_torch.data import loader, samplers
from vil_tpu_torch.data.datasets import SyntheticDataset
from vil_tpu_torch.data.grain_loader import GrainDataLoader
from vil_tpu_torch.data.transforms import build_transforms
from vil_tpu_torch.train.trainer import check_ported

WORKER_TIMEOUT = 120  # seconds for a test that starts worker processes
LENGTH, BATCH = 37, 8  # 4 whole batches and a tail of 5


def _within(fn, seconds=WORKER_TIMEOUT):
    """``fn()``'s result, or a failure if it has not returned in ``seconds``."""
    out = {}

    def run():
        try:
            out["value"] = fn()
        except BaseException as e:  # noqa: BLE001 - handed to the test thread
            out["error"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(seconds)
    assert not t.is_alive(), f"no result within {seconds} s"
    if "error" in out:
        raise out["error"]
    return out["value"]


def _dataset(*opts):
    cfg = get_default_cfg()
    cfg.merge_from_list(["INPUT.IMAGE_SIZE", "32", *opts])
    return SyntheticDataset(length=LENGTH, image_size=40, num_classes=10,
                            transforms=build_transforms(cfg, is_train=False))


def _sampler():
    return samplers.make_data_sampler(LENGTH, shuffle=True, distributed=False, is_train=True,
                                      repeated_aug=False, num_replicas=1, rank=0, seed=3)


@pytest.mark.parametrize("opts", [[], ["INPUT.DEVICE_NORMALIZE", "True"]],
                         ids=["float32", "uint8"])
def test_grain_equals_threads(opts):
    dataset, sampler = _dataset(*opts), _sampler()
    grain = GrainDataLoader(dataset, sampler, BATCH, drop_last=False, num_workers=2,
                            return_indices=True)
    threads = loader.DataLoader(dataset, sampler, BATCH, drop_last=False, num_workers=2,
                                return_indices=True)
    orders = []
    for epoch in (0, 1):
        sampler.set_epoch(epoch)
        got = _within(lambda: list(grain))
        want = list(threads)
        assert len(got) == len(want) == len(grain) == 5
        assert [len(b[1]) for b in got] == [8, 8, 8, 8, 5]
        for (x, y, i), (wx, wy, wi) in zip(got, want):
            assert x.dtype == wx.dtype == (np.uint8 if opts else np.float32)
            np.testing.assert_array_equal(i, wi)
            np.testing.assert_array_equal(y, wy)
            assert x.shape == wx.shape and np.array_equal(x, wx)
        orders.append(np.concatenate([b[2] for b in got]))
        assert sorted(orders[-1].tolist()) == list(range(LENGTH))
    assert not np.array_equal(*orders)


def test_order_matches_vil_tpu_grain():
    """The same sampler through vil_tpu's grain loader (in-process) and the
    port's with 2 workers: the same targets batch by batch, and the images
    (f32 under the eval transform) equal."""
    dataset, sampler = _dataset(), _sampler()
    theirs = list(JaxGrainDataLoader(dataset, sampler, BATCH, drop_last=False, num_workers=0))
    ours = _within(lambda: list(GrainDataLoader(dataset, sampler, BATCH, drop_last=False,
                                                num_workers=2)))
    assert len(ours) == len(theirs) == 5
    for (x, y), (tx, ty) in zip(ours, theirs):
        np.testing.assert_array_equal(y, ty)
        np.testing.assert_array_equal(x, tx)


def test_config_selects_grain():
    cfg = get_default_cfg()
    cfg.merge_from_list(["DATALOADER.BACKEND", "grain", "DATALOADER.WORKERS", "0",
                         "DATA.TEST", "('synthetic',)", "DATALOADER.BSZ", "4",
                         "INPUT.IMAGE_SIZE", "32"])
    check_ported(cfg)
    loaders = loader.make_epoch_data_loader(cfg, is_train=False, drop_last=False)
    assert isinstance(loaders[0], GrainDataLoader) and loaders[0].num_workers == 0
    x, y = next(iter(loaders[0]))
    assert x.shape == (4, 32, 32, 3) and y.dtype == np.int32


def test_a_dying_worker_raises():
    """Each worker's first sample ends its process (the transform is
    ``sys.exit``: a dataset of the port's own classes, so that the spawned
    workers import nothing of this file)."""
    dataset = SyntheticDataset(length=16, image_size=2, transforms=sys.exit)
    sampler = samplers.make_data_sampler(16, shuffle=False, distributed=False, is_train=False,
                                         repeated_aug=False, num_replicas=1, rank=0)
    grain = GrainDataLoader(dataset, sampler, 4, num_workers=2)
    with pytest.raises(RuntimeError, match="exited unexpectedly"):
        _within(lambda: list(grain))
