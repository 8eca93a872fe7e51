"""The port's host data pipeline against ``vil_tpu.data``: samplers,
transforms (RandAugment and random erasing included), datasets, the TSV
stack and the loader give the same indices, arrays and batches under the
same ``random`` / numpy seeds. Every comparison is exact: both sides run the
same PIL and numpy operations in the same order. Files are written by the
tests; images are small and drawn from numpy seeds."""
import base64
import io
import json
import random
import sys
import threading
import zipfile

import numpy as np
import pytest
from PIL import Image

from vil_tpu.config import get_default_cfg as jax_default_cfg
from vil_tpu.data import datasets as jax_datasets
from vil_tpu.data import loader as jax_loader
from vil_tpu.data import rand_augment as jax_ra
from vil_tpu.data import samplers as jax_samplers
from vil_tpu.data import transforms as jax_transforms
from vil_tpu.data import tsv as jax_tsv
from vil_tpu_torch.config import get_default_cfg
from vil_tpu_torch.data import datasets, loader, rand_augment, samplers, transforms, tsv

SIZE = 32


def _image(seed: int, h: int = 40, w: int = 48) -> Image.Image:
    rng = np.random.default_rng(seed)
    return Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8))


def _cfgs(*opts):
    """(port cfg, vil_tpu cfg) with the same overrides, at a 32-px size."""
    out = []
    for cfg in (get_default_cfg(), jax_default_cfg()):
        cfg.merge_from_list(["INPUT.IMAGE_SIZE", str(SIZE), "DATALOADER.BSZ", "4",
                             "DATALOADER.WORKERS", "0", *opts])
        out.append(cfg)
    return out


def _seeded(fn, seed):
    random.seed(seed)
    np.random.seed(seed)
    return fn()


# -- samplers ------------------------------------------------------------------
@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("epoch", [0, 3])
@pytest.mark.parametrize("kind", ["sequential", "random", "distributed", "distributed_fixed",
                                  "repeated_aug"])
def test_sampler_indices_equal(kind, seed, epoch):
    length, replicas = 613, 3
    for rank in range(replicas if kind.startswith(("distributed", "repeated")) else 1):
        args = dict(length=length, shuffle=kind != "distributed_fixed",
                    distributed=kind.startswith(("distributed", "repeated")), is_train=True,
                    repeated_aug=kind == "repeated_aug", num_replicas=replicas, rank=rank,
                    seed=seed)
        if kind == "sequential":
            args.update(shuffle=False)
        ours = samplers.make_data_sampler(**args)
        theirs = jax_samplers.make_data_sampler(**args)
        assert type(ours).__name__ == type(theirs).__name__
        ours.set_epoch(epoch)
        theirs.set_epoch(epoch)
        assert len(ours) == len(theirs)
        assert list(ours) == list(theirs)


# -- transforms ----------------------------------------------------------------
TRANSFORM_CASES = {
    "train": ((), True),
    "train_jitter_gray_blur": (("AUG.COLOR_JITTER", "[0.4, 0.4, 0.4, 0.1, 0.8]",
                                "AUG.GRAY_SCALE", "0.3", "AUG.GAUSSIAN_BLUR", "0.5"), True),
    "timm_randaugment": (("AUG.TIMM_AUG.USE_TRANSFORM", "True", "AUG.TIMM_AUG.AUTO_AUGMENT",
                          "rand-m9-mstd0.5-inc1", "AUG.TIMM_AUG.RE_PROB", "0.5",
                          "INPUT.INTERPOLATION", "3"), True),
    "eval": ((), False),
    "finetune": (("FINETUNE.FINETUNE", "True"), True),
    "device_normalize_eval": (("INPUT.DEVICE_NORMALIZE", "True"), False),
}


@pytest.mark.parametrize("case", sorted(TRANSFORM_CASES))
def test_transforms_equal(case):
    opts, is_train = TRANSFORM_CASES[case]
    ours_cfg, theirs_cfg = _cfgs(*opts)
    ours = transforms.build_transforms(ours_cfg, is_train)
    theirs = jax_transforms.build_transforms(theirs_cfg, is_train)
    # enough seeds that RandAugment draws most of its 15 ops
    for seed in range(12 if case.startswith("timm") else 3):
        img = _image(seed)
        a, b = _seeded(lambda: ours(img), seed), _seeded(lambda: theirs(img), seed)
        assert a.dtype == b.dtype and a.shape == b.shape == (SIZE, SIZE, 3)
        np.testing.assert_array_equal(a, b)


def test_rand_augment_spec_and_every_op():
    ours = rand_augment.parse_rand_augment("rand-m9-mstd0.5-inc1-n3")
    theirs = jax_ra.parse_rand_augment("rand-m9-mstd0.5-inc1-n3")
    assert vars(ours) == vars(theirs) == dict(magnitude=9.0, num_layers=3, mstd=0.5, prob=0.5)
    img = _image(3, 32, 32)
    ops, jax_ops = rand_augment._RAND_OPS, jax_ra._RAND_OPS
    assert [n for n, _, _ in ops] == [n for n, _, _ in jax_ops]
    for (name, op, level), (_, jop, jlevel) in zip(ops, jax_ops):
        arg = _seeded(lambda: level(7.0), 1) if level else 0
        jarg = _seeded(lambda: jlevel(7.0), 1) if jlevel else 0
        assert arg == jarg, name
        np.testing.assert_array_equal(np.asarray(op(img, arg)), np.asarray(jop(img, jarg)),
                                      err_msg=name)


# -- datasets and the TSV stack -------------------------------------------------
def _png(img: Image.Image) -> bytes:
    buf = io.BytesIO()
    img.save(buf, format="PNG")
    return buf.getvalue()


@pytest.fixture
def files(tmp_path):
    """An image folder, a zip with its map, and TSV datasets (labels by
    labelmap, a linelist, classification TSV), 3 classes of 3 images."""
    names = ["cat", "dog", "eel"]
    rows, cls_rows, zmap = [], [], []
    with zipfile.ZipFile(tmp_path / "val.zip", "w") as zf:
        for c, name in enumerate(names):
            (tmp_path / "folder" / name).mkdir(parents=True)
            for i in range(3):
                img = _image(10 * c + i)
                img.save(tmp_path / "folder" / name / f"{i}.png")
                zf.writestr(f"{name}/{i}.png", _png(img))
                zmap.append(f"val.zip@/{name}/{i}.png\t{c}")
                b64 = base64.b64encode(_png(img)).decode()
                rows.append([f"{name}_{i}", json.dumps([{"class": name}]), b64])
                cls_rows.append([f"{name}_{i}", str(c), b64])
    (tmp_path / "val_map.txt").write_text("\n".join(zmap) + "\n")
    tsv.tsv_writer(rows, str(tmp_path / "img.tsv"))
    tsv.tsv_writer(cls_rows, str(tmp_path / "imagenet22k.tsv"))
    (tmp_path / "labelmap.txt").write_text("\n".join(names) + "\n")
    (tmp_path / "linelist.txt").write_text("\n".join(["0", "2", "4", "6", "8"]) + "\n")
    (tmp_path / "tsv.yaml").write_text("img: img.tsv\nlabelmap: labelmap.txt\n"
                                       "linelist: linelist.txt\n")
    (tmp_path / "imagenet22k.yaml").write_text("img: imagenet22k.tsv\n")
    return tmp_path


def test_tsv_files_equal_and_round_trip(files):
    ours_rows = list(tsv.tsv_reader(str(files / "img.tsv")))
    assert ours_rows == list(jax_tsv.tsv_reader(str(files / "img.tsv")))
    jax_tsv.tsv_writer(ours_rows, str(files / "again.tsv"))
    for ext in (".tsv", ".lineidx"):
        assert (files / f"img{ext}").read_bytes() == (files / f"again{ext}").read_bytes()
    # a lineidx built by the scanner equals the writer's
    tsv.create_lineidx(str(files / "img.tsv"), str(files / "scanned.lineidx"))
    assert (files / "scanned.lineidx").read_bytes() == (files / "img.lineidx").read_bytes()
    ours, theirs = tsv.TSVFile(str(files / "img.tsv")), jax_tsv.TSVFile(str(files / "img.tsv"))
    assert ours.num_rows() == theirs.num_rows() == 9
    assert [ours.seek(i) for i in range(9)] == [theirs.seek(i) for i in range(9)] == ours_rows


def test_tsv_reads_from_many_threads(files):
    """The loader's threads share one file handle: 16 threads reading rows
    in random order, with the interpreter switching threads as often as it
    can, each get the row they asked for."""
    reader = tsv.TSVFile(str(files / "img.tsv"))
    want = [reader.seek(i) for i in range(9)]
    errors = []

    def work(seed):
        rng = np.random.default_rng(seed)
        for i in rng.integers(0, 9, 200):
            if reader.seek(int(i)) != want[i]:
                errors.append(int(i))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(s,)) for s in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert errors == []


@pytest.mark.parametrize("kind", ["imagenet_folder", "imagenet_zip", "tsv.yaml",
                                  "imagenet22k.yaml"])
def test_datasets_equal(files, kind):
    ours_cfg, theirs_cfg = _cfgs("DATA.PATH", str(files))
    if kind == "imagenet_folder":
        (files / "val").symlink_to(files / "folder")
    for cfg in (ours_cfg, theirs_cfg):
        cfg.DATA.TEST = ("imagenet" if kind == "imagenet_zip" else kind,)
    ours = loader.build_dataset(ours_cfg, is_train=False)[0]
    theirs = jax_loader.build_dataset(theirs_cfg, is_train=False)[0]
    assert type(ours).__name__ == type(theirs).__name__
    assert len(ours) == len(theirs) == (5 if kind == "tsv.yaml" else 9)
    for i in range(len(ours)):
        (a, ya), (b, yb) = ours[i], theirs[i]
        assert ya == yb
        np.testing.assert_array_equal(a, b)
    if kind == "tsv.yaml":
        assert [ours.get_img_key(i) for i in range(5)] == ["cat_0", "cat_2", "dog_1", "eel_0",
                                                         "eel_2"]
        assert [ours[i][1] for i in range(5)] == [0, 0, 1, 2, 2]


def test_concat_and_direct_datasets(files):
    folder = datasets.ImageFolder(str(files / "folder"))
    jfolder = jax_datasets.ImageFolder(str(files / "folder"))
    assert folder.class_to_idx == jfolder.class_to_idx == {"cat": 0, "dog": 1, "eel": 2}
    both = datasets.ConcatDataset([folder, datasets.SyntheticDataset(5, SIZE, 10)])
    jboth = jax_datasets.ConcatDataset([jfolder, jax_datasets.SyntheticDataset(5, SIZE, 10)])
    assert len(both) == len(jboth) == 14
    for i in (0, 8, 9, 13):
        np.testing.assert_array_equal(np.asarray(both[i][0]), np.asarray(jboth[i][0]))
        assert both[i][1] == jboth[i][1]


# -- the loader ------------------------------------------------------------------
@pytest.mark.parametrize("is_train,workers,opts", [
    (True, 0, ()),
    (True, 0, ("AUG.TIMM_AUG.USE_TRANSFORM", "True", "AUG.TIMM_AUG.AUTO_AUGMENT",
               "rand-m9-mstd0.5-inc1", "AUG.TIMM_AUG.RE_PROB", "0.25")),
    (False, 0, ()),
    (False, 3, ()),  # threads: the eval transforms draw nothing, the order holds
])
def test_epoch_loader_batches_equal(is_train, workers, opts):
    ours_cfg, theirs_cfg = _cfgs("DATA.TRAIN", "('synthetic',)", "DATA.TEST", "('synthetic',)",
                                 "DATA.NUM_CLASSES", "10", "DATALOADER.WORKERS", str(workers),
                                 *opts)

    def batches(make, cfg):
        ld = make(cfg, is_train=is_train, drop_last=is_train)
        ld = ld if is_train else ld[0]
        out = []
        for epoch in (0, 1):
            ld.sampler.set_epoch(epoch)
            out += _seeded(lambda: list(ld), 5)
        return ld, out

    ours_loader, ours = batches(loader.make_epoch_data_loader, ours_cfg)
    _, theirs = batches(jax_loader.make_epoch_data_loader, theirs_cfg)
    assert len(ours_loader) == 8 and len(ours) == len(theirs) == 16
    for (x, y), (jx, jy) in zip(ours, theirs):
        assert x.dtype == np.float32 and x.shape == (4, SIZE, SIZE, 3)
        np.testing.assert_array_equal(x, jx)
        np.testing.assert_array_equal(y, jy)


def test_loader_keeps_uint8_under_device_normalize():
    """INPUT.DEVICE_NORMALIZE: the port's batches stay uint8, for the model
    to normalise on the device (vil_tpu's loader casts them to f32, the same
    values)."""
    ours_cfg, theirs_cfg = _cfgs("DATA.TEST", "('synthetic',)", "INPUT.DEVICE_NORMALIZE", "True")
    (x, y), = list(loader.make_epoch_data_loader(ours_cfg, is_train=False)[0])[:1]
    (jx, jy), = list(jax_loader.make_epoch_data_loader(theirs_cfg, is_train=False)[0])[:1]
    assert x.dtype == np.uint8 and jx.dtype == np.float32
    np.testing.assert_array_equal(x.astype(np.float32), jx)
    np.testing.assert_array_equal(y, jy)


@pytest.mark.parametrize("what", ["dali"])
def test_loader_refuses_what_is_not_ported(what):
    """A backend that is neither 'threads' nor 'grain' (ported since the grain
    loader, tests/test_torch_grain_loader.py) raises; vil_tpu would read with
    threads."""
    cfg, _ = _cfgs("DATA.TEST", "('synthetic',)")
    cfg.DATALOADER.BACKEND = what
    with pytest.raises(ValueError, match="'threads', 'grain'"):
        loader.make_epoch_data_loader(cfg, is_train=False)


@pytest.mark.parametrize("is_train,rank", [(True, 0), (True, 1), (False, 1)])
def test_distributed_loader_shards_as_vil_tpu(is_train, rank):
    """A data replica's loader (``is_distributed``: replica ``rank`` of 2, half
    the batch, eval shuffled) reads the indices and batches vil_tpu's does."""
    ours_cfg, theirs_cfg = _cfgs("DATA.TRAIN", "('synthetic',)", "DATA.TEST", "('synthetic',)",
                                 "DATA.NUM_CLASSES", "10")
    shard = dict(is_train=is_train, drop_last=is_train, is_distributed=True, num_replicas=2,
                 rank=rank)
    ours, theirs = (make(cfg, **shard) for make, cfg in (
        (loader.make_epoch_data_loader, ours_cfg), (jax_loader.make_epoch_data_loader,
                                                    theirs_cfg)))
    ours, theirs = (ld if is_train else ld[0] for ld in (ours, theirs))
    for ld in (ours, theirs):
        ld.sampler.set_epoch(1)
    assert list(ours.sampler) == list(theirs.sampler) and ours.batch_size == 2
    for (x, y), (jx, jy) in zip(_seeded(lambda: list(ours), 5), _seeded(lambda: list(theirs), 5)):
        np.testing.assert_array_equal(x, jx)
        np.testing.assert_array_equal(y, jy)
