"""The port's ResNet zoo (``vil_tpu_torch/models/resnet.py``) against
``vil_tpu``'s flax ResNet on the CPU, in f32.

Narrow zoo entries (``layers=(1, 1, 1, 1)``) at 32² px: a basic-block
``resnet18``, a bottleneck ``resnet50`` and a grouped ``resnext50_32x4d``.
Each carries ``vil_tpu``'s variables (parameters and ``batch_stats`` drawn
from a numpy seed) into the port, then holds its f32 eval logits and
training loss, and its f64 AdamW training step (loss, every gradient, the
updated parameters and the BatchNorms' running statistics) and the eval
after it, to ``vil_tpu``'s jitted step in f64, to 1e-5 of each leaf's scale
(floored at 1). Then the zoo's parameter counts
(torchvision's), a torchvision-named ``state_dict`` through the port's
importer and ``vil_tpu``'s, the decay mask leaf by leaf, a ``vil_tpu``
msgpack checkpoint of a ResNet for eval and resume, and the CLI's Trainer
(an eval, a resume equal to an uninterrupted run). The step over two gloo
ranks is in ``tests/test_torch_sharding.py``, in its spawn of two.
"""
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vil_tpu.config import get_default_cfg as jax_default_cfg
from vil_tpu.models.resnet import build_resnet as jax_build_resnet
from vil_tpu.models.resnet import import_torch_resnet
from vil_tpu.train import engine as jax_engine
from vil_tpu.train import loss as jax_loss
from vil_tpu.train import optim as jax_optim
from vil_tpu.utils.checkpoint import Checkpointer as JaxCheckpointer

from vil_tpu_torch.config import get_default_cfg
from vil_tpu_torch.models import RESNET_ZOO, BatchNorm, build_model, build_resnet
from vil_tpu_torch.train import engine, loss, optim
from vil_tpu_torch.train.trainer import Trainer, check_ported, run_experiment
from vil_tpu_torch.utils import jax_import
from vil_tpu_torch.utils.checkpoint import Checkpointer
from vil_tpu_torch.utils.torch_import import import_torch_checkpoint

TOL = 1e-5
IMG, BATCH, CLASSES = 32, 4, 10
NARROW = dict(layers=(1, 1, 1, 1))
NAMES = ("resnet18", "resnet50", "resnext50_32x4d")
# canonical torchvision ImageNet-1000 parameter counts (tests/test_resnet.py:20)
PARAM_COUNTS = {
    "resnet18": 11_689_512, "resnet34": 21_797_672, "resnet50": 25_557_032,
    "resnet101": 44_549_160, "resnet152": 60_192_808, "resnext50_32x4d": 25_028_904,
    "resnext101_32x8d": 88_791_336, "wide_resnet50_2": 68_883_240,
    "wide_resnet101_2": 126_886_696,
}
RNG = np.random.default_rng(0)
IMAGES = RNG.standard_normal((2, BATCH, IMG, IMG, 3)).astype(np.float32)
LABELS = RNG.integers(0, CLASSES, (2, BATCH)).astype(np.int32)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One CPU thread for torch in this module: the driver's run gives each
    of its workers the machine's cores, and torch's pool on every one of
    them thrashes under the ResNet's convolutions (tests/test_torch_spatial_train.py
    does the same)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _draw(path, leaf):
    """A seeded value for one leaf of vil_tpu's variables: BatchNorm scales
    about 1, running variances in [0.5, 1.5], the rest LeCun-scaled normals."""
    rng = np.random.default_rng(zlib.crc32(jax.tree_util.keystr(path).encode()))
    key = path[-1].key
    if key == "scale":
        value = 1.0 + 0.1 * rng.standard_normal(leaf.shape)
    elif key == "var":
        value = rng.uniform(0.5, 1.5, leaf.shape)
    elif key in ("bias", "mean"):
        value = 0.1 * rng.standard_normal(leaf.shape)
    else:
        fan_in = int(np.prod(leaf.shape[:-1]))
        value = rng.standard_normal(leaf.shape) / np.sqrt(fan_in)
    return np.asarray(value, leaf.dtype)


_MODELS = {}


def _jax_side(name):
    """vil_tpu's narrow model of ``name`` and its drawn variables, once."""
    if name not in _MODELS:
        model = jax_build_resnet(name, CLASSES, **NARROW)
        shapes = jax.eval_shape(lambda: model.init({"params": jax.random.PRNGKey(0)},
                                                   jnp.zeros((1, IMG, IMG, 3))))
        _MODELS[name] = model, jax.tree_util.tree_map_with_path(_draw, dict(shapes))
    return _MODELS[name]


ADAMW = ["OPTIM.OPT", "adamw", "OPTIM.LR", "1e-2", "OPTIM.WD", "0.05"]
# the updated entries compared: gradient ≥ this share of its leaf's max. Adam's
# first update is LR·g/(|g| + eps): an element far below its leaf's max moves
# by a share of LR when the gradients differ by 1e-5 of that max
# (tests/test_torch_sharding.py's RESOLVED)
RESOLVED = 1e-4


def _cfg():
    cfg = get_default_cfg()
    cfg.merge_from_list(["DATA.NUM_CLASSES", str(CLASSES), "TPU.COMPUTE_DTYPE", "float32",
                         *ADAMW])
    return cfg


def _port(name, variables):
    model = build_resnet(name, CLASSES, device="cpu", **NARROW)
    return jax_import.load_jax_params(model, variables["params"],
                                      batch_stats=variables["batch_stats"])


def _port_tree(tree) -> dict:
    """A flax tree (params or batch_stats) under the port's names."""
    flat = dict(jax_import._flatten(tree))
    if any(n.endswith((".mean", ".var")) for n in flat):
        flat = jax_import._stats_tree(tree)
    return {n: a for n, a in (jax_import._to_torch_leaf(k, np.asarray(v, np.float32))
                              for k, v in flat.items())}


def _close(got: dict, ref: dict, what: str):
    assert set(got) == set(ref), what
    for k, r in ref.items():
        err = np.abs(got[k] - r).max(initial=0.0)
        assert err <= TOL * max(1.0, np.abs(r).max(initial=0.0)), f"{what} {k}: {err:.3e}"


@pytest.mark.parametrize("name", NAMES)
def test_resnet_step_matches_vil_tpu(name):
    """From vil_tpu's variables: the port's f32 eval logits and training
    loss, then one AdamW step of engine.make_train_step in f64 (loss, every
    gradient, the updated parameters and running statistics) and the eval
    after it, against vil_tpu's jitted step in f64 (JAX under
    ``enable_x64``; one compile for all of it). In f32 the training step's
    gradients are not compared to 1e-5: the batch variance E[x²] − E[x]²,
    which both packages take as flax defines it, loses digits to
    cancellation in a channel whose variance is small against its squared
    mean, and a BatchNorm gradient sums terms that cancel; two frameworks'
    f32 sums then differ by 3e-5 to 8e-2 of a gradient's scale at these
    shapes, while in f64 both agree to the logits' cast to f32, the only
    rounding left."""
    _, variables = _jax_side(name)
    f64 = torch.float64
    with jax.enable_x64(True):
        jmodel = jax_build_resnet(name, CLASSES, dtype=jnp.float64, param_dtype=jnp.float64,
                                  **NARROW)
        params = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64),
                                        variables["params"])
        jcfg = jax_default_cfg()
        jcfg.merge_from_list(ADAMW)
        tx = jax_optim.get_opt(jcfg, params, lr=1e-2)
        state = jax_engine.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                                      opt_state=tx.init(params),
                                      buffers={"batch_stats": variables["batch_stats"]})
        images = [jnp.asarray(IMAGES[i], jnp.float64) for i in range(2)]
        train_step = jax_engine.make_train_step(jmodel, jax_loss.cross_entropy, tx)

        @jax.jit
        def serve_step_serve(state, x0, x1, y1):  # one compile for all of it
            served = jmodel.apply({"params": state.params, **state.buffers}, x0)
            state, metrics = train_step(state, x1, y1, jax.random.PRNGKey(0))
            after = jmodel.apply({"params": state.params, **state.buffers}, x0)
            return served, state, metrics, after

        served, state, metrics, after = serve_step_serve(state, images[0], images[1],
                                                         jnp.asarray(LABELS[1]))
        adam = next(s for s in jax.tree_util.tree_leaves(
            state.opt_state, is_leaf=lambda s: isinstance(s, optax.ScaleByAdamState))
            if isinstance(s, optax.ScaleByAdamState))
        ref_grads = _port_tree(jax.tree_util.tree_map(lambda m: m / (1 - 0.9), adam.mu))

    ours = _port(name, variables)  # f32
    with torch.inference_mode():
        got = ours.eval()(torch.from_numpy(IMAGES[0]))
    assert got.dtype == torch.float32 and got.shape == (BATCH, CLASSES)
    _close({"logits": got.numpy()}, {"logits": np.asarray(served)}, "f32 eval")
    got_loss = loss.cross_entropy(ours.train()(torch.from_numpy(IMAGES[1])),
                                  torch.from_numpy(LABELS[1]).long())
    assert abs(got_loss.item() - float(metrics["loss"])) <= TOL

    ours = jax_import.load_jax_params(
        build_resnet(name, CLASSES, device="cpu", dtype=f64, param_dtype=f64, **NARROW),
        variables["params"], batch_stats=variables["batch_stats"])
    step = engine.make_train_step(ours, loss.cross_entropy, optim.get_opt(_cfg(), ours),
                                  device="cpu", seed=0)
    out = step(torch.from_numpy(IMAGES[1]).double(), torch.from_numpy(LABELS[1]).long())
    assert abs(out["loss"].item() - float(metrics["loss"])) <= TOL
    _close({n: p.grad.numpy() for n, p in ours.named_parameters()}, ref_grads, "grad")
    ref_params = _port_tree(state.params)
    for n, p in ours.named_parameters():
        keep = np.abs(ref_grads[n]) >= RESOLVED * np.abs(ref_grads[n]).max(initial=0.0)
        err = np.abs(p.detach().numpy() - ref_params[n])[keep].max(initial=0.0)
        assert err <= TOL, f"updated {n}: {err:.3e}"
    _close({n: b.numpy() for n, b in ours.named_buffers()},
           _port_tree(state.buffers["batch_stats"]), "running")
    with torch.inference_mode():
        got = ours.eval()(torch.from_numpy(IMAGES[0]).double())
    _close({"logits": got.numpy()}, {"logits": np.asarray(after)}, "eval after the step")


def test_batch_norm_is_flax_batch_norm():
    """The biased variance, E[x²] − E[x]² clipped at 0, momentum 0.9 in
    flax's sense; torch's BatchNorm2d keeps the unbiased one."""
    x = torch.from_numpy(RNG.standard_normal((3, 5, 4, 4)).astype(np.float32)) * 2 + 1
    bn = BatchNorm(5, device="cpu").train()
    y = bn(x)
    mean, var = x.mean((0, 2, 3)), x.var((0, 2, 3), unbiased=False)
    torch.testing.assert_close(bn.running_mean, 0.1 * mean, rtol=0, atol=1e-6)
    torch.testing.assert_close(bn.running_var, 0.9 + 0.1 * var, rtol=0, atol=1e-6)
    ref = (x - mean[None, :, None, None]) / torch.sqrt(var[None, :, None, None] + 1e-5)
    torch.testing.assert_close(y, ref, rtol=0, atol=1e-5)
    tbn = torch.nn.BatchNorm2d(5).train()
    tbn(x)
    assert not torch.allclose(tbn.running_var, bn.running_var, atol=1e-6)
    const = bn(torch.full((2, 5, 3, 3), 3.0))  # a constant batch: variance clipped to 0
    assert torch.isfinite(const).all()
    with torch.inference_mode():
        served = bn.eval()(x)
    torch.testing.assert_close(served, (x - bn.running_mean[None, :, None, None])
                               / torch.sqrt(bn.running_var[None, :, None, None] + 1e-5),
                               rtol=0, atol=1e-5)


def test_param_counts_and_build_model():
    """Every zoo entry holds torchvision's parameter count (built on the meta
    device); build_model routes the names, refuses PRETRAINED, computes in
    TPU.COMPUTE_DTYPE over f32 parameters and gives f32 logits."""
    for name, count in PARAM_COUNTS.items():
        model = build_resnet(name, 1000, device="meta")
        assert sum(p.numel() for p in model.parameters()) == count, name
    assert set(RESNET_ZOO) == set(PARAM_COUNTS)
    cfg = _cfg()
    cfg.merge_from_list(["MODEL.ARCH", "resnet18", "TPU.COMPUTE_DTYPE", "bfloat16"])
    check_ported(cfg)
    model = build_model(cfg, device="cpu")
    assert model.dtype == torch.bfloat16 and model.fc.weight.dtype == torch.float32
    x = torch.from_numpy(RNG.integers(0, 256, (2, IMG, IMG, 3), dtype=np.uint8))
    with torch.inference_mode():
        assert model.eval()(x).dtype == torch.float32
    cfg.merge_from_list(["MODEL.PRETRAINED", "True"])
    with pytest.raises(ValueError, match="hub"):
        build_model(cfg, device="cpu")


def test_decay_mask_matches_vil_tpu():
    """optim's decay mask on a ResNet, leaf by leaf: no BatchNorm leaf and
    not fc's bias is in the no-decay set, as in vil_tpu."""
    _, variables = _jax_side("resnet50")
    names = [jax_import._to_torch_leaf(k, v)[0]
             for k, v in jax_import._flatten(variables["params"])]
    flags = [bool(v) for _, v in jax_import._flatten(jax_optim.decay_mask(variables["params"]))]
    mask = optim.decay_mask(_port("resnet50", variables))
    assert mask == dict(zip(names, flags)) and all(mask.values())


def test_torchvision_state_dict_loads():
    """A state dict under torchvision's names (num_batches_tracked counters,
    a 1000-class fc) loads through the port's importer as vil_tpu's
    import_torch_resnet feeds its model: the same logits."""
    name = "resnet50"
    rng = np.random.default_rng(3)
    src = build_resnet(name, 1000, device="cpu", **NARROW)
    state = {}
    for k, v in src.state_dict().items():
        state[k] = (rng.uniform(0.5, 1.5, v.shape) if k.endswith("running_var")
                    else 0.05 * rng.standard_normal(v.shape)).astype(np.float32)
        if k.endswith("running_var"):
            state[k.replace("running_var", "num_batches_tracked")] = np.array(7)
    ours = import_torch_checkpoint(state, build_resnet(name, CLASSES, device="cpu", **NARROW))
    assert torch.equal(ours.fc.weight, torch.from_numpy(state["fc.weight"][:CLASSES]))
    jvars = import_torch_resnet(state)
    jvars["params"]["fc"] = {"kernel": state["fc.weight"][:CLASSES].T,
                             "bias": state["fc.bias"][:CLASSES]}
    want = jax.jit(jax_build_resnet(name, CLASSES, **NARROW).apply)(jvars,
                                                                   jnp.asarray(IMAGES[0]))
    with torch.inference_mode():
        got = ours.eval()(torch.from_numpy(IMAGES[0]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=TOL)


def _experiment_opts(out_dir, *extra):
    return ["MODEL.ARCH", "resnet18", "INPUT.IMAGE_SIZE", str(IMG), "DATA.NUM_CLASSES",
            str(CLASSES), "DATALOADER.BSZ", "4", "DATALOADER.WORKERS", "0",
            "DATA.TRAIN", "('synthetic',)", "DATA.TEST", "('synthetic',)",
            "TPU.COMPUTE_DTYPE", "float32", "OPTIM.OPT", "adamw", "OPTIM.LR", "1e-3",
            "OPTIM.EPOCHS", "2", "SOLVER.LR_POLICY", "cosine", "SOLVER.WARMUP_EPOCHS", "1.0",
            "LOG_FREQ", "1", "AUG.TIMM_AUG.USE_TRANSFORM", "True", "AUG.TIMM_AUG.HFLIP", "0.0",
            "AUG.TIMM_AUG.VFLIP", "0.0", "AUG.TIMM_AUG.AUTO_AUGMENT", "",
            "AUG.TIMM_AUG.RE_PROB", "0.0", "AUG.SCALE", "(1.0, 1.0)", "AUG.RATIO", "(1.0, 1.0)",
            "MODEL.VIT.MSVIT.MODE", "1", "OUTPUT_DIR", str(out_dir), *extra]


class _Stop(Exception):
    pass


def test_experiment_trains_evaluates_and_resumes(tmp_path, monkeypatch):
    """run_experiment with MODEL.ARCH resnet18 (its zoo entry narrowed to a
    block a stage): two epochs, an eval each, the checkpoint's running
    statistics; MODE 1 starts no random shift; a run stopped at epoch 1 and
    resumed equals the uninterrupted one."""
    monkeypatch.setitem(RESNET_ZOO, "resnet18", dict(RESNET_ZOO["resnet18"], **NARROW))
    cfg = get_default_cfg()
    cfg.merge_from_list(_experiment_opts(tmp_path / "run"))
    trainer = run_experiment(cfg, device="cpu")
    assert trainer.steps_run == {False: 16, True: 0} and len(trainer.evals) == 3
    assert all(np.isfinite(r["loss"]) for r in trainer.steps_log)
    saved = torch.load(tmp_path / "run" / "checkpoint_2.ckpt", weights_only=True)["model"]
    for k, v in trainer.model.state_dict().items():
        if "running" in k and trainer.best_evaluated is False:
            assert torch.equal(v, saved[k]), k
    assert not torch.equal(saved["bn1.running_var"], torch.ones(64))

    cut = get_default_cfg()
    cut.merge_from_list(_experiment_opts(tmp_path / "cut"))
    first = Trainer(cut, device="cpu")
    train_epoch = first.train_epoch

    def stop_at_epoch_1(epoch, meters=None):
        if epoch == 1:
            raise _Stop
        train_epoch(epoch, meters)

    first.train_epoch = stop_at_epoch_1
    with pytest.raises(_Stop):
        first.fit()
    second = Trainer(cut, device="cpu")
    assert (second.start_epoch, second.train_step.step) == (1, 8)
    second.fit()
    np.testing.assert_allclose([r["loss"] for r in first.steps_log + second.steps_log],
                               [r["loss"] for r in trainer.steps_log], rtol=0, atol=TOL)
    assert [e["top1"] for e in second.evals] == [e["top1"] for e in trainer.evals[1:]]


def test_vil_tpu_checkpoint_with_batch_stats(tmp_path):
    """A vil_tpu ResNet state (params, batch_stats, AdamW moments) written by
    its Checkpointer: EVALUATE's load gives vil_tpu's logits, a resume takes
    the moments and the running statistics; a MsViT given a batch_stats
    collection refuses its unused leaves. Both packages' zoo entry narrowed
    to a block a stage."""
    name = "resnet18"
    jcfg = jax_default_cfg()
    jcfg.merge_from_list(["MODEL.ARCH", name, "DATA.NUM_CLASSES", str(CLASSES),
                          "TPU.COMPUTE_DTYPE", "float32", "OPTIM.OPT", "adamw"])
    jmodel = jax_build_resnet(name, CLASSES, **NARROW)
    shapes = jax.eval_shape(lambda: jmodel.init({"params": jax.random.PRNGKey(0)},
                                                jnp.zeros((1, IMG, IMG, 3))))
    variables = jax.tree_util.tree_map_with_path(_draw, dict(shapes))
    params = variables["params"]
    tx = jax_optim.get_opt(jcfg, params, lr=1e-3)
    state = jax_engine.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                                  opt_state=tx.init(params),
                                  buffers={"batch_stats": variables["batch_stats"]})
    train_step = jax_engine.make_train_step(jmodel, jax_loss.cross_entropy, tx)

    @jax.jit
    def step_then_serve(state, x1, y1, x0):  # one compile for both
        state, _ = train_step(state, x1, y1, jax.random.PRNGKey(0))
        return state, jmodel.apply({"params": state.params, **state.buffers}, x0)

    state, want = step_then_serve(state, *(jnp.asarray(a) for a in (IMAGES[1], LABELS[1],
                                                                     IMAGES[0])))
    arch = jcfg.MODEL.VIT.MSVIT.ARCH
    path = JaxCheckpointer(str(tmp_path / "jax"), arch=arch).save(1, state)

    cfg = _cfg()
    cfg.merge_from_list(["MODEL.ARCH", name, "OPTIM.LR", "1e-3", "OPTIM.WD", "1e-4"])
    model = build_resnet(name, CLASSES, device="cpu", **NARROW)
    opt = optim.get_opt(cfg, model)
    Checkpointer("", arch=arch, is_test=True).load(model, opt, path, resume=False)
    with torch.inference_mode():
        got = model.eval()(torch.from_numpy(IMAGES[0]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=TOL)
    header = Checkpointer(str(tmp_path / "jax"), arch=arch).load(model, opt)
    assert header["step"] == 1 and len(opt.state) == len(list(model.parameters()))
    _close({n: b.numpy() for n, b in model.named_buffers()},
           _port_tree(state.buffers["batch_stats"]), "running")
    vit = get_default_cfg()
    vit.merge_from_list(["DATA.NUM_CLASSES", str(CLASSES)])
    with pytest.raises(KeyError, match="unused"):
        jax_import.vil_tpu_payload(build_model(vit, device="cpu"), None, {
            "params": {}, "buffers": {"batch_stats": variables["batch_stats"]}, "step": 0})
