"""The port's trainer stack against ``vil_tpu`` on the CPU, in f32, at a
narrow 32-px model (batch 8, 8 steps an epoch on the synthetic set):

* qhm and lamb trajectories (5 steps, the same gradients drawn from numpy)
  against optax's through ``vil_tpu``'s ``get_opt``, to 1e-5 of each
  parameter's largest value; the plateau drop (``lr_scale``) against
  ``drop_lr`` on ``lr_scalable``, to 1e-4 of each parameter's update;
* the checkpointer's files and cycle; a reference ``.pth`` imported by the
  port against ``vil_tpu``'s importer followed by ``load_jax_params``
  (position-embedding and relative-position-table resize, head truncation),
  to 1e-6 (the resize in numpy against ``jax.image.resize``);
* the Trainer against ``vil_tpu``'s from the same initial weights (MODE 0,
  no mixup, drop path 0, the XLA tier): per-step losses over two epochs to
  1e-4 relative, every eval's top1 equal; EVALUATE's ``results_0.npz`` with
  the same keys, shapes and predicted ids;
* a run stopped after its first epoch and resumed by a new Trainer equals an
  uninterrupted one exactly (random shift, mixup and drop path on: their
  draws are keyed by the step), as ``tests/test_resume_determinism.py``
  holds ``vil_tpu``, with the same draw-free data pipeline.
"""
import json
import os
import random
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vil_tpu.config import get_default_cfg as jax_default_cfg
from vil_tpu.models import build_model as jax_build_model
from vil_tpu.train import engine as jax_engine
from vil_tpu.train import loss as jax_loss
from vil_tpu.train import optim as jax_optim
from vil_tpu.train.trainer import Trainer as JaxTrainer
from vil_tpu.train.trainer import drop_lr as jax_drop_lr
from vil_tpu.train.trainer import lr_scalable
from vil_tpu.utils import torch_import as jax_torch_import

from vil_tpu_torch.config import get_default_cfg
from vil_tpu_torch.models import build_model
from vil_tpu_torch.run_experiment import config_from_args, main, parse_args
from vil_tpu_torch.train import engine, loss, optim, redraw
from vil_tpu_torch.train.trainer import Trainer
from vil_tpu_torch.utils import jax_import, torch_import
from vil_tpu_torch.utils.checkpoint import Checkpointer

ARCH = "l1,h1,d16,n1,s1,g1,p4,f2_l2,h2,d32,n1,s1,g1,p2,f2_l3,h2,d32,n1,s0,g0,p2,f2"
ARCH_RPE = ARCH + ",a0"  # the dense stage with relative position bias


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One CPU thread for torch in this module: the test runner's workers
    share the cores, and torch's own threads, one a core in each worker,
    spin against each other."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _opts(out_dir, *extra):
    return ["MODEL.VIT.MSVIT.ARCH", ARCH, "INPUT.IMAGE_SIZE", "32", "DATA.NUM_CLASSES", "10",
            "DATALOADER.BSZ", "8", "DATALOADER.WORKERS", "0", "DATA.TRAIN", "('synthetic',)",
            "DATA.TEST", "('synthetic',)", "TPU.COMPUTE_DTYPE", "float32",
            "TPU.USE_PALLAS", "False", "MODEL.VIT.DROP_PATH", "0.0", "OPTIM.LR", "1e-3",
            "OPTIM.WD", "0.05", "OPTIM.EPOCHS", "2", "SOLVER.LR_POLICY", "cosine",
            "SOLVER.WARMUP_EPOCHS", "1.0", "LOG_FREQ", "1", "OUTPUT_DIR", str(out_dir), *extra]


def _cfg(out_dir, *extra, jax_side=False):
    cfg = (jax_default_cfg if jax_side else get_default_cfg)()
    cfg.merge_from_list(_opts(out_dir, *extra))
    return cfg


@pytest.fixture(scope="module", autouse=True)
def jitted_jax_init():
    """``vil_tpu``'s Trainer initialises its model through
    ``engine.create_train_state``, eagerly: op by op, 40-50 s for the narrow
    model. The same state from a jitted ``model.init`` for this module's
    ``vil_tpu`` Trainers; the port loads whatever parameters they hold."""

    def create_train_state(model, tx, rng, sample_input):
        variables = dict(jax.jit(model.init)({"params": rng}, sample_input))
        params = variables.pop("params")
        return jax_engine.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                                     opt_state=tx.init(params), buffers=variables)

    original = jax_engine.create_train_state
    jax_engine.create_train_state = create_train_state
    yield
    jax_engine.create_train_state = original


def _seed(seed=42):
    """The host augmentation streams, as ``set_seed`` leaves them."""
    random.seed(seed)
    np.random.seed(seed)


def _param_shapes(model, size=32):
    """The flax parameter tree of ``model`` as shapes (no initialisation)."""
    x = jnp.zeros((1, size, size, 3))
    return jax.eval_shape(lambda: model.init({"params": jax.random.PRNGKey(0)}, x))["params"]


def _flax_params(ours, shapes):
    """The port model's parameters as a flax tree shaped like ``shapes``: the
    inverse of ``load_jax_params``. The leaves are copies: JAX may alias a
    host buffer, which the port's in-place updates would then change under
    a step still running."""
    params = {n: p.detach().float().numpy() for n, p in ours.named_parameters()}

    def leaf(path, sds):
        name = ".".join(str(k.key) for k in path)
        arr = params[jax_import._to_torch_leaf(name, np.zeros(sds.shape, np.float32))[0]]
        if name.endswith("kernel"):
            arr = arr.T if arr.ndim == 2 else arr.transpose(2, 3, 1, 0)
        assert arr.shape == sds.shape, name
        return jnp.array(arr, copy=True)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _torch_tree(tree) -> dict:
    """A flax-shaped tree under the port's names and layouts."""
    return {name: arr for name, arr in (jax_import._to_torch_leaf(n, np.asarray(a))
                                        for n, a in jax_import._flatten(tree))}


def _tiny(cfg, seed=0):
    return build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(seed))


# -- optimizers ---------------------------------------------------------------------
@pytest.mark.parametrize("opt,extra", [
    ("qhm", ["OPTIM.NU", "0.7", "OPTIM.MOM", "0.9", "OPTIM.WD", "0.1"]),
    ("qhm", ["OPTIM.NU", "1.0", "OPTIM.WD", "0.0"]),
    ("lamb", ["OPTIM.WD", "0.1", "OPTIM.WD0", "0.05"]),
    ("lamb", ["OPTIM.WD", "0.0"]),
])
def test_optimizer_trajectory_matches_optax(opt, extra, tmp_path):
    """Five steps from the same weights on the same gradients: the decay
    mask, qhm's L2 and momentum forms, lamb's trust ratio and WD0."""
    opts = ["OPTIM.OPT", opt, "OPTIM.LR", "0.05", *extra]
    cfg, jcfg = _cfg(tmp_path, *opts), _cfg(tmp_path, *opts, jax_side=True)
    ours = _tiny(cfg)
    params = _flax_params(ours, _param_shapes(jax_build_model(jcfg, use_pallas=False)))
    tx = jax_optim.get_opt(jcfg, params)
    opt_state = tx.init(params)
    optimizer = optim.get_opt(cfg, ours)
    rng = np.random.default_rng(1)
    for _ in range(5):
        grads = jax.tree_util.tree_map(
            lambda p: jnp.asarray(rng.standard_normal(p.shape).astype(np.float32)), params)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        for name, g in _torch_tree(grads).items():
            dict(ours.named_parameters())[name].grad = torch.from_numpy(g.copy())
        optimizer.step()
    ref = _torch_tree(params)
    for name, p in ours.named_parameters():
        scale = np.abs(ref[name]).max(initial=1e-30)
        assert np.abs(p.detach().numpy() - ref[name]).max(initial=0.0) <= 1e-5 * scale, name


def test_lr_scale_drop_matches_drop_lr(tmp_path):
    """Two sgd steps, the plateau drop by 10, two more: the port's train step
    with ``drop_lr`` against ``lr_scalable`` with ``drop_lr``, the same
    images and weights: each parameter's update to 1e-4 of its largest, plus
    the f32 rounding of the parameter itself (1e-6 of its largest value;
    the update is a difference of two f32 parameters). Without the drop the
    last two updates would be ten times as large."""
    opts = ["OPTIM.OPT", "sgd", "OPTIM.LR", "0.1", "OPTIM.MOM", "0.9"]
    cfg, jcfg = _cfg(tmp_path, *opts), _cfg(tmp_path, *opts, jax_side=True)
    ours = _tiny(cfg)
    jax_model = jax_build_model(jcfg, use_pallas=False)
    params = _flax_params(ours, _param_shapes(jax_model))
    initial = {n: p.detach().clone().numpy() for n, p in ours.named_parameters()}
    tx = lr_scalable(jax_optim.get_opt(jcfg, params))
    state = jax_engine.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                                  opt_state=tx.init(params), buffers={})
    jax_step = jax.jit(jax_engine.make_train_step(jax_model, jax_loss.cross_entropy, tx))
    step = engine.make_train_step(ours, loss.cross_entropy, optim.get_opt(cfg, ours),
                                  device="cpu", seed=0)
    rng = np.random.default_rng(2)
    for i in range(4):
        if i == 2:
            state = jax_drop_lr(state, 10.0)
            optim.drop_lr(step, 10.0)
        x = rng.standard_normal((4, 32, 32, 3)).astype(np.float32)
        y = rng.integers(0, 10, 4)
        state, _ = jax_step(state, jnp.asarray(x), jnp.asarray(y), jax.random.PRNGKey(i))
        step(torch.from_numpy(x), torch.from_numpy(y))
    assert step.lr_scale == pytest.approx(0.1) and step.step == 4
    ref = _torch_tree(state.params)
    for name, p in ours.named_parameters():
        ref_update, update = ref[name] - initial[name], p.detach().numpy() - initial[name]
        tol = 1e-4 * np.abs(ref_update).max(initial=0.0) + 1e-6 * np.abs(ref[name]).max(initial=0)
        assert np.abs(update - ref_update).max(initial=0.0) <= tol, name


# -- checkpoints ------------------------------------------------------------------
def test_checkpointer_cycle(tmp_path):
    """The save/load cycle (weights, optimizer state, step, lr_scale), the
    tag file, model_best, ONLY_SAVE_LAST, model_init, a missing path, the
    DATA_DIR fallback and the checkpoints the port cannot read."""
    cfg = _cfg(tmp_path, "OPTIM.OPT", "adamw")
    model = _tiny(cfg)
    optimizer = optim.get_opt(cfg, model)
    model.zero_grad()
    for p in model.parameters():
        p.grad = torch.ones_like(p)
    optimizer.step()
    ck = Checkpointer(str(tmp_path / "run"), arch=ARCH)
    assert ck.load(model, optimizer) == {}  # nothing yet: the init is saved
    assert (tmp_path / "run" / "model_init.ckpt").is_file()
    path = ck.save(3, model, optimizer, step=24, lr_scale=0.1, best_acc=12.5, is_best=True)
    assert path == str(tmp_path / "run" / "checkpoint_3.ckpt")
    assert (tmp_path / "run" / "last_checkpoint").read_text() == "checkpoint_3.ckpt"
    assert json.loads((tmp_path / "run" / "checkpoint_3.ckpt.json").read_text()) == dict(
        arch=ARCH, epoch=3, best_acc=12.5)
    assert (tmp_path / "run" / "model_best.ckpt").read_bytes() == open(path, "rb").read()

    fresh = _tiny(cfg, seed=1)
    fresh_opt = optim.get_opt(cfg, fresh)
    header = Checkpointer(str(tmp_path / "run"), arch=ARCH).load(fresh, fresh_opt)
    assert header == dict(arch=ARCH, epoch=3, best_acc=12.5, step=24, lr_scale=0.1)
    for (n, a), b in zip(model.state_dict().items(), fresh.state_dict().values()):
        assert torch.equal(a, b), n
    saved, loaded = optimizer.state_dict(), fresh_opt.state_dict()
    assert loaded["param_groups"] == saved["param_groups"]
    for i, st in saved["state"].items():
        assert all(torch.equal(torch.as_tensor(v), torch.as_tensor(loaded["state"][i][k]))
                   for k, v in st.items()), i
    # a test-time load takes the weights only, through DATA_DIR when relative
    evaluator = _tiny(cfg, seed=2)
    eval_opt = optim.get_opt(cfg, evaluator)
    header = Checkpointer("", is_test=True, data_dir=str(tmp_path)).load(
        evaluator, eval_opt, "run/model_best.ckpt", resume=False)
    assert header["epoch"] == 3 and "step" not in header and not eval_opt.state
    assert torch.equal(evaluator.head.weight, model.head.weight)
    assert Checkpointer("", is_test=True).load(evaluator, eval_opt, str(tmp_path / "no")) == {}

    last = Checkpointer(str(tmp_path / "last"), only_save_last=True)
    for epoch in (1, 2):
        last.save(epoch, model, optimizer, step=8 * epoch)
    assert sorted(os.listdir(tmp_path / "last")) == [
        "checkpoint_last.ckpt", "checkpoint_last.ckpt.json", "last_checkpoint"]

    # a vil_tpu checkpoint is read (tests/test_torch_vil_checkpoint.py); a
    # msgpack map cut short, one that is not vil_tpu's payload, and a file of
    # neither format raise
    (tmp_path / "flax.ckpt").write_bytes(b"\x82\xa6params\x80")  # a msgpack map, cut short
    with pytest.raises(ValueError, match="truncated"):
        Checkpointer("").load(model, optimizer, str(tmp_path / "flax.ckpt"), resume=False)
    (tmp_path / "flax.ckpt").write_bytes(b"\x81\xa6params\x80")
    with pytest.raises(ValueError, match="not a vil_tpu checkpoint payload"):
        Checkpointer("").load(model, optimizer, str(tmp_path / "flax.ckpt"), resume=False)
    (tmp_path / "text.ckpt").write_bytes(b"neither")
    with pytest.raises(ValueError, match="neither"):
        Checkpointer("").load(model, optimizer, str(tmp_path / "text.ckpt"), resume=False)
    (tmp_path / "state.orbax").mkdir()
    with pytest.raises(NotImplementedError, match="A6"):
        Checkpointer("").load(model, optimizer, str(tmp_path / "state.orbax"), resume=False)


@pytest.mark.parametrize("src_size,src_classes", [(32, 10), (64, 20), (16, 10)])
def test_pth_import_matches_vil_tpu(src_size, src_classes, tmp_path):
    """A reference-named .pth (``module.`` prefixes, the ``net`` key) made
    from random weights of a model at ``src_size`` px and ``src_classes``
    classes, through ``vil_tpu``'s own key mapping, imported into a 32-px,
    10-class model: the port's importer against ``vil_tpu``'s followed by
    ``load_jax_params``. The APE embeddings (stages 1-2) and the dense
    stage's relative-position table resize when the size differs (shrinking
    and growing), the head truncates from 20 classes."""
    opts = ["MODEL.VIT.MSVIT.ARCH", ARCH_RPE]
    src_cfg = _cfg(tmp_path, *opts, "INPUT.IMAGE_SIZE", str(src_size), "DATA.NUM_CLASSES",
                   str(src_classes), jax_side=True)
    shapes = _param_shapes(jax_build_model(src_cfg, use_pallas=False), src_size)
    rng = np.random.default_rng(3)
    state = {}
    for path, sds in jax.tree_util.tree_flatten_with_path(shapes)[0]:
        key = jax_torch_import._flax_path_to_torch_key(path)
        name = ".".join(str(k.key) for k in path)
        arr = rng.standard_normal(sds.shape).astype(np.float32)
        state["module." + key] = torch.from_numpy(
            np.ascontiguousarray(jax_import._to_torch_leaf(name, arr)[1]))
    torch.save({"net": state, "epoch": 3}, tmp_path / "ref.pth")

    cfg = _cfg(tmp_path, *opts)
    ours = torch_import.load_into_model(str(tmp_path / "ref.pth"), _tiny(cfg))
    start = _flax_params(_tiny(cfg), _param_shapes(jax_build_model(
        _cfg(tmp_path, *opts, jax_side=True), use_pallas=False)))
    theirs = jax_import.load_jax_params(
        _tiny(cfg, seed=5), jax_torch_import.load_into_model(str(tmp_path / "ref.pth"), start))
    changed = 0
    for (name, a), b in zip(ours.state_dict().items(), theirs.state_dict().values()):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-6, err_msg=name)
        changed += not torch.equal(a, _tiny(cfg).state_dict()[name])
    assert changed == len(state)  # every tensor was imported


def test_pth_import_maps_the_performer_projection(tmp_path):
    """A reference .pth of a performer model holds each projection under
    ``attn.fast_attention.projection_matrix``: the port's importer fills its
    buffers as ``vil_tpu``'s ``load_into_variables`` fills its ``buffers``
    collection, and the parameters as before."""
    opts = ["MODEL.VIT.MSVIT.ATTN_TYPE", "performer", "MODEL.VIT.MSVIT.ARCH",
            ARCH.replace("f2", "f4")]
    jax_model = jax_build_model(_cfg(tmp_path, *opts, jax_side=True), use_pallas=False)
    variables = jax.eval_shape(lambda: jax_model.init({"params": jax.random.PRNGKey(0)},
                                                      jnp.zeros((1, 32, 32, 3))))
    rng = np.random.default_rng(4)
    state = {}
    for path, sds in jax.tree_util.tree_flatten_with_path(
            {"params": variables["params"], "buffers": variables["buffers"]})[0]:
        key = jax_torch_import._flax_path_to_torch_key(path[1:])
        name = ".".join(str(k.key) for k in path[1:])
        arr = rng.standard_normal(sds.shape).astype(np.float32)
        state[key] = torch.from_numpy(np.ascontiguousarray(jax_import._to_torch_leaf(name, arr)[1]))
    assert sum(k.endswith("attn.fast_attention.projection_matrix") for k in state) == 2
    torch.save({"net": state}, tmp_path / "ref.pth")

    cfg = _cfg(tmp_path, *opts)
    ours = torch_import.load_into_model(str(tmp_path / "ref.pth"), _tiny(cfg))
    start = {"params": _flax_params(_tiny(cfg), variables["params"]),
             "buffers": jax.tree_util.tree_map(lambda s: jnp.zeros(s.shape, s.dtype),
                                               variables["buffers"])}
    ref = jax_torch_import.load_into_variables(str(tmp_path / "ref.pth"), start)
    theirs = jax_import.load_jax_params(_tiny(cfg, seed=5), ref["params"], ref["buffers"])
    for (name, a), b in zip(ours.state_dict().items(), theirs.state_dict().values()):
        np.testing.assert_array_equal(a.numpy(), b.numpy(), err_msg=name)
    for name, buf in ours.named_buffers():
        assert name.endswith("attn.projection_matrix") and not torch.equal(
            buf, dict(_tiny(cfg).named_buffers())[name])


# -- the Trainer ------------------------------------------------------------------
def _jax_losses(trainer):
    """Record each step's loss of a vil_tpu Trainer."""
    losses = []
    get = trainer._get_train_step

    def patched(random_shift):
        fn = get(random_shift)

        def wrapped(state, images, targets, rng):
            new_state, metrics = fn(state, images, targets, rng)
            losses.append(float(metrics["loss"]))
            return new_state, metrics

        return wrapped

    trainer._get_train_step = patched
    return losses


def _jax_evals(trainer):
    top1s = []
    validate = trainer.validate

    def recorded(*args, **kwargs):
        top1s.append(validate(*args, **kwargs))
        return top1s[-1]

    trainer.validate = recorded
    return top1s


def test_trainer_matches_vil_tpu(tmp_path):
    """Two epochs of AdamW with warmup-cosine at MODE 0 from the same initial
    weights and the same data (the default train transforms under the same
    seeds): per-step losses to 1e-4 relative, every eval's top1 equal (the
    final best-checkpoint eval included), the same best accuracy."""
    jt = JaxTrainer(_cfg(tmp_path / "jax", jax_side=True))
    init = jt.state.params
    jax_losses, jax_top1 = _jax_losses(jt), _jax_evals(jt)
    _seed()
    jax_final = jt.fit()

    pt = Trainer(_cfg(tmp_path / "port"), device="cpu")
    jax_import.load_jax_params(pt.model, init)
    _seed()
    final = pt.fit()
    losses = [r["loss"] for r in pt.steps_log]
    assert len(losses) == len(jax_losses) == 16
    np.testing.assert_allclose(losses, jax_losses, rtol=1e-4, atol=0)
    assert [e["top1"] for e in pt.evals] == jax_top1 and final == jax_final
    assert pt.best_acc == jt.best_acc and pt.best_evaluated
    assert [r["step"] for r in pt.steps_log] == list(range(16))


def test_evaluate_results_match_vil_tpu(tmp_path):
    """EVALUATE from the same weights: results_0.npz with vil_tpu's keys and
    shapes, the same predicted ids, correctness flags, targets and indices,
    the logits to 1e-5."""
    for side in ("jax", "port"):
        (tmp_path / side).mkdir()
    jt = JaxTrainer(_cfg(tmp_path / "jax", "EVALUATE", "True", jax_side=True))
    jt.fit()
    pt = Trainer(_cfg(tmp_path / "port", "EVALUATE", "True"), device="cpu")
    jax_import.load_jax_params(pt.model, jt.state.params)
    pt.fit()
    ours, theirs = np.load(tmp_path / "port/results_0.npz"), np.load(tmp_path / "jax/results_0.npz")
    assert sorted(ours.files) == sorted(theirs.files)
    for key in theirs.files:
        assert ours[key].shape == theirs[key].shape, key
        if key == "pred_scores":
            np.testing.assert_allclose(ours[key], theirs[key], rtol=0, atol=1e-5)
        else:
            np.testing.assert_array_equal(ours[key], theirs[key], err_msg=key)
    assert ours["pred_ids"].shape == (64, 5) and not (tmp_path / "port/model_init.ckpt").exists()


def test_performer_redraws_on_the_schedule_and_resumes(tmp_path, monkeypatch):
    """A performer run, 2 epochs of 8 steps and a resume to 3: the
    projections change before exactly the steps ``RedrawSchedule`` names
    (1, 3, 5, 7 at interval 1; 14 at interval 6) and at no other, each draw
    keyed by the step; the checkpoint reloads bit for bit, buffers
    included; the resumed Trainer's schedule counts afresh (8 calls at
    interval 11, no redraw), as ``vil_tpu``'s does."""
    opts = ["MODEL.VIT.MSVIT.ATTN_TYPE", "performer", "MODEL.VIT.MSVIT.ARCH",
            ARCH.replace("f2", "f4"), "DATALOADER.BSZ", "2"]
    changed, seen = [], {}

    def buffers(model):
        return {n: b.clone() for n, b in model.named_buffers()}

    call = engine.TrainStep.__call__

    def watched(self, *args, **kwargs):
        now = buffers(self.model)
        if any(not torch.equal(b, seen["last"][n]) for n, b in now.items()):
            changed.append(self.step)
        out = call(self, *args, **kwargs)
        assert all(torch.equal(b, now[n]) for n, b in self.model.named_buffers())
        seen["last"] = now
        return out

    monkeypatch.setattr(engine.TrainStep, "__call__", watched)
    first = Trainer(_cfg(tmp_path, *opts), device="cpu")
    assert len(buffers(first.model)) == 2
    seen["last"] = buffers(first.model)
    first.fit()
    assert changed == first.redraw_steps == [1, 3, 5, 7, 14]
    saved = torch.load(tmp_path / "checkpoint_2.ckpt", weights_only=True)["model"]
    for n, b in seen["last"].items():
        assert torch.equal(saved[n], b)  # the buffers the last step saw
    # each redraw is the draw keyed by (TPU.SEED, step, 2)
    probe = _tiny(_cfg(tmp_path, *opts))
    redraw.redraw_projections(probe, torch.Generator().manual_seed(
        engine.keyed_seed(first.cfg.TPU.SEED, 14, 2)))
    for n, b in probe.named_buffers():
        assert torch.equal(b, saved[n])

    changed.clear()
    second = Trainer(_cfg(tmp_path, *opts, "OPTIM.EPOCHS", "3"), device="cpu")
    assert second.start_epoch == 2 and second.train_step.step == 16
    for n, t in second.model.state_dict().items():
        assert torch.equal(t, saved[n]), n
    seen["last"] = buffers(second.model)
    second.fit()
    assert changed == second.redraw_steps == []
    assert second.redraw_schedule.interval == 11
    assert second.redraw_schedule.calls_since_last == 8
    # build_model reads SHARE_KV: a linformer without it has a proj_v
    lin = ["MODEL.VIT.MSVIT.ATTN_TYPE", "linformer"]
    for share_kv, has_v in (("True", False), ("False", True)):
        model = _tiny(_cfg(tmp_path, *lin, "MODEL.VIT.MSVIT.SHARE_KV", share_kv))
        names = [n for n, _ in model.named_parameters()]
        assert ("stage1_block0_attn.attn.proj_v" in names) == has_v
        assert "stage1_block0_attn.attn.proj_k" in names


def test_random_shift_active_at_the_switch(tmp_path):
    cfg = _cfg(tmp_path, "EVALUATE", "True", "MODEL.VIT.MSVIT.MODE", "1",
               "MODEL.VIT.MSVIT.VIL_MODE_SWITCH", "0.75", "OPTIM.EPOCHS", "100")
    t = Trainer(cfg, device="cpu")
    jcfg = _cfg(tmp_path, "EVALUATE", "True", "MODEL.VIT.MSVIT.MODE", "1",
                "MODEL.VIT.MSVIT.VIL_MODE_SWITCH", "0.75", "OPTIM.EPOCHS", "100", jax_side=True)
    for mode, attn in ((1, "longformerhand"), (0, "longformerhand"), (1, "full")):
        for c in (cfg, jcfg):
            c.merge_from_list(["MODEL.VIT.MSVIT.MODE", str(mode), "MODEL.VIT.MSVIT.ATTN_TYPE", attn])
        got = [t._random_shift_active(e) for e in (0, 74, 75, 99)]
        want = [JaxTrainer._random_shift_active(SimpleNamespace(cfg=jcfg), e)
                for e in (0, 74, 75, 99)]
        assert got == want == ([True, True, False, False] if (mode, attn) == (1, "longformerhand")
                               else [False] * 4)


def _resume_opts(out_dir):
    """Random shift for epochs 0-1 of 3, mixup, drop path; the data draws
    nothing (the crop keeps the whole square image, no flips, no RandAugment,
    no erasing), as tests/test_resume_determinism.py makes vil_tpu's."""
    return _opts(out_dir, "OPTIM.EPOCHS", "3", "MODEL.VIT.MSVIT.MODE", "1",
                 "MODEL.VIT.MSVIT.VIL_MODE_SWITCH", "0.5", "MODEL.VIT.DROP_PATH", "0.1",
                 "AUG.MIXUP_PROB", "1.0", "AUG.MIXUP", "0.8", "AUG.MIXCUT", "1.0",
                 "LOSS.LABEL_SMOOTHING", "0.1", "AUG.TIMM_AUG.USE_TRANSFORM", "True",
                 "AUG.TIMM_AUG.HFLIP", "0.0", "AUG.TIMM_AUG.VFLIP", "0.0",
                 "AUG.TIMM_AUG.AUTO_AUGMENT", "", "AUG.TIMM_AUG.RE_PROB", "0.0",
                 "AUG.SCALE", "(1.0, 1.0)", "AUG.RATIO", "(1.0, 1.0)")


class _Stop(Exception):
    pass


def test_resumed_run_equals_an_uninterrupted_one(tmp_path):
    def trainer(out_dir):
        cfg = get_default_cfg()
        cfg.merge_from_list(_resume_opts(out_dir))
        return Trainer(cfg, device="cpu")

    whole = trainer(tmp_path / "whole")
    whole.fit()
    first = trainer(tmp_path / "cut")
    train_epoch = first.train_epoch

    def stop_at_epoch_1(epoch, meters=None):
        if epoch == 1:
            raise _Stop
        train_epoch(epoch, meters)

    first.train_epoch = stop_at_epoch_1
    with pytest.raises(_Stop):
        first.fit()
    second = trainer(tmp_path / "cut")
    assert second.start_epoch == 1 and second.train_step.step == 8
    second.fit()
    assert whole.steps_run == {True: 16, False: 8}
    assert [r["random_shift"] for r in first.steps_log + second.steps_log] == \
        [r["random_shift"] for r in whole.steps_log]
    for key in ("step", "loss", "lr"):
        assert [r[key] for r in first.steps_log + second.steps_log] == \
            [r[key] for r in whole.steps_log], key
    assert [e["top1"] for e in second.evals] == [e["top1"] for e in whole.evals[1:]]
    assert [e["loss"] for e in second.evals] == [e["loss"] for e in whole.evals[1:]]
    assert second.best_acc == whole.best_acc


def test_cli_config_and_refusals(tmp_path):
    """The CLI's config handling (yaml, overrides, then --data, --output_dir
    and --seed) gives vil_tpu's run_experiment.py tree; --multi-host
    raises."""
    yaml = os.path.join(os.path.dirname(os.path.dirname(__file__)), "configs", "msvit.yaml")
    args = parse_args(["--config-file", yaml, "--data", "/d", "--output_dir", str(tmp_path),
                       "--seed", "3", "DATALOADER.BSZ", "64", "OPTIM.EPOCHS", "2"])
    cfg = config_from_args(args)
    ref = jax_default_cfg()
    ref.merge_from_file(yaml)
    ref.merge_from_list(["DATALOADER.BSZ", "64", "OPTIM.EPOCHS", "2"])
    ref.DATA.PATH, ref.OUTPUT_DIR, ref.TPU.SEED = "/d", str(tmp_path), 3
    assert cfg.to_dict() == ref.to_dict() and cfg.is_frozen()
    with pytest.raises(NotImplementedError, match="A12"):
        main(["--multi-host", "--config-file", yaml])
