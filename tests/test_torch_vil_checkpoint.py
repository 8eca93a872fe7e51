"""Checkpoints that ``vil_tpu`` wrote, read by the port, on the CPU in f32
(unless stated) at a narrow MsViT (the verify recipe's arch, 64², 10
classes, batch 4):

* ``vil_tpu``'s own ``Checkpointer`` (msgpack backend) writes the state
  after two of ``vil_tpu``'s train steps; the port's ``Checkpointer`` loads
  it: every parameter exactly, the logits to 1e-5;
* for each OPTIM.OPT (sgd, adam, adamw, qhm, lamb; WD0 > 0, so ``with_wd0``'s
  element is in the chain; a warmup-cosine schedule, so its count is too):
  one more step in both packages from the loaded state, every parameter to
  1e-5 of its max|ref|; sgd again after a plateau drop (``lr_scale`` 0.1);
* the performer's projections, and bf16 parameters bit for bit;
* the Trainer's resume of ``vil_tpu``'s OUTPUT_DIR at its epoch, best_acc,
  step and lr_scale, and EVALUATE from MODEL.MODEL_PATH;
* what still raises: TPU.FLAT_OPT (A13) and an orbax directory (OCDBT,
  A6), each naming its item; another arch in the header (``ValueError``);
  a ``batch_stats`` collection whose leaves the ViL has no buffer for
  (``KeyError``, unused JAX leaves: a ResNet's loads into a ResNet,
  ``tests/test_torch_resnet.py``).

One ``vil_tpu`` model is built, its state drawn from a seed over
``jax.eval_shape``'s tree of its init, and its gradient (with the logits)
jitted once; each optimizer's update is jitted once and shared by the
cases.
"""
import zlib

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
from vil_tpu.train import schedulers as jax_schedulers
from vil_tpu.train.trainer import drop_lr as jax_drop_lr
from vil_tpu.train.trainer import lr_scalable
from vil_tpu.utils.checkpoint import Checkpointer as JaxCheckpointer

from vil_tpu_torch.config import get_default_cfg
from vil_tpu_torch.models import build_model
from vil_tpu_torch.train import engine, loss, optim, schedulers
from vil_tpu_torch.train.trainer import Trainer
from vil_tpu_torch.utils import jax_import
from vil_tpu_torch.utils.checkpoint import Checkpointer

ARCH = "l1,h1,d32,n1,s1,g1,p4,f4_l2,h2,d64,n1,s1,g1,p2,f4_l3,h2,d64,n1,s0,g0,p2,f4"
IMG, BATCH = 64, 4
RNG = np.random.default_rng(0)
IMAGES = RNG.standard_normal((3, BATCH, IMG, IMG, 3)).astype(np.float32)
LABELS = RNG.integers(0, 10, (3, BATCH)).astype(np.int32)


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
    return ["MODEL.VIT.MSVIT.ARCH", ARCH, "INPUT.IMAGE_SIZE", str(IMG), "DATA.NUM_CLASSES",
            "10", "DATALOADER.BSZ", str(BATCH), "DATALOADER.WORKERS", "0",
            "DATA.TRAIN", "('synthetic',)", "DATA.TEST", "('synthetic',)",
            "TPU.COMPUTE_DTYPE", "float32", "TPU.USE_PALLAS", "False",
            "MODEL.VIT.DROP_PATH", "0.0", "OPTIM.LR", "1e-3", "OPTIM.WD", "0.05",
            "OPTIM.WD0", "0.01", "OPTIM.EPOCHS", "2", "SOLVER.LR_POLICY", "cosine",
            "SOLVER.WARMUP_EPOCHS", "1.0", "SOLVER.STEPS_PER_EPOCH", "8",
            "SOLVER.MAX_ITER", "16", "OUTPUT_DIR", str(out_dir), *extra]


def _cfg(out_dir, *extra, jax_side=False):
    cfg = (jax_default_cfg if jax_side else get_default_cfg)()
    cfg.merge_from_list(_opts(out_dir, *extra))
    return cfg


def _torch_tree(tree) -> dict:
    """A flax-shaped tree under the port's names and layouts."""
    return {name: arr for name, arr in (jax_import._to_torch_leaf(n, np.asarray(a, np.float32))
                                        for n, a in jax_import._flatten(tree))}


_MODELS, _RUNS = {}, {}


def _draw(path, leaf):
    """A seeded value for one leaf of vil_tpu's variables at the scale of its
    init (``trunc_normal`` 0.02): LayerNorm scales about 1, the rest 0.02 of a
    normal draw. At that scale the gradient of the keys' bias, zero but for
    rounding, stays far below Adam's eps, as it does from ``model.init``."""
    rng = np.random.default_rng(zlib.crc32(jax.tree_util.keystr(path).encode()))
    noise = rng.standard_normal(leaf.shape)
    value = 1.0 + 0.1 * noise if path[-1].key == "scale" else 0.02 * noise
    return jnp.asarray(value, leaf.dtype)


def _jax_model(attn="longformerhand"):
    """vil_tpu's model and a state of it (no optimizer), built once: the
    variables' tree of ``model.init`` by ``jax.eval_shape`` (a trace, where a
    jitted init compiles the forward), its values drawn by ``_draw``."""
    key = attn
    if key not in _MODELS:
        jcfg = _cfg("", "MODEL.VIT.MSVIT.ATTN_TYPE", attn, jax_side=True)
        model = jax_build_model(jcfg, use_pallas=False)
        sample = jnp.zeros((1, IMG, IMG, 3), jnp.float32)
        shapes = jax.eval_shape(lambda rng: model.init({"params": rng}, sample),
                                jax.random.PRNGKey(0))
        variables = dict(jax.tree_util.tree_map_with_path(_draw, shapes))
        params = variables.pop("params")
        _MODELS[key] = model, jax_engine.TrainState(
            step=jnp.zeros((), jnp.int32), params=params, opt_state=optax.identity().init(params),
            buffers=variables)
    return _MODELS[key]


def _jax_grad():
    """The gradient of vil_tpu's loss at mode 0 (``engine.make_train_step``'s
    ``loss_fn`` without mixup, drop path 0) and the logits, jitted once for
    every optimizer and for the eval's logits (at drop path and dropout 0 the
    mode-0 training forward is the eval's function)."""
    if "grad" not in _MODELS:
        model, _ = _jax_model()

        def loss_fn(params, images, labels):
            logits = model.apply({"params": params}, images, deterministic=False, mode=0,
                                 rngs={"dropout": jax.random.PRNGKey(0)})
            return jax_loss.cross_entropy(logits.astype(jnp.float32), labels), logits

        _MODELS["grad"] = jax.jit(jax.grad(loss_fn, has_aux=True))
    return _MODELS["grad"]


def _jax_run(opt: str):
    """vil_tpu's trainer optimizer for ``opt`` (``lr_scalable`` around
    ``get_opt`` with the schedule), its train step and the state after two
    steps. The step is ``engine.make_train_step``'s body (gradient, the
    optimizer's update, ``p + u``, the step count) from the shared jitted
    gradient and the optimizer's jitted update: one compile of the model
    for the five optimizers."""
    if opt not in _RUNS:
        jcfg = _cfg("", "OPTIM.OPT", opt, jax_side=True)
        _, init = _jax_model()
        tx = lr_scalable(jax_optim.get_opt(jcfg, init.params,
                                           lr=jax_schedulers.get_lr_schedule(jcfg)))
        grad, update = _jax_grad(), jax.jit(tx.update)

        def step(state, i):
            grads, _ = grad(state.params, jnp.asarray(IMAGES[i]), jnp.asarray(LABELS[i]))
            updates, opt_state = update(grads, state.opt_state, state.params)
            params = jax.tree_util.tree_map(lambda p, u: p + u, state.params, updates)
            return state.replace(step=state.step + 1, params=params, opt_state=opt_state)

        state = init.replace(opt_state=tx.init(init.params))
        for i in range(2):
            state = step(state, i)
        _RUNS[opt] = step, state
    return _RUNS[opt]


def _port(tmp_path, *extra, seed=5):
    """The port's model (weights other than vil_tpu's) and optimizer."""
    cfg = _cfg(tmp_path, *extra)
    model = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(seed))
    return cfg, model, optim.get_opt(cfg, model)


def _assert_params_close(model, params, rel):
    ref = _torch_tree(params)
    for name, p in model.named_parameters():
        scale = np.abs(ref[name]).max(initial=1e-30)
        err = np.abs(p.detach().float().numpy() - ref[name]).max(initial=0.0)
        assert err <= rel * scale, (name, err, scale)


def test_params_and_logits_match(tmp_path):
    """EVALUATE's load (no resume): the parameters exactly, the eval logits
    to 1e-5 of vil_tpu's forward; no optimizer state is taken; the Trainer
    under EVALUATE loads the file from MODEL.MODEL_PATH."""
    _, state = _jax_run("adamw")
    path = JaxCheckpointer(str(tmp_path / "jax"), arch=ARCH).save(2, state, best_acc=12.5)
    cfg, model, optimizer = _port(tmp_path, "OPTIM.OPT", "adamw")
    header = Checkpointer("", arch=ARCH, is_test=True).load(model, optimizer, path, resume=False)
    assert header == dict(arch=ARCH, epoch=2, best_acc=12.5) and not optimizer.state
    _assert_params_close(model, state.params, 0.0)
    _, want = _jax_grad()(state.params, jnp.asarray(IMAGES[0]), jnp.asarray(LABELS[0]))
    with torch.inference_mode():
        got = model.eval()(torch.from_numpy(IMAGES[0])).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)

    evaluator = Trainer(_cfg(tmp_path / "eval", "OPTIM.OPT", "adamw", "EVALUATE", "True",
                             "MODEL.MODEL_PATH", path), device="cpu")
    for (n, a), b in zip(evaluator.model.state_dict().items(), model.state_dict().values()):
        assert torch.equal(a, b), n


@pytest.mark.parametrize("opt", ["sgd", "adam", "adamw", "qhm", "lamb"])
def test_resumed_step_matches_vil_tpu(opt, tmp_path):
    """The moments, the step and lr_scale of each optimizer: one more step of
    the port from the loaded state against vil_tpu's third step."""
    jstep, state = _jax_run(opt)
    JaxCheckpointer(str(tmp_path), arch=ARCH).save(1, state, best_acc=3.0)
    _check_resumed_step(tmp_path, opt, jstep(state, 2).params, lr_scale=1.0)


def test_resume_after_a_plateau_drop(tmp_path):
    """sgd after ``drop_lr`` by 10: the port's step runs at lr_scale 0.1."""
    jstep, state = _jax_run("sgd")
    state = jax_drop_lr(state, 10.0)
    JaxCheckpointer(str(tmp_path), arch=ARCH).save(1, state, best_acc=3.0)
    _check_resumed_step(tmp_path, "sgd", jstep(state, 2).params, lr_scale=np.float32(0.1))


def _check_resumed_step(tmp_path, opt, want, lr_scale):
    cfg, model, optimizer = _port(tmp_path, "OPTIM.OPT", opt)
    header = Checkpointer(str(tmp_path), arch=ARCH).load(model, optimizer)  # by the tag
    assert header == dict(arch=ARCH, epoch=1, best_acc=3.0, step=2, lr_scale=float(lr_scale))
    assert len(optimizer.state) == len(list(model.parameters()))
    step = engine.make_train_step(model, loss.cross_entropy, optimizer,
                                  schedulers.get_lr_schedule(cfg), device="cpu", seed=0,
                                  start_step=header["step"], lr_scale=header["lr_scale"])
    step(torch.from_numpy(IMAGES[2]), torch.from_numpy(LABELS[2]).long())
    _assert_params_close(model, want, 1e-5)


def test_performer_buffers(tmp_path):
    """The performer's ``buffers`` collection fills the port's buffers; the
    logits to 1e-5."""
    jax_model, state = _jax_model("performer")
    path = JaxCheckpointer(str(tmp_path), arch=ARCH).save(1, state)
    _, model, optimizer = _port(tmp_path, "MODEL.VIT.MSVIT.ATTN_TYPE", "performer")
    Checkpointer("", arch=ARCH).load(model, optimizer, path, resume=False)
    ref = _torch_tree(state.buffers["buffers"])
    assert sorted(ref) == sorted(n for n, _ in model.named_buffers())
    for name, b in model.named_buffers():
        assert np.array_equal(b.numpy(), ref[name]), name
    want = np.asarray(jax.jit(jax_model.apply)(state.variables(), jnp.asarray(IMAGES[0])))
    with torch.inference_mode():
        got = model.eval()(torch.from_numpy(IMAGES[0])).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_bf16_params_bit_for_bit(tmp_path):
    """TPU.PARAM_DTYPE bfloat16, vil_tpu's state in bf16 (here the f32
    initial state rounded): flax writes dtype 'bfloat16'; the port's bf16
    parameters take the same bits."""
    _, state = _jax_model()
    state = state.replace(params=jax.tree_util.tree_map(
        lambda a: np.asarray(a).astype(jnp.bfloat16), state.params))
    path = JaxCheckpointer(str(tmp_path), arch=ARCH).save(1, state)
    _, model, optimizer = _port(tmp_path, "TPU.PARAM_DTYPE", "bfloat16")
    Checkpointer("", arch=ARCH).load(model, optimizer, path, resume=False)
    ref = _torch_tree(state.params)  # widened exactly to f32, as the port's are below
    for name, p in model.named_parameters():
        assert p.dtype == torch.bfloat16
        assert np.array_equal(p.detach().float().numpy().view(np.uint32),
                              ref[name].view(np.uint32)), name


def test_trainer_resumes_a_vil_tpu_output_dir(tmp_path):
    """The Trainer takes vil_tpu's ``last_checkpoint``: start epoch, best
    accuracy, step and lr_scale as from the port's own directory."""
    _, state = _jax_run("qhm")
    state = jax_drop_lr(state, 10.0)
    out = tmp_path / "run"
    ck = JaxCheckpointer(str(out), arch=ARCH)
    ck.save(1, state, best_acc=37.5, is_best=True)
    assert (out / "last_checkpoint").read_text() == "checkpoint_1.ckpt"
    trainer = Trainer(_cfg(out, "OPTIM.OPT", "qhm"), device="cpu")
    assert (trainer.start_epoch, trainer.best_acc) == (1, 37.5)
    assert trainer.train_step.step == 2
    assert trainer.train_step.lr_scale == pytest.approx(0.1, rel=1e-7)
    _assert_params_close(trainer.model, state.params, 0.0)
    ref = _torch_tree(state.opt_state["inner"][0].h)
    for name, p in trainer.model.named_parameters():
        assert np.array_equal(trainer.optimizer.state[p]["h"].numpy(), ref[name]), name
    # model_best, the copy the run's final eval reads
    _, model, optimizer = _port(tmp_path, "OPTIM.OPT", "qhm")
    header = Checkpointer("", arch=ARCH, is_test=True).load(
        model, optimizer, str(out / "model_best.ckpt"), resume=False)
    assert header["best_acc"] == 37.5
    _assert_params_close(model, state.params, 0.0)


def test_what_still_raises(tmp_path):
    _, state = _jax_run("adamw")
    _, model, optimizer = _port(tmp_path, "OPTIM.OPT", "adamw")
    # another arch in the header
    path = JaxCheckpointer(str(tmp_path / "a"), arch=ARCH.replace("d64", "d48")).save(1, state)
    with pytest.raises(ValueError, match="arch"):
        Checkpointer("", arch=ARCH).load(model, optimizer, path)
    # a state written under TPU.FLAT_OPT: moments by dtype group (A13)
    jcfg = _cfg("", "OPTIM.OPT", "adamw", "TPU.FLAT_OPT", "True", jax_side=True)
    tx = lr_scalable(jax_optim.get_opt(jcfg, state.params))
    flat = state.replace(opt_state=tx.init(state.params))
    path = JaxCheckpointer(str(tmp_path / "f"), arch=ARCH).save(1, flat)
    with pytest.raises(NotImplementedError, match="FLAT_OPT.*A13"):
        Checkpointer("", arch=ARCH).load(model, optimizer, path)
    # a batch_stats collection (a ResNet's, tests/test_torch_resnet.py) whose
    # leaves the ViL has no buffer for
    bn = state.replace(buffers={"batch_stats": {"bn1": {"mean": jnp.zeros(4)}}})
    path = JaxCheckpointer(str(tmp_path / "r"), arch=ARCH).save(1, bn)
    with pytest.raises(KeyError, match="unused JAX leaves.*bn1"):
        Checkpointer("", arch=ARCH).load(model, optimizer, path, resume=False)
    # an orbax directory: OCDBT, which needs tensorstore (A6)
    orbax = tmp_path / "o" / "checkpoint_1.orbax"
    (orbax / "ocdbt.process_0" / "d").mkdir(parents=True)
    (orbax / "manifest.ocdbt").write_bytes(b"")
    (tmp_path / "o" / "last_checkpoint").write_text("checkpoint_1.orbax")
    with pytest.raises(NotImplementedError, match="OCDBT.*tensorstore.*A6"):
        Checkpointer(str(tmp_path / "o"), arch=ARCH).load(model, optimizer)
