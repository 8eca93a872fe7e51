"""The port's parameter sharding against ``vil_tpu`` on the CPU, in f32:
tensor parallelism over heads (TPU.PARAM_SHARDING 'tp' on a ('data', 'model')
mesh) and FSDP over the data axis ('fsdp').

* Without a spawn: the port's plan, leaf by leaf, against
  ``vil_tpu.parallel.tp_sharding`` (model axis 2) and ``fsdp_sharding``
  (data axis 2, ``min_size`` 2^14 and 0) on the same narrow model, through
  ``jax_import``'s names. The one difference is stated: a layer whose heads
  do not divide by the axis (stage 4, H 3) keeps its weights whole in the
  port, where ``vil_tpu`` cuts its channels through a head. Also the
  block-wise cut of the packed projections, and the draw of a tp shard's
  weights from the whole model's.
* The training step on spawned gloo groups
  (``tests/test_torch_sharding_worker.py``, one spawn per world size, a
  ``FileStore`` in a temporary directory, one CPU thread a rank), as
  (world, data, model): 'tp' (2, 1, 2) with RPE in every stage, (4, 2, 2)
  with APE at MODE 0 and with random shift (``vil_tpu``'s own draws of the
  modes, injected); 'fsdp' (2, 2, 1) and (4, 4, 1); and LAMB, whose trust
  ratio takes the norms of whole tensors, under 'tp' (2, 1, 2) and 'fsdp'
  (2, 2, 1) against the port's own unsharded LAMB step. The narrow
  model is ``vil_tpu``'s ``arch2`` of ``tests/test_distributed.py`` plus a
  dense stage with H 3, so that the model axis of 2 leaves that layer's
  attention whole and splits its MLP. Every rank's loss, every gradient and
  every updated parameter, gathered whole, against
  ``vil_tpu.train.engine.make_train_step``'s single-device step from the
  same weights (``load_jax_params`` into each rank's shard) on the global
  batch of 8: loss to 1e-5, each gradient to 1e-5 of its max|ref|, each
  updated parameter to 1e-5 where its gradient is at least 1e-4 of its
  max|ref| (the rule of ``tests/test_torch_spatial_train.py``). FSDP's
  ranks hold less than the replicated run's bytes of parameters and Adam
  moments.
* The Trainer (``run_experiment``) at world 2 as 'tp' (model axis 2) and as
  'fsdp' (data axis 2) against world 1 in this process: every logged loss
  to 1e-5, every top1 equal, one ``model_best.ckpt``; a run stopped when
  its second epoch starts and resumed equals the uninterrupted one; its last
  checkpoint, gathered whole, resumes a replicated Trainer in this process,
  whose weights equal the world-1 run's to 1e-5.
"""
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vil_tpu import parallel as jax_parallel
from vil_tpu.config import get_default_cfg as jax_default_cfg
from vil_tpu.models import build_model as jax_build_model
from vil_tpu.parallel import tensor as jax_tensor
from vil_tpu.train import engine as jax_engine
from vil_tpu.train import loss as jax_loss
from vil_tpu.train import optim as jax_optim

from vil_tpu_torch.config import get_default_cfg
from vil_tpu_torch.models import MsViT, build_model
from vil_tpu_torch.parallel import tensor
from vil_tpu_torch.train import engine, loss, optim
from vil_tpu_torch.train.trainer import Trainer, run_experiment
from vil_tpu_torch.utils import jax_import

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "test_torch_sharding_worker.py")
SPAWN_TIMEOUT = 240  # seconds, per world size
TOL = 1e-5
RESOLVED = 1e-4  # the updated entries compared: gradient ≥ this share of its max
# vil_tpu's arch2 (tests/test_distributed.py) and a dense stage of 3 heads
ARCH = ("l1,h2,d16,n1,s1,g1,p4,f2_l2,h2,d32,n1,s1,g1,p2,f2_l3,h2,d32,n1,s0,g0,p2,f2"
        "_l4,h3,d48,n1,s0,g0,p1,f2")
ARCH_RPE = "_".join(s + ",a0" for s in ARCH.split("_"))
IMG, BATCH = 32, 8


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One CPU thread for torch in this module, as each spawned rank has."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _opts(arch, opt="adamw"):
    return ["MODEL.VIT.MSVIT.ARCH", arch, "INPUT.IMAGE_SIZE", str(IMG),
            "DATA.NUM_CLASSES", "10", "TPU.COMPUTE_DTYPE", "float32",
            "MODEL.VIT.DROP_PATH", "0.0", "MODEL.VIT.NORM_EMBED", "True",
            "MODEL.VIT.MSVIT.SHARE_W", "True", "OPTIM.OPT", opt, "OPTIM.LR", "1e-3"]


def _port_step(opts, params, images, targets):
    """The port's unsharded step (no process group) from flax ``params`` on
    the whole batch: (loss, grads, updated params)."""
    cfg = get_default_cfg()
    cfg.merge_from_list(opts)
    model = jax_import.load_jax_params(build_model(cfg, device="cpu"), params)
    step = engine.make_train_step(model, loss.cross_entropy, optim.get_opt(cfg, model),
                                  device="cpu", seed=0)
    metrics = step(torch.from_numpy(images), torch.from_numpy(targets))
    return (metrics["loss"].item(), {n: p.grad.numpy() for n, p in model.named_parameters()},
            {n: p.detach().numpy() for n, p in model.named_parameters()})


def _mesh(data, model, sharding):
    if model > 1 or sharding == "tp":
        return ["TPU.MESH_AXES", "['data','model']", "TPU.MESH_SHAPE", f"[{data},{model}]",
                "TPU.PARAM_SHARDING", sharding]
    return ["TPU.MESH_AXES", "['data']", "TPU.MESH_SHAPE", f"[{data}]",
            "TPU.PARAM_SHARDING", sharding]


def _tree(t):
    """A flax tree as {port name: array}."""
    return {n: a for n, a in (jax_import._to_torch_leaf(k, np.asarray(v))
                              for k, v in jax_import._flatten(t))}


def _flat_flax(t, prefix=""):
    """A flax tree as {'a/b/c': array}, as the worker rebuilds it."""
    out = {}
    for k, v in t.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            out.update(_flat_flax(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _jax_params(opts, images, seed):
    """vil_tpu's model, config and flax parameters drawn from ``seed``
    (LayerNorm scales near 1)."""
    cfg = jax_default_cfg()
    cfg.merge_from_list(opts)
    model = jax_build_model(cfg, use_pallas=False)
    shapes = jax.eval_shape(lambda: model.init({"params": jax.random.PRNGKey(0)},
                                               jnp.asarray(images[:1])))["params"]
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map_with_path(
        lambda path, sds: (float(path[-1].key == "scale")
                           + 0.05 * rng.standard_normal(sds.shape)).astype(np.float32),
        shapes)
    return model, cfg, params


STEP_KEY = 0  # the step's key: jax.random.PRNGKey(STEP_KEY)


def _jax_modes(depth):
    """The modes vil_tpu's random-shift step draws at step 0 (the second
    key of split(fold_in(key, 0), 3))."""
    rng_mode = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(STEP_KEY), 0), 3)[1]
    return [int(m) for m in jax_engine.sample_vil_modes(rng_mode, depth)]


def _jax_step(model, cfg, params, images, targets, random_shift=False):
    """vil_tpu's single-device step on the whole batch: (loss, grads,
    updated params), the trees under the port's names."""
    tx = jax_optim.get_opt(cfg, params, lr=float(cfg.OPTIM.LR))
    state = jax_engine.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                                  opt_state=tx.init(params), buffers={})
    state, metrics = jax.jit(jax_engine.make_train_step(
        model, jax_loss.cross_entropy, tx, random_shift=random_shift))(
        state, jnp.asarray(images), jnp.asarray(targets), jax.random.PRNGKey(STEP_KEY))
    # the gradient the step took: Adam's first moment after one step from
    # zero is (1 - β₁)·g
    adam = next(s for s in jax.tree_util.tree_leaves(
        state.opt_state, is_leaf=lambda s: isinstance(s, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState))
    grads = jax.tree_util.tree_map(lambda m: m / (1 - cfg.OPTIM.ADAM.BETA1), adam.mu)
    return float(metrics["loss"]), _tree(grads), _tree(state.params)


# ------------------------------------------------------------ without a spawn

def _jax_shapes():
    cfg = jax_default_cfg()
    cfg.merge_from_list(_opts(ARCH))
    model = jax_build_model(cfg, use_pallas=False)
    return jax.eval_shape(lambda: model.init({"params": jax.random.PRNGKey(0)},
                                             jnp.zeros((1, IMG, IMG, 3))))["params"]


def _port_dims(spec_tree, shapes, axis):
    """vil_tpu's sharding tree as {port name: the port's dimension cut over
    ``axis``, or None}, through the flax layout of each leaf."""
    out = {}
    flat_specs = {"/".join(str(getattr(k, "key", k)) for k in path): s.spec
                  for path, s in jax.tree_util.tree_flatten_with_path(spec_tree)[0]}
    flat_shapes = {"/".join(str(getattr(k, "key", k)) for k in path): s.shape
                   for path, s in jax.tree_util.tree_flatten_with_path(shapes)[0]}
    for key, spec in flat_specs.items():
        name, _ = jax_import._to_torch_leaf(key.replace("/", "."),
                                            np.zeros(flat_shapes[key], np.int8))
        dims = [i for i, a in enumerate(spec) if a == axis]
        order = tensor._flax_order(name, len(flat_shapes[key]))
        out[name] = order[dims[0]] if dims else None
    return out


def test_tp_plan_matches_vil_tpu():
    """Model axis 2: the port's cut of each parameter against
    ``vil_tpu.parallel.tp_sharding``, leaf by leaf. They agree on every
    leaf but the attention of the H 3 layer, which the port keeps whole (a
    head would be cut) and ``vil_tpu`` cuts by channel; its MLP is split in
    both. Packed projections cut by block (pack 3 for qkv, 2 for kv)."""
    shapes = _jax_shapes()
    mesh = jax_parallel.create_mesh((4, 2), ("data", "model"))
    theirs = _port_dims(jax_tensor.tp_sharding(mesh, shapes), shapes, "model")
    model = MsViT(ARCH, img_size=IMG, num_classes=10, sharew=True, norm_embed=True,
                  device="cpu", tp=tensor.TensorParallel(None, 2, 0))
    ours = {n: None if s is None else s.dim for n, s in tensor.tp_plan(model).items()}
    assert set(ours) == set(theirs)
    differ = {n for n in ours if ours[n] != theirs[n]}
    assert differ == {"stage4_block0_attn.attn.qkv.weight", "stage4_block0_attn.attn.qkv.bias",
                      "stage4_block0_attn.attn.proj.weight"}, differ
    assert all(ours[n] is None for n in differ)
    assert ours["stage4_block0_mlp.mlp.fc1.weight"] == 0
    assert ours["stage4_block0_mlp.mlp.fc2.weight"] == 1
    packs = {n: s.pack for n, s in model.param_shards.items()}
    assert packs["stage3_block0_attn.attn.qkv.weight"] == 3
    assert packs["stage1_block0_attn.attn.kv.weight"] == 2
    assert packs["stage1_block0_attn.attn.query.weight"] == 1
    assert sum(d is not None for d in ours.values()) > 20


@pytest.mark.parametrize("min_size", [tensor.FSDP_MIN_SIZE, 0], ids=["2^14", "0"])
def test_fsdp_plan_matches_vil_tpu(min_size):
    """Data axis 2: the port's FSDP cut of each parameter against
    ``vil_tpu.parallel.fsdp_sharding``, leaf by leaf, the dimension included
    (the rule runs on each leaf's flax layout)."""
    shapes = _jax_shapes()
    mesh = jax_parallel.create_mesh((2, 4), ("data", "model"))
    theirs = _port_dims(jax_parallel.fsdp_sharding(mesh, shapes, min_size=min_size), shapes,
                        "data")
    model = MsViT(ARCH, img_size=IMG, num_classes=10, sharew=True, norm_embed=True,
                  device="cpu")
    ours = tensor.fsdp_plan(model, 2, min_size)
    assert ours == theirs
    assert any(d is not None for d in ours.values()) or min_size == tensor.FSDP_MIN_SIZE


def test_tp_shards_are_the_whole_models_draws():
    """Each model rank's shard of the weights drawn from one seed is its
    part of the replicated model's draw from that seed; the packed kv's
    part is its slice of k and of v."""
    whole = MsViT(ARCH, img_size=IMG, num_classes=10, sharew=True, device="cpu",
                  generator=torch.Generator().manual_seed(3))
    full = dict(whole.named_parameters())
    for rank in range(2):
        part = MsViT(ARCH, img_size=IMG, num_classes=10, sharew=True, device="cpu",
                     generator=torch.Generator().manual_seed(3),
                     tp=tensor.TensorParallel(None, 2, rank))
        for name, p in part.named_parameters():
            shard = part.param_shards.get(name)
            want = full[name] if shard is None else shard.local(full[name])
            torch.testing.assert_close(p, want, rtol=0, atol=0)
        kv = part.stage1_block0_attn.attn.kv.weight
        c = full["stage1_block0_attn.attn.kv.weight"].shape[0] // 2
        torch.testing.assert_close(kv[:c // 2], full["stage1_block0_attn.attn.kv.weight"][
            rank * c // 2:(rank + 1) * c // 2], rtol=0, atol=0)


# --------------------------------------------------- spawned process groups

def _launch(case_dir, world):
    """Start the worker on ``world`` ranks; returns the processes."""
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1")
    return [subprocess.Popen([sys.executable, WORKER, str(case_dir), str(r), str(world)],
                             env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                             text=True) for r in range(world)]


def _results(case_dir, procs):
    """Each rank's results, once its process has ended."""
    outs = [p.communicate(timeout=SPAWN_TIMEOUT)[0] for p in procs]
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and f"WORKER {r} DONE" in out, f"rank {r}:\n{out[-4000:]}"
    return [dict(np.load(case_dir / f"rank{r}.npz")) for r in range(len(procs))]


# (world, data, model, sharding, weights, random shift, optimizer)
STEP_CASES = {
    "tp_rpe": (2, 1, 2, "tp", "rpe", False, "adamw"),
    "fsdp_2": (2, 2, 1, "fsdp", "ape", False, "adamw"),
    "tp_lamb": (2, 1, 2, "tp", "ape", False, "lamb"),
    "fsdp_lamb": (2, 2, 1, "fsdp", "ape", False, "lamb"),
    "tp_ape": (4, 2, 2, "tp", "ape", False, "adamw"),
    "tp_shift": (4, 2, 2, "tp", "ape", True, "adamw"),
    "fsdp_4": (4, 4, 1, "fsdp", "ape", False, "adamw"),
}

# the Trainer's runs: a 48² image, no draws in the pipeline; stage 1's one
# head stays whole under 'tp', stage 3's MLP (64 → 256) is at FSDP's 2^14
TRAINER_OPTS = [
    "MODEL.VIT.MSVIT.ARCH", "l1,h1,d16,n1,s1,g1,p4,f2_l2,h2,d32,n1,s1,g1,p2,f2_l3,h2,d64,n1,s0,g0,"
    "p2,f2", "INPUT.IMAGE_SIZE", "48", "DATA.NUM_CLASSES", "10", "DATALOADER.BSZ", "8",
    "DATALOADER.WORKERS", "0", "DATA.TRAIN", "('synthetic',)", "DATA.TEST", "('synthetic',)",
    "TPU.COMPUTE_DTYPE", "float32", "MODEL.VIT.DROP_PATH", "0.0", "OPTIM.LR", "1e-3",
    "OPTIM.EPOCHS", "2", "SOLVER.LR_POLICY", "cosine", "SOLVER.WARMUP_EPOCHS", "1.0",
    "LOG_FREQ", "1", "AUG.TIMM_AUG.USE_TRANSFORM", "True", "AUG.TIMM_AUG.HFLIP", "0.0",
    "AUG.TIMM_AUG.VFLIP", "0.0", "AUG.TIMM_AUG.AUTO_AUGMENT", "", "AUG.TIMM_AUG.RE_PROB",
    "0.0", "AUG.SCALE", "(1.0, 1.0)", "AUG.RATIO", "(1.0, 1.0)"]
TRAINER_RUNS = {"tp": _mesh(1, 2, "tp"), "fsdp": _mesh(2, 1, "fsdp")}

# a narrow ResNet of the zoo on a data axis of 2: its BatchNorms take the
# global batch's statistics, as vil_tpu's jitted step on the sharded batch
RESNET = dict(name="resnet50", layers=[1, 1, 1, 1], state="resnet.npz",
              opts=["DATA.NUM_CLASSES", "10", "TPU.COMPUTE_DTYPE", "float32", "OPTIM.OPT",
                    "adamw", "OPTIM.LR", "1e-2"] + _mesh(2, 1, "replicated"))


def _resnet(group_size=1):
    from vil_tpu_torch.models import build_resnet

    return build_resnet(RESNET["name"], 10, device="cpu", layers=tuple(RESNET["layers"]),
                        generator=torch.Generator().manual_seed(3), group_size=group_size)


@pytest.fixture(scope="module")
def sharded_runs(tmp_path_factory):
    """The global batch and each case's weights (vil_tpu's parameters drawn
    from a seed); both spawns started at once, one per world size, every
    case of that size in it and at world 2 the Trainer's runs; while they
    run, what each case is held to: vil_tpu's single-device step (APE at
    MODE 0 and with random shift, RPE), and the Trainer's experiment at
    world 1. Yields (refs, {world: (directory, processes)})."""
    inputs = tmp_path_factory.mktemp("sharding_inputs")
    rng = np.random.default_rng(0)
    images = rng.standard_normal((BATCH, IMG, IMG, 3)).astype(np.float32)
    targets = rng.integers(0, 10, BATCH).astype(np.int64)
    np.savez(inputs / "inputs.npz", images=images, targets=targets)
    rng_bn = np.random.default_rng(5)  # running statistics other than the init's
    np.savez(inputs / "resnet.npz", **{
        k: (v.numpy() if "running" not in k else
            rng_bn.uniform(0.5, 1.5, v.shape).astype(np.float32))
        for k, v in _resnet().state_dict().items()})
    jax_side = {w: _jax_params(_opts(a), images, seed) for w, a, seed in (
        ("ape", ARCH, 1), ("rpe", ARCH_RPE, 2))}
    for weights, (_, _, params) in jax_side.items():
        np.savez(inputs / f"{weights}.npz", **_flat_flax(params))
    modes = _jax_modes(jax_side["ape"][0].depth)
    spawns = {}
    try:
        for world in (2, 4):
            out = tmp_path_factory.mktemp(f"sharding_world{world}")
            for name in ("inputs.npz", "ape.npz", "rpe.npz", "resnet.npz"):
                os.symlink(inputs / name, out / name)
            steps = {case: dict(opts=_opts(ARCH_RPE if weights == "rpe" else ARCH, opt)
                                + _mesh(data, model, sharding), params=f"{weights}.npz",
                                modes=modes if shift else None, min_size=0)
                     for case, (w, data, model, sharding, weights, shift, opt)
                     in STEP_CASES.items() if w == world}
            trainers = {n: dict(opts=TRAINER_OPTS + o, resume=True)
                        for n, o in TRAINER_RUNS.items()} if world == 2 else {}
            with open(out / "spec.json", "w") as f:
                json.dump({"steps": steps, "trainers": trainers,
                           "resnet": RESNET if world == 2 else {}}, f)
            spawns[world] = out, _launch(out, world)
        refs = {w: _jax_step(*jax_side[w], images, targets) for w in jax_side}
        refs["shift"] = _jax_step(*jax_side["ape"], images, targets, random_shift=True)
        # LAMB's trust ratio takes whole norms: the port's own unsharded step
        refs["lamb"] = _port_step(_opts(ARCH, "lamb"), jax_side["ape"][2], images, targets)
        # the Trainer's experiment at world 1, in this process
        cfg = get_default_cfg()
        out1 = tmp_path_factory.mktemp("sharding_world1")
        cfg.merge_from_list(TRAINER_OPTS + ["OUTPUT_DIR", str(out1)])
        refs["world1"] = run_experiment(cfg, device="cpu"), out1
        refs["inputs"] = inputs
        yield refs, spawns
    finally:
        for _, procs in spawns.values():
            for p in procs:
                p.kill()


@pytest.fixture(scope="module")
def spawned(sharded_runs):
    """``run(world)`` → (its directory, each rank's results)."""
    done = {}

    def run(world):
        if world not in done:
            out, procs = sharded_runs[1][world]
            done[world] = out, _results(out, procs)
        return done[world]

    return run


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_sharded_step_matches_vil_tpu(sharded_runs, spawned, case):
    world, data, model, sharding, weights, shift, opt = STEP_CASES[case]
    ref = "lamb" if opt == "lamb" else "shift" if shift else weights
    ref_loss, ref_grads, ref_params = sharded_runs[0][ref]
    results = spawned(world)[1]
    for r, res in enumerate(results):  # the mesh's coordinates of each rank
        assert list(res[f"{case}/coords"]) == list(divmod(r, model)), (case, r)
        at = f"{case}, rank {r} of ({world}, {data}, {model})"
        assert abs(float(res[f"{case}/loss"]) - ref_loss) <= TOL, at
        assert {k.split("/", 2)[2] for k in res if k.startswith(f"{case}/grad/")} == \
            set(ref_grads), at
        for name, ref in ref_grads.items():
            err = np.abs(res[f"{case}/grad/{name}"] - ref).max(initial=0.0)
            assert err <= TOL * np.abs(ref).max(initial=0.0), f"{at}: grad {name} {err:.3e}"
            keep = np.abs(ref) >= RESOLVED * np.abs(ref).max(initial=0.0)
            err = np.abs(res[f"{case}/param/{name}"] - ref_params[name])[keep].max(initial=0.0)
            assert err <= TOL, f"{at}: updated {name} {err:.3e}"
        sharded = set(res[f"{case}/sharded"])
        if sharding == "tp":  # the split layers' weights, the H 3 attention whole
            assert "stage3_block0_attn.attn.qkv.weight" in sharded, at
            assert "stage4_block0_attn.attn.qkv.weight" not in sharded, at
            assert "stage4_block0_mlp.mlp.fc1.weight" in sharded, at
        else:  # sliced over the data axis: less held than the whole
            whole = sum(v.nbytes for k, v in res.items() if k.startswith(f"{case}/param/"))
            params, moments = res[f"{case}/bytes"]
            assert params < whole and moments < 2 * whole, (at, params, moments, whole)


@pytest.mark.parametrize("name", list(TRAINER_RUNS))
def test_trainer_at_world_2_matches_world_1(sharded_runs, spawned, name):
    trainer, out1 = sharded_runs[0]["world1"]
    out, results = spawned(2)
    losses = [r["loss"] for r in trainer.steps_log]
    top1 = [e["top1"] for e in trainer.evals]
    assert len(losses) == 16 and trainer.best_evaluated
    for r, res in enumerate(results):
        np.testing.assert_allclose(res[f"{name}/losses"], losses, rtol=0, atol=TOL,
                                   err_msg=f"{name}, rank {r}")
        assert bool(res[f"{name}/best_evaluated"]) and set(res[f"{name}/images"]) == {64}
        assert list(res[f"{name}/top1"]) == top1, (name, r)
        assert len(res[f"{name}/sharded"]) > 0, (name, r)
        # stopped at epoch 1 and resumed: the uninterrupted run
        assert list(res[f"{name}/resumed_start"]) == [1, 8]
        np.testing.assert_allclose(res[f"{name}/resumed_losses"], res[f"{name}/losses"],
                                   rtol=0, atol=TOL)
        assert list(res[f"{name}/resumed_top1"]) == list(res[f"{name}/top1"][1:])
    files = sorted(os.listdir(out / f"run_{name}"))
    assert files.count("model_best.ckpt") == 1 and files.count("config.yaml") == 1
    # the sharded run's checkpoint, whole, resumes a replicated Trainer
    cfg = get_default_cfg()
    cfg.merge_from_list(TRAINER_OPTS + ["OUTPUT_DIR", str(out / f"run_{name}")])
    replicated = Trainer(cfg, device="cpu")
    assert replicated.start_epoch == 2 and replicated.train_step.step == 16
    assert not replicated.model.param_shards
    ref = torch.load(out1 / "checkpoint_2.ckpt", weights_only=True)["model"]
    for k, v in replicated.model.state_dict().items():
        torch.testing.assert_close(v, ref[k], rtol=0, atol=TOL, msg=f"{name}: {k}")


def test_resnet_data_axis_step_matches_one_process(sharded_runs, spawned):
    """A narrow ResNet-50 over two gloo ranks on the data axis, each on half
    the batch, against one process's step on the whole batch: the loss,
    every gradient, the updated parameters (their resolved entries, as
    test_sharded_step_matches_vil_tpu's) and the running statistics to 1e-5
    (the BatchNorms' sums all-reduced forward and backward)."""
    inputs = sharded_runs[0]["inputs"]
    inp = np.load(inputs / "inputs.npz")
    cfg = get_default_cfg()
    cfg.merge_from_list(RESNET["opts"][:8])
    model = _resnet()
    model.load_state_dict({k: torch.from_numpy(v)
                           for k, v in np.load(inputs / "resnet.npz").items()})
    step = engine.make_train_step(model, loss.cross_entropy, optim.get_opt(cfg, model),
                                  device="cpu", seed=0)
    ref_loss = step(torch.from_numpy(inp["images"]), torch.from_numpy(inp["targets"]))["loss"]
    _, results = spawned(2)
    for r, res in enumerate(results):
        assert abs(float(res["resnet/loss"]) - ref_loss.item()) <= TOL, r
        for name, p in model.named_parameters():
            g = p.grad.numpy()
            err = np.abs(res[f"resnet/grad/{name}"] - g).max()
            assert err <= TOL * max(1.0, np.abs(g).max()), (r, "grad", name, err)
            keep = np.abs(g) >= RESOLVED * np.abs(g).max(initial=0.0)
            err = np.abs(res[f"resnet/param/{name}"] - p.detach().numpy())[keep].max(initial=0.0)
            assert err <= TOL, (r, "updated", name, err)
        for name, b in model.named_buffers():
            err = np.abs(res[f"resnet/buffer/{name}"] - b.numpy()).max()
            assert err <= TOL * max(1.0, b.abs().max().item()), (r, name, err)
