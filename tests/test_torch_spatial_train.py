"""The port's training over a ('data', 'spatial') mesh against ``vil_tpu``
on the CPU, in f32.

* The split rule, without a process group: the chunk-aligned ragged splits
  of ViL-Small 1024² over 2 and 4 ranks and of ViL-Medium-Deep 384² over 4,
  the even splits of ViL-Small 224², and a split that would leave a rank no
  row, which raises ``ValueError`` naming the stage.
* The training step on spawned gloo groups
  (``tests/test_torch_spatial_train_worker.py``, one spawn per (world,
  spatial) case for the step and the Trainer, a ``FileStore`` in a
  temporary directory, one CPU thread a rank):
  (1, 1), (2, 2), (4, 4), (4, 2) and (2, 1) on a narrow model whose chunk
  rows neither 2 nor 4 divide (104², W 3: 9 and 5 chunk rows with pad, split
  3/2 and 2/1/1/1 blocks of 24 rows), with APE, and at (4, 2) also with RPE
  in every stage, drop path 0, no mixup. Every rank's loss, every parameter gradient and
  every updated parameter against ``vil_tpu.train.engine.make_train_step``'s
  single-device step from the same weights on the global batch of 8: loss
  to 1e-5, each gradient to 1e-5 of its max|ref|, each updated parameter to
  1e-5 where its gradient is at least 1e-4 of its max|ref| (below, as in the
  key biases, whose exact gradient is 0, Adam's first update normalises a
  gradient near its ε and follows its rounding: those entries are held by
  their gradient alone). At (2, 2) and (4, 2) also a step with drop path
  0.5, its draws keyed by the step and the data replica: against the
  port's unsplit step of each data replica on its images (at (4, 2) the
  two replicas' mean), every replica's draws dropping some sample. At
  (2, 2) and (4, 2) also a random-shift step, its per-block modes drawn by
  the step from the seed (keyed by (seed, step): the same on every rank,
  [8, 1, 2] at seed 0, whose chunked blocks read the halo rows below and
  above), and a step at mode −1 (the self chunk alone, no halo): loss and
  every gradient against ``jax.value_and_grad`` of ``vil_tpu``'s model at
  the same modes, to 1e-5 of max|ref|; and at (2, 2) a step with unshared
  global weights (SHARE_W False) against ``vil_tpu``'s step of the
  unshared model, as the APE case.
* The Trainer (``run_experiment``) at world 2, as spatial 2 (a 3-block
  image split 2/1) and as data 2, on the synthetic set with a draw-free
  pipeline, at MODEL.VIT.MSVIT.MODE 1 switched off at half of the 2 epochs
  (random shift, then MODE 0), against the same config at world 1 in this
  process: every logged loss to 1e-5, every eval's top1 equal (each image
  counted once), one ``model_best.ckpt`` and one ``config.yaml``; at
  spatial 2 a run stopped when its second epoch starts and resumed by a new
  Trainer equals the uninterrupted one.
* Without a spawn: the port's ``accumulate_predictions`` against
  ``vil_tpu``'s on the same dicts, padded repeats included; each data
  replica's sampler shard; ``check_ported`` taking a model axis or FSDP
  beside a spatial axis and refusing 'tp' without a model axis, and
  ``init_process_group`` more NCCL ranks than cards; the Trainer on a 1 × 1
  mesh without a process group, random shift then MODE 0, against the same
  run without the mesh and as on a ('data', 'model', 'spatial') mesh of
  one rank, and a fused block under the split still raising.
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

from vil_tpu.config import get_default_cfg as jax_default_cfg
from vil_tpu.models import build_model as jax_build_model
from vil_tpu.parallel import collectives as jax_collectives
from vil_tpu.train import engine as jax_engine
from vil_tpu.train import loss as jax_loss
from vil_tpu.train import optim as jax_optim

from vil_tpu_torch import parallel
from vil_tpu_torch.config import get_default_cfg
from vil_tpu_torch.data import loader
from vil_tpu_torch.models import ARCH_ZOO, MsViT, build_model
from vil_tpu_torch.models.arch import parse_arch
from vil_tpu_torch.models.layers import DropPath
from vil_tpu_torch.parallel import collectives
from vil_tpu_torch.train import engine, loss, optim
from vil_tpu_torch.train.trainer import Trainer, check_ported, run_experiment
from vil_tpu_torch.utils import jax_import

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "test_torch_spatial_train_worker.py")
SPAWN_TIMEOUT = 240  # seconds, per case
TOL = 1e-5
RESOLVED = 1e-4  # the updated entries compared: gradient ≥ this share of its max
DROP_PATH = 0.5  # the draws' case: rates 0, 0.25, 0.5 over the three blocks
# 104²: stage 1 26 token rows in 9 chunk rows of 3 (pad 1), stage 2 13 in 5
# (pad 2), then a dense 6x6 stage; blocks of 24 input rows, 5 of them
ARCH = "l1,h2,d16,n1,s1,g1,p4,f3_l2,h2,d32,n1,s1,g1,p2,f3_l3,h2,d32,n1,s0,g1,p2,f3"
ARCH_RPE = "l1,h2,d16,n1,s1,g1,p4,f3,a0_l2,h2,d32,n1,s1,g1,p2,f3,a0_l3,h2,d32,n1,s0,g1,p2,f3,a0"
IMG, BATCH = 104, 8
SHIFT_SEED = 0  # the worker's step seed: its first draw of modes is [8, 1, 2]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One CPU thread for torch in this module, as each spawned rank has: the
    models are narrow, and the test runner's workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _opts(arch, drop_path=0.0, sharew=True):
    return ["MODEL.VIT.MSVIT.ARCH", arch, "INPUT.IMAGE_SIZE", str(IMG),
            "DATA.NUM_CLASSES", "10", "TPU.COMPUTE_DTYPE", "float32",
            "MODEL.VIT.DROP_PATH", str(drop_path), "MODEL.VIT.NORM_EMBED", "True",
            "MODEL.VIT.MSVIT.SHARE_W", str(sharew), "OPTIM.OPT", "adamw", "OPTIM.LR", "1e-3"]


# ------------------------------------------------------------ the split rule

def _split(name_or_arch, img, size):
    cfgs = parse_arch(ARCH_ZOO.get(name_or_arch, name_or_arch))
    n = next(i for i, c in enumerate(cfgs) if not c.is_sparse_attn)
    return parallel.row_split(img, [c.patch_size for c in cfgs[:n]],
                              [c.num_feats for c in cfgs[:n]], size)


@pytest.mark.parametrize("name,img,size,rows,chunks", [
    ("vil_small", 1024, 2, [560, 464], [[20, 17], [10, 9]]),
    ("vil_small", 1024, 4, [280, 280, 280, 184], [[10, 10, 10, 7], [5, 5, 5, 4]]),
    ("vil_medium_deep", 384, 4, [112, 112, 112, 48], [[4, 4, 4, 2], [2, 2, 2, 1]]),
    ("vil_small", 224, 2, [112, 112], [[4, 4], [2, 2]]),
    ("vil_small", 224, 4, [56] * 4, [[2] * 4, [1] * 4]),
])
def test_chunk_aligned_split(name, img, size, rows, chunks):
    """The blocks of one chunk row of every chunked stage go as evenly as
    they can, the first ranks taking one more; the chunk rows add up to the
    whole grid's, the pad on the last rank."""
    split = _split(name, img, size)
    assert [hi - lo for lo, hi in split.image] == rows
    assert [[hi - lo for lo, hi in stage] for stage in split.chunks] == chunks
    for stage, tokens in zip(split.chunks, split.tokens):
        assert [lo for lo, _ in stage[1:]] == [hi for _, hi in stage[:-1]]
        assert [lo for lo, _ in tokens[1:]] == [hi for _, hi in tokens[:-1]]


def test_split_without_rows_raises_naming_the_stage():
    """ViL-Small 224² has 4 blocks of 56 rows: 8 ranks would leave 4 with no
    row; the narrow model's 5 blocks split over 4 ranks 2/1/1/1, over 8 not.
    The model's own split is the rule's, cached by rank count."""
    with pytest.raises(ValueError, match="no row of stage 1"):
        _split("vil_small", 224, 8)
    model = MsViT(ARCH, img_size=IMG, num_classes=10, sharew=True, device="cpu")
    assert model.spatial_split(4) is model.spatial_split(4) == _split(ARCH, IMG, 4)
    assert [hi - lo for lo, hi in model.spatial_split(4).image] == [48, 24, 24, 8]
    with pytest.raises(ValueError, match="no row of stage 1"):
        model.spatial_split(8)


# --------------------------------------------------- spawned process groups

def _spawn(case_dir, world, spatial, mode):
    """Run the worker on ``world`` ranks; returns each rank's results."""
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, WORKER, str(case_dir), str(r), str(world),
                               str(spatial), mode], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(world)]
    try:
        outs = [p.communicate(timeout=SPAWN_TIMEOUT)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and f"WORKER {r} DONE" in out, f"rank {r}:\n{out[-4000:]}"
    return [dict(np.load(case_dir / f"rank{r}.npz")) for r in range(world)]


def _jax_tree(t) -> dict:
    """A flax tree under the port's names and layouts."""
    return {n: a for n, a in (jax_import._to_torch_leaf(k, np.asarray(v))
                              for k, v in jax_import._flatten(t))}


def _jax_model(opts, images, seed):
    """vil_tpu's model of ``opts`` and flax parameters drawn from ``seed``
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
    return cfg, model, params


def _jax_step(opts, images, targets, seed):
    """Draw flax parameters, take vil_tpu's single-device step on the whole
    batch: (params, loss, grads, updated params), the trees under the port's
    names."""
    cfg, model, params = _jax_model(opts, images, seed)
    tx = jax_optim.get_opt(cfg, params, lr=float(cfg.OPTIM.LR))
    state = jax_engine.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                                  opt_state=tx.init(params), buffers={})
    state, metrics = jax.jit(jax_engine.make_train_step(model, jax_loss.cross_entropy, tx))(
        state, jnp.asarray(images), jnp.asarray(targets), jax.random.PRNGKey(0))
    # the gradient the step took: Adam's first moment after one step from
    # zero is (1 - β₁)·g
    adam = next(s for s in jax.tree_util.tree_leaves(
        state.opt_state, is_leaf=lambda s: isinstance(s, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState))
    grads = jax.tree_util.tree_map(lambda m: m / (1 - cfg.OPTIM.ADAM.BETA1), adam.mu)
    return params, float(metrics["loss"]), _jax_tree(grads), _jax_tree(state.params)


def _jax_mode_grads(opts, images, targets, seed, modes):
    """Loss and parameter gradients of vil_tpu's model in training at the
    per-block ``modes`` (a list: traced, as random shift runs them) or one
    static mode, from the parameters ``_jax_step`` draws from ``seed``."""
    _, model, params = _jax_model(opts, images, seed)
    mode = jnp.asarray(modes) if isinstance(modes, list) else modes

    def loss_fn(p):
        logits = model.apply({"params": p}, jnp.asarray(images), deterministic=False, mode=mode)
        return jax_loss.cross_entropy(logits, jnp.asarray(targets))

    value, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    return float(value), _jax_tree(grads), None


@pytest.fixture(scope="module")
def step_case(tmp_path_factory):
    """The global batch, each case's weights for the workers, and what they
    are held to: vil_tpu's step for APE and RPE; for drop path, by the
    mesh's data replicas, the port's unsplit steps of each replica."""
    out_dir = tmp_path_factory.mktemp("step_inputs")
    rng = np.random.default_rng(0)
    images = rng.standard_normal((BATCH, IMG, IMG, 3)).astype(np.float32)
    targets = rng.integers(0, 10, BATCH).astype(np.int64)
    np.savez(out_dir / "inputs.npz", images=images, targets=targets)
    # each case's options, the weights it starts from and how its step runs:
    # random shift drawn from the seed, or one mode given to the step
    cases = {"ape": (_opts(ARCH), "ape.pt"), "rpe": (_opts(ARCH_RPE), "rpe.pt"),
             "drop": (_opts(ARCH, DROP_PATH), "ape.pt"),
             "shift": (_opts(ARCH), "ape.pt", {"random_shift": True}),
             "self": (_opts(ARCH), "ape.pt", {"modes": -1}),
             "unshared": (_opts(ARCH, sharew=False), "unshared.pt")}
    refs = {}
    for case, seed in (("ape", 1), ("rpe", 2), ("unshared", 3)):
        params, *refs[case] = _jax_step(cases[case][0], images, targets, seed)
        cfg = get_default_cfg()
        cfg.merge_from_list(cases[case][0])
        model = jax_import.load_jax_params(build_model(cfg, device="cpu"), params)
        torch.save(model.state_dict(), out_dir / f"{case}.pt")
    # the modes the shift case's step draws at step 0, the same on every rank
    refs["modes"] = engine.sample_vil_modes(
        torch.Generator().manual_seed(engine.keyed_seed(SHIFT_SEED, 0, 1)), 3)
    refs["shift"] = _jax_mode_grads(cases["shift"][0], images, targets, 1, refs["modes"])
    refs["self"] = _jax_mode_grads(cases["self"][0], images, targets, 1, -1)
    # drop path: the port's own unsplit steps of each data replica
    refs["drop"], refs["dropped"] = {}, {}
    for data_size in (1, 2):
        refs["drop"][data_size], refs["dropped"][data_size] = _replica_steps(
            cases["drop"][0], out_dir / "ape.pt", images, targets, data_size)
    return out_dir, cases, refs


def _replica_steps(opts, weights, images, targets, data_size):
    """The port's unsplit step of each of ``data_size`` data replicas on its
    share of the batch, without a process group (``parallel.Mesh(data_size,
    d)``: the draws keyed by the replica, the gradient its own); then what a
    mesh's step makes of them: the replicas' mean loss and gradient, and one
    update from that gradient. Returns those and the samples each replica's
    draws dropped (a residual branch zeroed), counted by hooks on every
    ``DropPath``."""
    per = len(images) // data_size
    losses, grads, dropped = [], [], []

    def count(module, inputs, out):
        pairs = zip(inputs[0] if isinstance(out, tuple) else (inputs[0],),
                    out if isinstance(out, tuple) else (out,))
        x, y = next((x, y) for x, y in pairs if x is not None)
        dropped[-1] += int(((y.flatten(1) == 0).all(1) & (x.flatten(1) != 0).any(1)).sum())

    def model_and_opt():
        cfg = get_default_cfg()
        cfg.merge_from_list(opts)
        model = build_model(cfg, device="cpu")
        model.load_state_dict(torch.load(weights))
        return model, optim.get_opt(cfg, model)

    for d in range(data_size):
        model, opt = model_and_opt()
        for m in model.modules():
            if isinstance(m, DropPath):
                m.register_forward_hook(count)
        step = engine.make_train_step(model, loss.cross_entropy, opt, device="cpu", seed=0,
                                      mesh=parallel.Mesh(data_size, d))
        dropped.append(0)
        rows = slice(d * per, (d + 1) * per)
        losses.append(step(torch.from_numpy(images[rows]),
                           torch.from_numpy(targets[rows]))["loss"].item())
        grads.append({name: p.grad.clone() for name, p in model.named_parameters()})
    model, opt = model_and_opt()
    for name, p in model.named_parameters():
        p.grad = sum(g[name] for g in grads) / data_size
    opt.step()
    return ((float(np.mean(losses)), {n: p.grad.numpy() for n, p in model.named_parameters()},
             {n: p.detach().numpy() for n, p in model.named_parameters()}), dropped)


# the modes each (world, spatial) case runs in its one spawn of the worker
SPAWNS = {(1, 1): ("step",), (2, 2): ("step", "trainer"), (4, 4): ("step",), (4, 2): ("step",),
          (2, 1): ("step", "trainer")}


@pytest.fixture(scope="module")
def spawned(step_case, tmp_path_factory):
    """``run(world, spatial)`` → (its directory, each rank's results), from
    one spawn per case that runs every mode of ``SPAWNS``: the step's cases
    (drop path at (2, 2) and (4, 2)) and, at world 2, the Trainer's runs."""
    case_dir, cases, _ = step_case
    done = {}

    def run(world, spatial):
        if (world, spatial) not in done:
            out = tmp_path_factory.mktemp(f"world{world}_spatial{spatial}")
            for name in ("inputs.npz", "ape.pt", "rpe.pt", "unshared.pt"):
                os.symlink(case_dir / name, out / name)
            with open(out / "cases.json", "w") as f:
                json.dump({c: o for c, o in cases.items() if c in _step_cases(world, spatial)}, f)
            with open(out / "trainer.json", "w") as f:
                json.dump({"opts": TRAINER_OPTS, "resume": spatial == 2}, f)
            done[world, spatial] = out, _spawn(out, world, spatial,
                                               "+".join(SPAWNS[world, spatial]))
        return done[world, spatial]

    return run


def _step_cases(world, spatial):
    """APE everywhere; RPE on the ragged data × spatial mesh; drop path,
    random shift and mode −1 on the meshes whose replicas have two spatial
    ranks; unshared weights on the spatial 2 mesh."""
    return {(2, 2): ("ape", "drop", "shift", "self", "unshared"),
            (4, 2): ("ape", "rpe", "drop", "shift", "self")}.get((world, spatial), ("ape",))


@pytest.mark.parametrize("world,spatial", list(SPAWNS),
                         ids=["mesh1x1", "spatial2", "spatial4", "data2xspatial2", "data2"])
def test_step_on_a_mesh_matches_vil_tpu(step_case, spawned, world, spatial):
    refs = step_case[2]
    run = _step_cases(world, spatial)
    results = spawned(world, spatial)[1]
    for r, res in enumerate(results):  # the mesh's coordinates of each rank
        assert (int(res["data"]), int(res["spatial_rank"])) == divmod(r, spatial)
    for case in run:
        ref = refs[case]
        if case == "drop":  # the draws of the replicas of this mesh, each dropping some
            ref = ref[world // spatial]
            assert min(refs["dropped"][world // spatial]) > 0, refs["dropped"]
        ref_loss, ref_grads, ref_params = ref
        for r, res in enumerate(results):
            at = f"{case}, rank {r} of ({world}, {spatial})"
            if case == "shift":  # every rank drew the modes keyed by (seed, step)
                assert list(res["shift/modes"]) == refs["modes"], at
            assert abs(float(res[f"{case}/loss"]) - ref_loss) <= TOL, at
            assert {k.split("/", 2)[2] for k in res if k.startswith(f"{case}/grad/")} == \
                set(ref_grads), at
            for name, ref in ref_grads.items():
                err = np.abs(res[f"{case}/grad/{name}"] - ref).max()
                assert err <= TOL * np.abs(ref).max(), f"{at}: grad {name} {err:.3e}"
                if ref_params is None:  # held by loss and gradients alone
                    continue
                # Adam's first update, lr·g/(|g| + 1e-8), of an entry whose
                # gradient is near 1e-8 follows the gradient's rounding
                keep = np.abs(ref) >= RESOLVED * np.abs(ref).max()
                err = np.abs(res[f"{case}/param/{name}"] - ref_params[name])[keep].max(
                    initial=0.0)
                assert err <= TOL, f"{at}: updated {name} {err:.3e}"


# ---------------------------------------------------------------- the Trainer

# a 48² image in 3 blocks of 16 rows (6 and 3 chunk rows of 2): split 2/1;
# the pipeline draws nothing (the whole square image, no flip, no
# RandAugment, no erasing), so data replicas read what one process reads;
# random shift in the first of the 2 epochs, MODE 0 in the second
TRAINER_OPTS = [
    "MODEL.VIT.MSVIT.ARCH", "l1,h1,d16,n1,s1,g1,p4,f2_l2,h2,d32,n1,s1,g1,p2,f2_l3,h2,d32,n1,s0,g0,"
    "p2,f2", "INPUT.IMAGE_SIZE", "48", "DATA.NUM_CLASSES", "10", "DATALOADER.BSZ", "8",
    "DATALOADER.WORKERS", "0", "DATA.TRAIN", "('synthetic',)", "DATA.TEST", "('synthetic',)",
    "TPU.COMPUTE_DTYPE", "float32", "MODEL.VIT.DROP_PATH", "0.0", "OPTIM.LR", "1e-3",
    "OPTIM.EPOCHS", "2", "SOLVER.LR_POLICY", "cosine", "SOLVER.WARMUP_EPOCHS", "1.0",
    "LOG_FREQ", "1", "AUG.TIMM_AUG.USE_TRANSFORM", "True", "AUG.TIMM_AUG.HFLIP", "0.0",
    "AUG.TIMM_AUG.VFLIP", "0.0", "AUG.TIMM_AUG.AUTO_AUGMENT", "", "AUG.TIMM_AUG.RE_PROB",
    "0.0", "AUG.SCALE", "(1.0, 1.0)", "AUG.RATIO", "(1.0, 1.0)",
    "MODEL.VIT.MSVIT.MODE", "1", "MODEL.VIT.MSVIT.VIL_MODE_SWITCH", "0.5"]


@pytest.fixture(scope="module")
def one_process(tmp_path_factory):
    """The same experiment at world 1, in this process."""
    cfg = get_default_cfg()
    cfg.merge_from_list(TRAINER_OPTS + ["OUTPUT_DIR", str(tmp_path_factory.mktemp("world1"))])
    return run_experiment(cfg, device="cpu")


@pytest.mark.parametrize("spatial", [2, 1], ids=["spatial2", "data2"])
def test_trainer_at_world_2_matches_world_1(one_process, spawned, spatial):
    out, results = spawned(2, spatial)
    losses = [r["loss"] for r in one_process.steps_log]
    top1 = [e["top1"] for e in one_process.evals]
    assert len(losses) == 16 and one_process.best_evaluated
    assert [r["random_shift"] for r in one_process.steps_log] == [True] * 8 + [False] * 8
    for r, res in enumerate(results):
        assert (int(res["data"]), int(res["spatial_rank"])) == divmod(r, spatial)
        np.testing.assert_allclose(res["losses"], losses, rtol=0, atol=TOL, err_msg=f"rank {r}")
        assert list(res["steps"]) == list(range(16)) and bool(res["best_evaluated"])
        assert list(res["top1"]) == top1 and set(res["images"]) == {64}, f"rank {r}"
        if spatial == 2:  # stopped at epoch 1 and resumed: the uninterrupted run
            assert list(res["resumed_start"]) == [1, 8]
            np.testing.assert_array_equal(res["resumed_losses"], res["losses"])
            assert list(res["resumed_top1"]) == list(res["top1"][1:])
    files = sorted(os.listdir(out / "run"))
    assert files.count("model_best.ckpt") == 1 and files.count("config.yaml") == 1
    assert not [f for f in files if "rank" in f], files


# ------------------------------------------------------------ without a spawn

def test_accumulate_predictions_matches_vil_tpu(monkeypatch):
    """Two ranks' per-image dicts whose shards overlap at the sampler's
    padded repeats: each image once, the same merge as vil_tpu's on its
    master, and on every rank (the Trainer's eval merges through it)."""
    per_rank = [{0: (1.0, 0.0), 2: (0.0, 1.0), 4: (1.0, 1.0)},
                {1: (0.0, 0.0), 3: (1.0, 1.0), 0: (1.0, 0.0)}]  # index 0 repeated
    assert collectives.accumulate_predictions(per_rank[1]) == per_rank[1]  # one process
    monkeypatch.setattr(collectives, "all_gather", lambda d: per_rank)
    monkeypatch.setattr(jax_collectives, "gather_on_master", lambda d: per_rank)
    ours = collectives.accumulate_predictions(per_rank[0])
    assert ours == jax_collectives.accumulate_predictions(per_rank[0])
    assert sorted(ours) == [0, 1, 2, 3, 4]
    monkeypatch.setattr(collectives, "get_rank", lambda group=None: 1)  # not the master
    assert collectives.accumulate_predictions(per_rank[1]) == ours


def test_each_data_replica_reads_its_shard():
    """The train loader of data replica d of 2 reads every second index of
    the epoch's permutation from d, half the batch at a time: the replicas'
    batches together are the one-process loader's."""
    cfg = get_default_cfg()
    cfg.merge_from_list(TRAINER_OPTS)
    one = loader.make_epoch_data_loader(cfg, is_train=True)
    perm = list(one.sampler)
    for d in range(2):
        shard = loader.make_epoch_data_loader(cfg, is_train=True, is_distributed=True,
                                              num_replicas=2, rank=d)
        assert list(shard.sampler) == perm[d::2]
        assert shard.batch_size == 4 and len(shard) == len(one) == 8


@pytest.mark.parametrize("opts,error", [
    (["TPU.MESH_AXES", "['data', 'model', 'spatial']", "TPU.MESH_SHAPE", "[1, 1, 1]"], None),
    (["TPU.PARAM_SHARDING", "fsdp", "TPU.MESH_AXES", "['data', 'spatial']", "TPU.MESH_SHAPE",
      "[1, 1]"], None),
    (["TPU.PARAM_SHARDING", "tp"], ValueError),
], ids=["model_beside_spatial", "fsdp_beside_spatial", "tp_without_model_axis"])
def test_sharding_and_the_model_axis_still_raise(opts, error):
    """Parameter sharding is ported beside a data axis and beside a spatial
    one: a model axis or FSDP beside a spatial axis pass (and build their
    mesh without a process group), and 'tp' without a model axis raises
    ``ValueError``, as ``vil_tpu``'s trainer does."""
    cfg = get_default_cfg()
    cfg.merge_from_list(opts)
    if error is None:
        check_ported(cfg)
        mesh = parallel.mesh_from_cfg(cfg)
        assert mesh.spatial is not None
        assert (mesh.model is not None) == ("model" in cfg.TPU.MESH_AXES)
        return
    with pytest.raises(error, match="'model' axis"):
        check_ported(cfg)


def test_more_nccl_ranks_than_cards_raise(monkeypatch, tmp_path):
    """More nccl ranks than cards raise before any process group is set
    up; as many as there are cards pass."""
    parallel.mesh.check_cards(2, 2)
    with pytest.raises(ValueError, match="2 nccl ranks need 2 cards"):
        parallel.mesh.check_cards(2, 1)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="2 nccl ranks need 2 cards"):
        parallel.init_process_group(tmp_path / "store", 0, 2)
    assert not torch.distributed.is_initialized()


def test_trainer_on_a_mesh_without_a_process_group(tmp_path, monkeypatch):
    """A ('data', 'spatial') mesh of one rank without a process group: the
    spatial route on one rank of one, through the sampled-neighbour halo
    route in the random-shift epoch and the halo route in the MODE 0 one,
    the same losses as without the mesh, and as on a ('data', 'model',
    'spatial') mesh of one rank under 'tp' (its model and spatial contexts
    both there); a fused block under the split raises naming A12."""
    mesh = ["TPU.MESH_AXES", "['data','spatial']", "TPU.MESH_SHAPE", "[1,1]"]
    runs = {}
    for name, extra in (("plain", []), ("mesh", mesh)):
        cfg = get_default_cfg()
        cfg.merge_from_list(TRAINER_OPTS + extra + ["OUTPUT_DIR", str(tmp_path / name)])
        runs[name] = Trainer(cfg, device="cpu")
        runs[name].fit()
    assert runs["mesh"].mesh.spatial is not None and runs["plain"].mesh.spatial is None
    assert runs["mesh"].steps_run == {True: 8, False: 8}  # random shift, then MODE 0
    np.testing.assert_allclose([r["loss"] for r in runs["mesh"].steps_log],
                               [r["loss"] for r in runs["plain"].steps_log], rtol=0, atol=TOL)
    cfg = get_default_cfg()
    cfg.merge_from_list(TRAINER_OPTS + mesh + ["OUTPUT_DIR", str(tmp_path / "fused")])
    monkeypatch.setenv("VIL_TPU_FUSED_BLOCK", "1")
    with pytest.raises(NotImplementedError, match="A12"):
        Trainer(cfg, device="cpu").fit()
    cfg = get_default_cfg()
    cfg.merge_from_list(TRAINER_OPTS + ["TPU.MESH_AXES", "['data','model','spatial']",
                                        "TPU.MESH_SHAPE", "[1,1,1]", "TPU.PARAM_SHARDING", "tp",
                                        "OUTPUT_DIR", str(tmp_path / "model")])
    monkeypatch.setenv("VIL_TPU_FUSED_BLOCK", "0")
    both = Trainer(cfg, device="cpu")
    assert both.mesh.spatial is not None and both.mesh.model is not None
    both.fit()
    np.testing.assert_allclose([r["loss"] for r in both.steps_log],
                               [r["loss"] for r in runs["plain"].steps_log], rtol=0, atol=TOL)
