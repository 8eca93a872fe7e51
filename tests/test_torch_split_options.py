"""TPU.REMAT, MODEL.VIT.DROP and the ResNet zoo off the data axis: the port
on a ('data', 'spatial') mesh, under 'tp' on a ('data', 'model') mesh and
under 'fsdp', against itself on one rank and against ``vil_tpu``, on the
CPU.

One spawn of two gloo ranks (``tests/test_torch_split_options_worker.py``,
a ``FileStore`` in a temporary directory, one CPU thread a rank) takes
every case on the three meshes in turn; the tests below assert on its
results. The narrow model is ``tests/test_torch_spatial_train.py``'s: 104²,
W 3, whose 5 blocks of 24 input rows split 3/2 over the spatial axis (9
chunk rows 6/3 at stage 1, 5 rows 3/2 at stage 2, the pad on the last
rank), 2 heads in every stage, so that 'tp' splits every block. f32, batch
8, drop path 0, no mixup; its weights are ``vil_tpu``'s parameters drawn
from a seed (its REMAT 'full' model), loaded into the port.

* REMAT: on each mesh the step under 'minimal' and 'full' equals the same
  mesh's step without REMAT bit for bit (loss and every gradient, on every
  rank); the step equals the port's one-rank step to 1e-5 of each
  gradient's max|ref| (the limit of the existing mesh tests) and
  ``vil_tpu``'s one-device step under REMAT 'full' to 1e-4 (loss, and each
  gradient of its max|ref|). Every rank issues the same collectives in the
  same order (``parallel.count_collectives``); the recompute re-issues a
  spatial block's halo exchanges and reductions and a 'tp' block's
  all-reduces, and FSDP's gathers stay where the forward made them. A
  release of FSDP's gathered weights between the forward and the backward
  makes the backward raise.
* DROP 0.1, on the spatial and the 'tp' mesh, alone and under REMAT 'full':
  every mask a rank draws is its part of the mask the one-rank step draws
  at the same place (its chunk rows, its hidden features, or the whole),
  checked directly, and the recompute draws the same rank-local masks
  again. The split step's loss and gradients equal the one-rank step's:
  every gradient to 1e-5 of its own max|ref| and all of them to 1e-6 of the
  largest (per parameter the f32 split step reads up to ≈3e-6 of a small
  gradient's max|ref| against the one-rank step with or without dropout:
  the spatial reductions and the model group's sums add in another order);
  under REMAT 'full' it equals the same mesh's step without REMAT bit for
  bit.
* The ResNet (a ResNet-50 at 32², f64, as ``tests/test_torch_resnet.py``
  holds BatchNorm) under 'fsdp' over the data axis (its BatchNorms over the
  global batch) and under 'tp' (whole on every model rank): loss, every
  gradient and the running statistics against the one-rank step to 1e-5.
* The Trainer (``train.trainer.run_experiment``, the entry point's Trainer)
  at world 2 on each mesh: REMAT 'full' with DROP 0.1 on the spatial mesh,
  REMAT 'minimal' with DROP 0.1 under 'tp', REMAT 'full' under 'fsdp', a
  ResNet-18 under 'tp'; every logged loss to 1e-5 of the same run at world
  1 in this process (the draws of a replica are the one process's), the
  evals' top1 equal. A ResNet-18 under 'fsdp' over two replicas: its first
  loss to 1e-5 of world 1's and every loss finite (f32 BatchNorm over two
  replicas' sums differs from one process's in its last digits, a
  cancellation, as ``tests/test_torch_resnet.py`` says, and Adam's
  normalised updates amplify it step by step: 5.7e-5 at the second step,
  0.3 at the sixth, the run on the data axis without FSDP as far; the f64
  step above holds the ResNet under 'fsdp' itself).
* Without a spawn: ``check_ported`` accepts what this slice ports, a
  model axis or FSDP beside a spatial axis and a ResNet on a spatial axis,
  and still refuses orbax (A6) and the flat or stacked optimizer states
  (A13) on those meshes; a ResNet on a one-rank spatial mesh runs the
  classic forward.
"""
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vil_tpu.config import get_default_cfg as jax_default_cfg
from vil_tpu.models import build_model as jax_build_model
from vil_tpu.train import loss as jax_loss

from vil_tpu_torch.config import get_default_cfg
from vil_tpu_torch.models import build_model
from vil_tpu_torch.models.layers import Part
from vil_tpu_torch.train import engine, loss, optim
from vil_tpu_torch.train.trainer import check_ported, run_experiment
from vil_tpu_torch.utils import jax_import

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_split_options_worker import MaskLog  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "test_torch_split_options_worker.py")
SPAWN_TIMEOUT = 300  # seconds, the one spawn
TOL = 1e-5  # the mesh tests' limit against the one-rank step
VIL_TOL = 1e-4  # against vil_tpu's step (PERF.md §2)
DROP_TOL = 1e-6  # the dropout step against the one-rank step, of the largest max|ref|
ARCH = "l1,h2,d16,n1,s1,g1,p4,f3_l2,h2,d32,n1,s1,g1,p2,f3_l3,h2,d32,n1,s0,g1,p2,f3"
IMG, BATCH, RESNET_IMG = 104, 8, 32
MESHES = {
    "spatial": ["TPU.MESH_AXES", "['data','spatial']", "TPU.MESH_SHAPE", "[1,2]"],
    "tp": ["TPU.MESH_AXES", "['data','model']", "TPU.MESH_SHAPE", "[1,2]",
           "TPU.PARAM_SHARDING", "tp"],
    "fsdp": ["TPU.MESH_AXES", "['data']", "TPU.MESH_SHAPE", "[2]", "TPU.PARAM_SHARDING", "fsdp"],
}
REMATS = ("", "minimal", "full")
# the ViL steps: (mesh, REMAT, DROP)
STEPS = {f"{mesh}_{remat or 'none'}": (mesh, remat, 0.0) for mesh in MESHES for remat in REMATS}
STEPS.update({f"{mesh}_drop{'_' + remat if remat else ''}": (mesh, remat, 0.1)
              for mesh in ("spatial", "tp") for remat in ("", "full")})
RESNET_STEPS = ("fsdp", "tp")
# the Trainer's runs: a 48² image, a draw-free pipeline, one epoch of 8 steps
TRAINER_OPTS = [
    "MODEL.VIT.MSVIT.ARCH", "l1,h2,d16,n1,s1,g1,p4,f2_l2,h2,d32,n1,s1,g1,p2,f2_l3,h2,d64,n1,s0,g0,"
    "p2,f2", "INPUT.IMAGE_SIZE", "48", "DATA.NUM_CLASSES", "10", "DATALOADER.BSZ", "8",
    "DATALOADER.WORKERS", "0", "DATA.TRAIN", "('synthetic',)", "DATA.TEST", "('synthetic',)",
    "TPU.COMPUTE_DTYPE", "float32", "MODEL.VIT.DROP_PATH", "0.0", "OPTIM.LR", "1e-3",
    "OPTIM.EPOCHS", "1", "SOLVER.LR_POLICY", "cosine", "SOLVER.WARMUP_EPOCHS", "1.0",
    "LOG_FREQ", "1", "AUG.TIMM_AUG.USE_TRANSFORM", "True", "AUG.TIMM_AUG.HFLIP", "0.0",
    "AUG.TIMM_AUG.VFLIP", "0.0", "AUG.TIMM_AUG.AUTO_AUGMENT", "", "AUG.TIMM_AUG.RE_PROB",
    "0.0", "AUG.SCALE", "(1.0, 1.0)", "AUG.RATIO", "(1.0, 1.0)"]
DROPPED = ["MODEL.VIT.DROP", "0.1"]
RESNET18 = ["MODEL.ARCH", "resnet18", "INPUT.IMAGE_SIZE", "32"]
# name → (options, the world-1 run it equals)
TRAINER_RUNS = {
    "spatial_full_drop": (DROPPED + ["TPU.REMAT", "full"] + MESHES["spatial"], "drop"),
    "tp_minimal_drop": (DROPPED + ["TPU.REMAT", "minimal"] + MESHES["tp"], "drop"),
    "fsdp_full": (["TPU.REMAT", "full"] + MESHES["fsdp"], "plain"),
    "resnet_fsdp": (RESNET18 + MESHES["fsdp"], "resnet"),
    "resnet_tp": (RESNET18 + MESHES["tp"], "resnet"),
}
# the runs whose steps after the second follow f32 rounding: a ResNet whose
# BatchNorms sum two replicas' statistics (a cancellation, as
# tests/test_torch_resnet.py says), which Adam's normalised updates amplify
# step by step (the same run on the data axis without FSDP drifts as far)
EARLY = {"resnet_fsdp": 1}
WORLD1 = {"plain": [], "drop": DROPPED, "resnet": RESNET18}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One CPU thread for torch in this module, as each spawned rank has."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _opts(*extra):
    return ["MODEL.VIT.MSVIT.ARCH", ARCH, "INPUT.IMAGE_SIZE", str(IMG),
            "DATA.NUM_CLASSES", "10", "TPU.COMPUTE_DTYPE", "float32",
            "MODEL.VIT.DROP_PATH", "0.0", "MODEL.VIT.NORM_EMBED", "True",
            "MODEL.VIT.MSVIT.SHARE_W", "True", "OPTIM.OPT", "adamw", "OPTIM.LR", "1e-3", *extra]


def _resnet_opts(*extra):
    return ["MODEL.ARCH", "resnet50", "INPUT.IMAGE_SIZE", str(RESNET_IMG),
            "DATA.NUM_CLASSES", "10", "OPTIM.OPT", "adamw", "OPTIM.LR", "1e-2", *extra]


def _cfg(opts):
    cfg = get_default_cfg()
    cfg.merge_from_list(opts)
    return cfg


def _case_opts(mesh, remat, drop):
    return _opts("TPU.REMAT", remat, "MODEL.VIT.DROP", str(drop), *MESHES[mesh])


def _one_rank_step(opts, weights, images, targets, dtype=torch.float32):
    """The port's step without a process group on the whole batch, seed 0
    (the draws of data replica 0): (loss, gradients, running statistics,
    the masks drawn)."""
    cfg = _cfg(opts)
    model = build_model(cfg, device="cpu", dtype=dtype, param_dtype=dtype)
    model.load_state_dict(torch.load(weights, weights_only=True))
    step = engine.make_train_step(model, loss.cross_entropy, optim.get_opt(cfg, model),
                                  device="cpu", seed=0)
    with MaskLog() as drawn:
        value = step(torch.from_numpy(images).to(dtype), torch.from_numpy(targets))["loss"]
    return (value.item(), {n: p.grad.numpy() for n, p in model.named_parameters()},
            {n: b.numpy() for n, b in model.named_buffers() if "running" in n}, drawn.masks)


def _vil_tpu_remat_step(params, images, targets):
    """``vil_tpu``'s model under REMAT 'full', one device, training mode at
    mode 0: its loss and gradients, under the port's names."""
    jcfg = jax_default_cfg()
    jcfg.merge_from_list(_opts("TPU.REMAT", "full"))
    jmodel = jax_build_model(jcfg, use_pallas=False)
    assert jmodel.remat == "full"

    def loss_fn(p):
        logits = jmodel.apply({"params": p}, jnp.asarray(images), deterministic=False, mode=0)
        return jax_loss.cross_entropy(logits, jnp.asarray(targets))

    value, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    return float(value), {n: a for n, a in (jax_import._to_torch_leaf(k, np.asarray(v))
                                            for k, v in jax_import._flatten(grads))}


def _draw_flax_params(images, seed):
    """``vil_tpu``'s parameters of the REMAT 'full' model, drawn from
    ``seed`` (LayerNorm scales near 1)."""
    jcfg = jax_default_cfg()
    jcfg.merge_from_list(_opts("TPU.REMAT", "full"))
    jmodel = jax_build_model(jcfg, use_pallas=False)
    shapes = jax.eval_shape(lambda: jmodel.init({"params": jax.random.PRNGKey(0)},
                                                jnp.asarray(images[:1])))["params"]
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map_with_path(
        lambda path, sds: (float(path[-1].key == "scale")
                           + 0.05 * rng.standard_normal(sds.shape)).astype(np.float32),
        shapes)


def _launch(out_dir, world=2):
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1")
    return [subprocess.Popen([sys.executable, WORKER, str(out_dir), str(r), str(world)],
                             env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                             text=True) for r in range(world)]


@pytest.fixture(scope="module")
def split_runs(tmp_path_factory):
    """Writes the inputs, the ViL's weights (``vil_tpu``'s drawn
    parameters, loaded into the port) and the f64 ResNet's, starts the one
    spawn, and while it runs computes what its cases are held to: the port's
    one-rank steps (without and with dropout, their masks recorded; the
    ResNet's), ``vil_tpu``'s REMAT step and the Trainer's runs at world 1.
    Yields (refs, the spawn's directory, its processes)."""
    out = tmp_path_factory.mktemp("split_options")
    rng = np.random.default_rng(0)
    images = rng.standard_normal((BATCH, IMG, IMG, 3)).astype(np.float32)
    targets = rng.integers(0, 10, BATCH).astype(np.int64)
    resnet_images = rng.standard_normal((BATCH, RESNET_IMG, RESNET_IMG, 3))
    np.savez(out / "inputs.npz", images=images, targets=targets)
    np.savez(out / "resnet_inputs.npz", images=resnet_images, targets=targets)
    params = _draw_flax_params(images, 1)
    torch.save(jax_import.load_jax_params(build_model(_cfg(_opts()), device="cpu"),
                                          params).state_dict(), out / "vil.pt")
    resnet = build_model(_cfg(_resnet_opts()), device="cpu", dtype=torch.float64,
                         param_dtype=torch.float64, generator=torch.Generator().manual_seed(3))
    rng_bn = np.random.default_rng(5)  # running statistics other than the init's
    torch.save({k: (v if "running" not in k else
                    torch.from_numpy(rng_bn.uniform(0.5, 1.5, v.shape)).to(v.dtype))
                for k, v in resnet.state_dict().items()}, out / "resnet.pt")
    steps = {case: dict(opts=_case_opts(*how), weights="vil.pt")
             for case, how in STEPS.items()}
    steps.update({f"resnet_{mesh}": dict(opts=_resnet_opts(*MESHES[mesh]), weights="resnet.pt",
                                         dtype="float64", inputs="resnet_inputs.npz")
                  for mesh in RESNET_STEPS})
    spec = {"steps": steps,
            "release": dict(opts=_case_opts("fsdp", "full", 0.0), weights="vil.pt"),
            "trainers": {name: TRAINER_OPTS + opts for name, (opts, _) in TRAINER_RUNS.items()}}
    with open(out / "spec.json", "w") as f:
        json.dump(spec, f)
    procs = _launch(out)
    try:
        refs = {"plain": _one_rank_step(_opts(), out / "vil.pt", images, targets),
                "drop": _one_rank_step(_opts(*DROPPED), out / "vil.pt", images, targets),
                "resnet": _one_rank_step(_resnet_opts(), out / "resnet.pt", resnet_images,
                                         targets, torch.float64),
                "vil_tpu": _vil_tpu_remat_step(params, images, targets)}
        for name, extra in WORLD1.items():
            refs[f"world1/{name}"] = run_experiment(_cfg(TRAINER_OPTS + extra + [
                "OUTPUT_DIR", str(tmp_path_factory.mktemp(f"world1_{name}"))]), device="cpu")
        yield refs, out, procs
    finally:
        for p in procs:
            p.kill()


@pytest.fixture(scope="module")
def ranks(split_runs):
    """Each rank's results, once the spawn has ended."""
    _, out, procs = split_runs
    outs = [p.communicate(timeout=SPAWN_TIMEOUT)[0] for p in procs]
    for r, (p, text) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and f"WORKER {r} DONE" in text, f"rank {r}:\n{text[-4000:]}"
    return [dict(np.load(out / f"rank{r}.npz")) for r in range(len(procs))]


def _grads(res, case):
    prefix = f"{case}/grad/"
    return {k[len(prefix):]: v for k, v in res.items() if k.startswith(prefix)}


def _masks(res, case):
    n = sum(k.startswith(f"{case}/mask/") for k in res)
    return [res[f"{case}/mask/{i}"] for i in range(n)]


def _hold(got: dict, ref: dict, tol: float, at: str):
    """Every gradient to ``tol`` of its own max|ref|."""
    assert set(got) == set(ref), at
    for name, r in ref.items():
        err = np.abs(got[name] - r).max()
        assert err <= tol * np.abs(r).max(), f"{at}: grad {name} {err:.3e}"


# ------------------------------------------------------------------ REMAT

@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("remat", ["minimal", "full"])
def test_remat_equals_the_same_mesh_without(ranks, mesh, remat):
    """Bit for bit, on every rank: the recompute redoes the same operations
    on the same values, its collectives included."""
    for r, res in enumerate(ranks):
        base, got = _grads(res, f"{mesh}_none"), _grads(res, f"{mesh}_{remat}")
        assert res[f"{mesh}_{remat}/loss"] == res[f"{mesh}_none/loss"], (mesh, remat, r)
        assert set(got) == set(base)
        for name, g in base.items():
            assert np.array_equal(got[name], g), f"{mesh} {remat} rank {r}: {name}"


@pytest.mark.parametrize("case", [c for c, (_, _, drop) in STEPS.items() if not drop])
def test_split_step_matches_one_rank_and_vil_tpu(split_runs, ranks, case):
    """Against the port's one-rank step at the mesh tests' limit, and
    against ``vil_tpu``'s one-device step under REMAT 'full' at 1e-4."""
    refs = split_runs[0]
    one_loss, one_grads, _, _ = refs["plain"]
    vil_loss, vil_grads = refs["vil_tpu"]
    for r, res in enumerate(ranks):
        at = f"{case}, rank {r}"
        got = _grads(res, case)
        assert abs(float(res[f"{case}/loss"]) - one_loss) <= TOL, at
        _hold(got, one_grads, TOL, at)
        assert abs(float(res[f"{case}/loss"]) - vil_loss) <= VIL_TOL, at
        _hold(got, vil_grads, VIL_TOL, f"{at} vs vil_tpu")


@pytest.mark.parametrize("mesh", list(MESHES))
def test_collectives_in_one_order_on_every_rank(ranks, mesh):
    """Each rank issues the same collectives, of the same sizes, in the same
    order, with REMAT and without. The recompute of a spatial block
    re-issues its halo exchanges and its global branch's reductions, a 'tp'
    block its model group's all-reduce (the same under 'minimal', whose
    policy recomputes every collective); FSDP's gathers are not repeated:
    the recompute finds the weights gathered."""
    logs = [{remat: json.loads(str(res[f"{mesh}_{remat or 'none'}/collectives"]))
             for remat in REMATS} for res in ranks]
    assert all(log == logs[0] for log in logs[1:])
    plain, minimal, full = (logs[0][r] for r in REMATS)
    assert minimal == full
    if mesh == "fsdp":
        assert full == plain
        return
    count = lambda log, name: sum(n == name for n, _ in log)
    names = {n for n, _ in full}
    assert names == {n for n, _ in plain}
    grown = {n for n in names if count(full, n) > count(plain, n)}
    assert grown == {"spatial": {"batch_isend_irecv", "all_reduce"}, "tp": {"all_reduce"}}[mesh]


def test_fsdp_release_before_the_backward_raises(ranks):
    """The step lets the gathered weights go only after the backward: a
    release before it leaves the saved weights at their slices, and the
    backward fails loudly rather than read them."""
    for res in ranks:
        error = str(res["release/error"])
        assert error and "size" in error, error


# ---------------------------------------------------------------- dropout

DROP_CASES = [c for c, (_, _, drop) in STEPS.items() if drop]


@pytest.mark.parametrize("case", DROP_CASES)
def test_each_rank_draws_its_part_of_the_one_rank_masks(split_runs, ranks, case):
    """Every mask a rank draws in the forward is its part of the one-rank
    step's mask at the same site, in the same order; under REMAT the
    recompute draws the forward's masks again (early-stopped: the masks
    after a block's last saved value are not drawn again)."""
    one = split_runs[0]["drop"][3]
    remat = STEPS[case][1]
    for r, res in enumerate(ranks):
        masks = _masks(res, case)
        cuts = json.loads(str(res[f"{case}/cuts"]))
        forward = masks[:len(one)]
        assert len(forward) == len(one) and (len(masks) > len(one)) == bool(remat), \
            (case, r, len(masks), len(one))
        for i, (mine, whole, cut) in enumerate(zip(forward, one, cuts)):
            part = Part(tuple((d, t, tuple(tuple(s) for s in spans)) for d, t, spans in cut))
            assert np.array_equal(mine, part.of(torch.from_numpy(whole)).numpy()), \
                f"{case} rank {r}: mask {i} ({cut})"
        split = [c for c in cuts[:len(one)] if c]
        assert split, f"{case} rank {r}: no mask was a part"
        for i, again in enumerate(masks[len(one):]):
            assert any(m.shape == again.shape and np.array_equal(m, again) for m in forward), \
                f"{case} rank {r}: recomputed mask {i} is none of the forward's"


@pytest.mark.parametrize("case", DROP_CASES)
def test_dropout_split_step_matches_one_rank(split_runs, ranks, case):
    one_loss, one_grads, _, _ = split_runs[0]["drop"]
    largest = max(np.abs(g).max() for g in one_grads.values())
    mesh, remat, _ = STEPS[case]
    for r, res in enumerate(ranks):
        at = f"{case}, rank {r}"
        got = _grads(res, case)
        assert abs(float(res[f"{case}/loss"]) - one_loss) <= DROP_TOL, at
        _hold(got, one_grads, TOL, at)
        worst = max(np.abs(got[n] - g).max() for n, g in one_grads.items())
        assert worst <= DROP_TOL * largest, f"{at}: {worst:.3e} of {largest:.3e}"
        if remat:
            base = _grads(res, f"{mesh}_drop")
            assert all(np.array_equal(got[n], g) for n, g in base.items()), at


# ----------------------------------------------------------------- ResNet

@pytest.mark.parametrize("mesh", RESNET_STEPS)
def test_resnet_step_matches_one_rank(split_runs, ranks, mesh):
    """f64: under 'fsdp' each rank takes half the batch and its BatchNorms
    the global batch's statistics; under 'tp' each model rank runs the whole
    ResNet on the whole batch."""
    one_loss, one_grads, one_stats, _ = split_runs[0]["resnet"]
    case = f"resnet_{mesh}"
    for r, res in enumerate(ranks):
        at = f"{case}, rank {r}"
        assert abs(float(res[f"{case}/loss"]) - one_loss) <= TOL, at
        got = _grads(res, case)
        assert set(got) == set(one_grads), at
        for name, g in one_grads.items():
            err = np.abs(got[name] - g).max()
            assert err <= TOL * max(1.0, np.abs(g).max()), f"{at}: grad {name} {err:.3e}"
        for name, s in one_stats.items():
            err = np.abs(res[f"{case}/buffer/{name}"] - s).max()
            assert err <= TOL * max(1.0, np.abs(s).max()), f"{at}: {name} {err:.3e}"


# ------------------------------------------------------------ the Trainer

@pytest.mark.parametrize("name", list(TRAINER_RUNS))
def test_trainer_at_world_2_matches_world_1(split_runs, ranks, name):
    world1 = split_runs[0][f"world1/{TRAINER_RUNS[name][1]}"]
    losses = [r["loss"] for r in world1.steps_log]
    assert len(losses) == 8 and all(np.isfinite(losses))
    for r, res in enumerate(ranks):
        got = res[f"{name}/losses"]
        if name in EARLY:
            n = EARLY[name]
            assert len(got) == 8 and np.isfinite(got).all(), (name, r)
            np.testing.assert_allclose(got[:n], losses[:n], rtol=0, atol=TOL,
                                       err_msg=f"{name}, rank {r}")
            continue
        np.testing.assert_allclose(got, losses, rtol=0, atol=TOL, err_msg=f"{name}, rank {r}")
        assert list(res[f"{name}/top1"]) == [e["top1"] for e in world1.evals], (name, r)


# -------------------------------------------------------- without a spawn

@pytest.mark.parametrize("opts", [
    ["TPU.REMAT", "full", *MESHES["spatial"]],
    ["TPU.REMAT", "minimal", *MESHES["tp"]],
    ["TPU.REMAT", "full", *MESHES["fsdp"]],
    ["MODEL.VIT.DROP", "0.1", *MESHES["spatial"]],
    ["MODEL.VIT.DROP", "0.1", "TPU.REMAT", "minimal", *MESHES["tp"]],
    ["MODEL.ARCH", "resnet50", *MESHES["fsdp"]],
    ["MODEL.ARCH", "resnet50", *MESHES["tp"]],
    ["TPU.REMAT", "full", "TPU.MESH_AXES", "['data','spatial','model']", "TPU.MESH_SHAPE",
     "[1,1,2]", "TPU.PARAM_SHARDING", "tp"],
    ["MODEL.VIT.DROP", "0.1", "TPU.PARAM_SHARDING", "fsdp", *MESHES["spatial"]],
    ["MODEL.ARCH", "resnet50", *MESHES["spatial"]],
    ["MODEL.ARCH", "resnet50", "TPU.MESH_AXES", "['data','model','spatial']",
     "TPU.MESH_SHAPE", "[1,1,1]"],
], ids=["remat_spatial", "remat_tp", "remat_fsdp", "drop_spatial", "drop_remat_tp",
        "resnet_fsdp", "resnet_tp", "remat_model_beside_spatial", "drop_fsdp_beside_spatial",
        "resnet_spatial", "resnet_model_beside_spatial"])
def test_check_ported_accepts(opts):
    check_ported(_cfg(opts))


@pytest.mark.parametrize("opts,what", [
    (["CKPT_BACKEND", "orbax", "TPU.PARAM_SHARDING", "fsdp", *MESHES["spatial"]],
     "orbax.*A6"),
    (["TPU.FLAT_OPT", "True", "TPU.MESH_AXES", "['data','spatial','model']",
      "TPU.MESH_SHAPE", "[1,1,1]", "TPU.PARAM_SHARDING", "tp"], "FLAT_OPT / STACKED_OPT.*A13"),
    (["TPU.STACKED_OPT", "True", "TPU.PARAM_SHARDING", "fsdp", *MESHES["spatial"]],
     "FLAT_OPT / STACKED_OPT.*A13"),
], ids=["fsdp_beside_spatial", "flat_opt_3d", "stacked_opt_fsdp_spatial"])
def test_check_ported_still_refuses(opts, what):
    """Beside a spatial axis a model axis, FSDP and a ResNet pass (the
    meshes ``tests/test_torch_mesh3d.py`` and ``tests/test_torch_mesh_models.py``
    run); orbax and the flat or stacked optimizer states still raise on
    them, naming their items."""
    with pytest.raises(NotImplementedError, match=what):
        check_ported(_cfg(opts))


def test_resnet_on_a_one_rank_spatial_mesh_equals_the_classic_forward():
    """Without a process group (a one-rank spatial mesh) the ResNet builds,
    its rows are the whole image, and its forward, training and eval, is
    the classic one's bit for bit (every halo is the image's padding); on a
    model axis it builds whole."""
    from vil_tpu_torch import parallel

    one = ["TPU.MESH_SHAPE", "[1,1]"]
    cfg = _cfg(_resnet_opts(*MESHES["spatial"], *one))
    mesh = parallel.mesh_from_cfg(cfg)
    model = build_model(cfg, device="cpu", mesh=mesh, generator=torch.Generator().manual_seed(0))
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, RESNET_IMG, RESNET_IMG, 3)).astype(np.float32))
    assert model.spatial_split(1).image == ((0, RESNET_IMG),)
    for train in (True, False):
        model.train(train)
        split = parallel.spatial_forward(model, parallel.shard_image(x, model), None)
        assert torch.equal(split, model(x)), train
    cfg = _cfg(_resnet_opts(*MESHES["tp"], *one))
    model = build_model(cfg, device="cpu", mesh=parallel.mesh_from_cfg(cfg))
    assert not model.param_shards and model.partial_over_model() == []
