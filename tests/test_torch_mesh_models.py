"""Every model of ``build_model`` on every mesh of the Trainer: the ResNet zoo
on a spatial axis and the linformer, srformer, performer, only-global and
unshared-global attentions under TPU.PARAM_SHARDING 'tp', against the
port's one-rank step and against ``vil_tpu``, on the CPU.

One spawn of four gloo ranks (``tests/test_torch_mesh_models_worker.py``, a
``FileStore`` in a temporary directory, one CPU thread a rank) takes every
case in turn, building the sub-groups of each mesh:

* The halo layers alone, over the first 2 and the first 3 ranks, an image
  of 22 rows cut at even rows (12/10 and 8/8/6): a 7×7/2, a 3×3/2 and a
  3×3/1 convolution and the 3×3/2 max-pool, forward and backward, against
  the whole image in f64 to 1e-12 of each value's scale. The inputs are
  offset (+5 for the convolutions, −10 for the pool), so that a wrapped
  row or a wrong padding value at the top and bottom edges shows; the
  first rank's window pads above and the last one's below where the layer
  reads past the image.
* A ResNet on a spatial axis, in f64: the zoo's basic-block ``resnet18``
  and bottleneck ``resnet50`` at 96² (3 blocks of 32 rows; 3 rows at the
  last stage), batch 4, with ``vil_tpu``'s variables drawn from a seed
  (``tests/test_torch_resnet.py``'s draw). Meshes: ('data', 'spatial')
  (2, 2) replicated, the rows split 2/1 blocks (ragged); the first 3 ranks
  as one spatial group (1/1/1, a ``parallel.Mesh`` built by hand); (2, 2)
  under 'fsdp'; and ('data', 'spatial', 'model') (1, 2, 2) under 'tp', the
  ResNet whole on both model ranks. Each rank's loss, training logits and
  eval logits (equal on every rank of a replica) against the port's
  one-rank step to F32_REL (the logits are f32 in both packages), every
  gradient to GRAD_REL of its max|ref| (only the order of the BatchNorm and
  pool sums differs), the running statistics (f32 buffers) to F32_REL; and
  the same step against ``vil_tpu``'s one-device f64 step to
  ``tests/test_torch_resnet.py``'s limit. The ragged split fails the
  parent's BatchNorm count, which multiplied one rank's count by the ranks.
* The families under 'tp', f32, on ``tests/test_torch_sharding.py``'s
  narrow ARCH (a last stage of 3 heads, which stays whole over 2 model
  ranks) at 32², batch 4: linformer (SHARE_KV both ways), srformer,
  performer (after a redraw from a seed), ONLY_GLOBAL and SHARE_W False on
  ('data', 'model') (2, 2) and ('data', 'spatial', 'model') (1, 2, 2):
  loss and gradients against the port's one-rank step to the mesh tests'
  limit (1e-5 of each gradient's max|ref|); the one-rank step against
  ``vil_tpu``'s as ``tests/test_torch_efficient.py`` holds a model (1e-4,
  the srformer's ``proj_sr`` to its ``SR_CONV_TOL``); the performer's
  projection the same on every rank and equal to the one-rank model's.
* The Trainer (``run_experiment``) with a ResNet-18 at 64² on ('data',
  'spatial') (2, 2) against the same run at world 1 in this process.

``check_ported`` and ``build_model`` accept every zoo name on the three
spatial meshes and every family under 'tp' (without a spawn).
"""
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vil_tpu.config import get_default_cfg as jax_default_cfg
from vil_tpu.models import build_model as jax_build_model
from vil_tpu.models.resnet import build_resnet as jax_build_resnet
from vil_tpu.train import loss as jax_loss

from vil_tpu_torch import parallel
from vil_tpu_torch.models import RESNET_ZOO, build_model, build_resnet
from vil_tpu_torch.models.attention_efficient import LinformerAttention
from vil_tpu_torch.train import engine, loss, optim, redraw
from vil_tpu_torch.train.trainer import check_ported, run_experiment
from vil_tpu_torch.utils import jax_import

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_efficient import SR_CONV_TOL, _flax_tree, _scaled  # noqa: E402
from test_torch_resnet import _draw  # noqa: E402
from test_torch_split_options import TRAINER_OPTS  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "test_torch_mesh_models_worker.py")
WORLD = 4
SPAWN_TIMEOUT = 420  # seconds, the one spawn
HALO_TOL = 1e-12  # the halo layers in f64, of each value's scale
GRAD_REL = 1e-10  # the split f64 ResNet's gradients against one rank, of max|ref|
F32_REL = 1e-6  # its f32 logits, loss and running statistics, of max(1, max|ref|)
RESNET_TOL = 1e-5  # tests/test_torch_resnet.py's limit against vil_tpu, of max(1, max|ref|)
TOL = 1e-5  # the mesh tests' limit against the one-rank step
VIL_TOL = 1e-4  # tests/test_torch_efficient.py's limit of a whole model against vil_tpu
JAX_THREADS = 4  # vil_tpu's reference steps compiled at once

# ---------------------------------------------------------------- the ResNet
RESNET_IMG, RESNET_BATCH, CLASSES = 96, 4, 10
RESNETS = ("resnet18", "resnet50")
SPATIAL = {
    "spatial": ["TPU.MESH_AXES", "['data','spatial']", "TPU.MESH_SHAPE", "[2,2]"],
    "fsdp": ["TPU.MESH_AXES", "['data','spatial']", "TPU.MESH_SHAPE", "[2,2]",
             "TPU.PARAM_SHARDING", "fsdp"],
    "tp": ["TPU.MESH_AXES", "['data','spatial','model']", "TPU.MESH_SHAPE", "[1,2,2]",
           "TPU.PARAM_SHARDING", "tp"],
}
# mesh → (options, the spatial ranks, the ranks of a hand-built group or None)
RESNET_MESHES = {"d2": (SPATIAL["spatial"], 2, None), "d3": ([], 3, [0, 1, 2]),
                 "fsdp": (SPATIAL["fsdp"], 2, None), "tp": (SPATIAL["tp"], 2, None)}
RESNET_CASES = [f"{name}_{mesh}" for name in RESNETS for mesh in RESNET_MESHES]

# ----------------------------------------------------------------- families
ARCH = ("l1,h2,d16,n1,s1,g1,p4,f2_l2,h2,d32,n1,s1,g1,p2,f2_l3,h2,d32,n1,s0,g0,p2,f2"
        "_l4,h3,d48,n1,s0,g0,p1,f2")  # tests/test_torch_sharding.py's
IMG, BATCH = 32, 4
FAMILIES = {
    "linformer_kv": ["MODEL.VIT.MSVIT.ATTN_TYPE", "linformer", "MODEL.VIT.MSVIT.SHARE_KV", "True"],
    "linformer": ["MODEL.VIT.MSVIT.ATTN_TYPE", "linformer", "MODEL.VIT.MSVIT.SHARE_KV", "False"],
    "srformer": ["MODEL.VIT.MSVIT.ATTN_TYPE", "srformer"],
    "performer": ["MODEL.VIT.MSVIT.ATTN_TYPE", "performer"],
    "global": ["MODEL.VIT.MSVIT.ONLY_GLOBAL", "True"],
    "unshared": ["MODEL.VIT.MSVIT.SHARE_W", "False"],
}
TP_MESHES = {
    "dm": ["TPU.MESH_AXES", "['data','model']", "TPU.MESH_SHAPE", "[2,2]",
           "TPU.PARAM_SHARDING", "tp"],
    "dsm": SPATIAL["tp"],
}
FAMILY_CASES = [f"{family}_{mesh}" for family in FAMILIES for mesh in TP_MESHES]
REDRAW = 11  # the performer's redraw seed, on the mesh and on one rank

# ------------------------------------------------------------------ Trainer
TRAINER_RESNET = ["MODEL.ARCH", "resnet18", "INPUT.IMAGE_SIZE", "64"]
TRAINER_MESH = SPATIAL["spatial"]
# the steps held to TOL: a ResNet whose BatchNorms sum four ranks' partial
# statistics in f32 follows f32 rounding after the first step, which Adam's
# normalised updates amplify (tests/test_torch_split_options.py's EARLY)
EARLY = 1


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One CPU thread for torch in this module, as each spawned rank has."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfg(opts):
    from vil_tpu_torch.config import get_default_cfg

    cfg = get_default_cfg()
    cfg.merge_from_list(opts)
    return cfg


def _resnet_opts(name, *extra):
    return ["MODEL.ARCH", name, "INPUT.IMAGE_SIZE", str(RESNET_IMG), "DATA.NUM_CLASSES",
            str(CLASSES), "OPTIM.OPT", "adamw", "OPTIM.LR", "1e-2", *extra]


def _family_opts(family, *extra):
    return ["MODEL.VIT.MSVIT.ARCH", ARCH, "INPUT.IMAGE_SIZE", str(IMG), "DATA.NUM_CLASSES",
            str(CLASSES), "TPU.COMPUTE_DTYPE", "float32", "MODEL.VIT.DROP_PATH", "0.0",
            "MODEL.VIT.NORM_EMBED", "True", "OPTIM.OPT", "adamw", "OPTIM.LR", "1e-3",
            *FAMILIES[family], *extra]


def _resnet_model(name, dtype=torch.float64):
    return build_resnet(name, CLASSES, device="cpu", dtype=dtype, param_dtype=dtype,
                        img_size=RESNET_IMG)


def _resnet_weights(name):
    """``vil_tpu``'s narrow ResNet and its variables, drawn from a seed
    (``tests/test_torch_resnet.py``'s draw), and the port's f64 model
    carrying them."""
    jmodel = jax_build_resnet(name, CLASSES)
    shapes = jax.eval_shape(lambda: jmodel.init({"params": jax.random.PRNGKey(0)},
                                                jnp.zeros((1, RESNET_IMG, RESNET_IMG, 3))))
    variables = jax.tree_util.tree_map_with_path(_draw, dict(shapes))
    ours = jax_import.load_jax_params(_resnet_model(name), variables["params"],
                                      batch_stats=variables["batch_stats"])
    return variables, ours


def _vil_tpu_resnet_step(name, variables, images, targets):
    """``vil_tpu``'s one-device training forward and cross entropy in f64
    (JAX under ``enable_x64``): (loss, gradients under the port's names)."""
    with jax.enable_x64(True):
        jmodel = jax_build_resnet(name, CLASSES, dtype=jnp.float64, param_dtype=jnp.float64)
        f64 = lambda t: jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), t)
        params, stats = f64(variables["params"]), f64(variables["batch_stats"])

        def loss_fn(p):
            logits, _ = jmodel.apply({"params": p, "batch_stats": stats},
                                     jnp.asarray(images, jnp.float64), deterministic=False,
                                     mutable=["batch_stats"])
            return jax_loss.cross_entropy(logits, jnp.asarray(targets))

        value, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
        return float(value), {n: np.asarray(a, np.float64) for n, a in (
            jax_import._to_torch_leaf(k, np.asarray(v)) for k, v in jax_import._flatten(grads))}


def _family_model(family):
    """The port's one-rank model of ``family``, its weights from seed 0,
    the performer's projections redrawn from REDRAW."""
    model = build_model(_cfg(_family_opts(family)), device="cpu",
                        generator=torch.Generator().manual_seed(0))
    if family == "performer":
        redraw.redraw_projections(model, torch.Generator().manual_seed(REDRAW))
    return model


def _vil_tpu_family_step(family, model, images, targets):
    """``vil_tpu``'s one-device step of ``family`` (no Pallas) from the
    port's weights and buffers: (loss, gradients under the port's names)."""
    jcfg = jax_default_cfg()
    jcfg.merge_from_list(_family_opts(family))
    jmodel = jax_build_model(jcfg, use_pallas=False)
    x = jnp.asarray(images)
    shapes = jax.eval_shape(lambda: jmodel.init({"params": jax.random.PRNGKey(0)}, x[:1]))
    params = _flax_tree(dict(model.named_parameters()), shapes["params"])
    rest = {}
    if "buffers" in shapes:
        rest["buffers"] = _flax_tree(dict(model.named_buffers()), shapes["buffers"])

    def loss_fn(p):
        logits = jmodel.apply({"params": p, **rest}, x, deterministic=False, mode=0)
        return jax_loss.cross_entropy(logits, jnp.asarray(targets))

    value, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    return float(value), {n: a for n, a in (jax_import._to_torch_leaf(k, np.asarray(v))
                                            for k, v in jax_import._flatten(grads))}


def _one_rank_step(model, cfg, images, targets, dtype):
    """The port's step without a process group on the whole batch, seed 0:
    (loss, the training logits, gradients, running statistics, eval
    logits)."""
    seen = []
    model.register_forward_hook(lambda m, a, out: seen.append(out.detach()))
    step = engine.make_train_step(model, loss.cross_entropy, optim.get_opt(cfg, model),
                                  device="cpu", seed=0)
    value = step(torch.from_numpy(images).to(dtype), torch.from_numpy(targets))["loss"].item()
    grads = {n: p.grad.numpy() for n, p in model.named_parameters()}
    stats = {n: b.numpy().copy() for n, b in model.named_buffers() if "running" in n}
    with torch.no_grad():
        served = model.eval()(torch.from_numpy(images).to(dtype)).float().numpy()
    return value, seen[0].float().numpy(), grads, stats, served


def _launch(out_dir):
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1")
    return [subprocess.Popen([sys.executable, WORKER, str(out_dir), str(r), str(WORLD)],
                             env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                             text=True) for r in range(WORLD)]


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    """Writes the inputs and the weights, starts the one spawn, and while it
    runs computes what its cases are held to: the port's one-rank steps,
    ``vil_tpu``'s steps and the Trainer's run at world 1. Yields (refs,
    the spawn's directory, its processes)."""
    out = tmp_path_factory.mktemp("mesh_models")
    rng = np.random.default_rng(0)
    resnet_images = rng.standard_normal((RESNET_BATCH, RESNET_IMG, RESNET_IMG, 3))
    resnet_targets = rng.integers(0, CLASSES, RESNET_BATCH).astype(np.int64)
    images = rng.standard_normal((BATCH, IMG, IMG, 3)).astype(np.float32)
    targets = rng.integers(0, CLASSES, BATCH).astype(np.int64)
    np.savez(out / "resnet_inputs.npz", images=resnet_images, targets=resnet_targets)
    np.savez(out / "inputs.npz", images=images, targets=targets)
    variables, steps = {}, {}
    for name in RESNETS:
        variables[name], ours = _resnet_weights(name)
        torch.save(ours.state_dict(), out / f"{name}.pt")
        for mesh, (opts, _, ranks) in RESNET_MESHES.items():
            steps[f"{name}_{mesh}"] = dict(opts=_resnet_opts(name, *opts), weights=f"{name}.pt",
                                           dtype="float64", inputs="resnet_inputs.npz",
                                           ranks=ranks)
    for family in FAMILIES:
        torch.save(_family_model(family).state_dict(), out / f"{family}.pt")
        for mesh, opts in TP_MESHES.items():
            steps[f"{family}_{mesh}"] = dict(opts=_family_opts(family, *opts),
                                             weights=f"{family}.pt",
                                             redraw=REDRAW if family == "performer" else None)
    trainer_opts = TRAINER_OPTS + TRAINER_RESNET
    spec = {"steps": steps, "trainers": {"resnet_spatial": trainer_opts + TRAINER_MESH}}
    with open(out / "spec.json", "w") as f:
        json.dump(spec, f)
    procs = _launch(out)
    # vil_tpu's steps compile in threads (XLA compiles outside the GIL)
    # while this thread takes the port's one-rank steps
    pool = ThreadPoolExecutor(JAX_THREADS)
    try:
        jax_steps = {f"vil_tpu/{family}": pool.submit(
            _vil_tpu_family_step, family, _family_model(family), images, targets)
            for family in FAMILIES}
        jax_steps.update({f"vil_tpu/{name}": pool.submit(
            _vil_tpu_resnet_step, name, variables[name], resnet_images, resnet_targets)
            for name in RESNETS})
        refs = {}
        for name in RESNETS:
            model = _resnet_model(name)
            model.load_state_dict(torch.load(out / f"{name}.pt", weights_only=True))
            refs[name] = _one_rank_step(model, _cfg(_resnet_opts(name)), resnet_images,
                                        resnet_targets, torch.float64)
        for family in FAMILIES:
            model = _family_model(family)
            refs[family] = _one_rank_step(model, _cfg(_family_opts(family)), images, targets,
                                          torch.float32)
            refs[f"projection/{family}"] = {n: b.numpy() for n, b in model.named_buffers()
                                            if "projection_matrix" in n}
        refs["world1"] = run_experiment(_cfg(trainer_opts + [
            "OUTPUT_DIR", str(tmp_path_factory.mktemp("world1_resnet"))]), device="cpu")
        refs.update({key: step.result() for key, step in jax_steps.items()})
        yield refs, out, procs
    finally:
        pool.shutdown(cancel_futures=True)
        for p in procs:
            p.kill()


@pytest.fixture(scope="module")
def ranks(mesh_runs):
    """Each rank's results, once the spawn has ended; their files (a GiB a
    rank: every f64 ResNet-50 gradient) removed once read."""
    _, out, procs = mesh_runs
    outs = [p.communicate(timeout=SPAWN_TIMEOUT)[0] for p in procs]
    for r, (p, text) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and f"WORKER {r} DONE" in text, f"rank {r}:\n{text[-4000:]}"
    results = []
    for r in range(len(procs)):
        with np.load(out / f"rank{r}.npz") as f:
            results.append(dict(f))
        (out / f"rank{r}.npz").unlink()
    return results


def _grads(res, case):
    prefix = f"{case}/grad/"
    return {k[len(prefix):]: v for k, v in res.items() if k.startswith(prefix)}


def _rel(got, ref, floor=0.0) -> float:
    """max|got − ref| over max(floor, max|ref|)."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max(initial=0.0)
                 / max(floor, np.abs(ref).max(initial=0.0), 1e-300))


def _replicas(case) -> int:
    """The data replicas of a ResNet case's mesh: 2 on the (2, 2) meshes."""
    return 2 if case.endswith(("_d2", "_fsdp")) else 1


def _replica(batch, case, r):
    """Rank r's data replica's rows of ``batch`` (rank 2d + s of (2, 2))."""
    n = len(batch) // _replicas(case)
    d = r // 2 if _replicas(case) == 2 else 0
    return batch[d * n:(d + 1) * n]


def _in_case(case, r) -> bool:
    """Whether rank r takes part in the case (the D 3 group: ranks 0-2)."""
    return not case.endswith("_d3") or r < 3


# ---------------------------------------------------------------- the halos

@pytest.mark.parametrize("layer", ["conv7s2", "conv3s2", "conv3s1", "pool3s2"])
@pytest.mark.parametrize("size", [2, 3])
def test_halo_layer_matches_the_whole_image(ranks, size, layer):
    """Output rows, the input rows' gradient and the weight's gradient
    (summed over the ranks) to HALO_TOL of each one's scale; the image's
    top edge is padded on the first rank, the bottom edge on the last where
    the layer reads past it (the 7×7/2 by 1 row below: its last output
    reads rows 19..25 of 22), never in between."""
    k, s, p = {"conv7s2": (7, 2, 3), "conv3s2": (3, 2, 1), "conv3s1": (3, 1, 1),
               "pool3s2": (3, 2, 1)}[layer]
    last = ((22 + 2 * p - k) // s) * s - p + k - 22  # rows the last output reads past the end
    for r in range(size):
        key = f"halo/{size}/{layer}"
        errs, scale = ranks[r][key], ranks[r][f"{key}/scale"]
        assert (errs <= HALO_TOL * np.maximum(scale, 1.0)).all(), (r, errs, scale)
        top, bot = ranks[r][f"{key}/pad"]
        assert top == (p if r == 0 else 0), (r, top)
        assert bot == (max(last, 0) if r == size - 1 else 0), (r, bot)


# ---------------------------------------------------------------- the ResNet

@pytest.mark.parametrize("case", RESNET_CASES)
def test_resnet_split_step_matches_one_rank(mesh_runs, ranks, case):
    """f64: the loss and training logits to F32_REL, every gradient to
    GRAD_REL of its max|ref|, the running statistics to F32_REL, on every
    rank of the mesh."""
    one_loss, one_logits, one_grads, one_stats, _ = mesh_runs[0][case.split("_")[0]]
    for r, res in enumerate(ranks):
        if not _in_case(case, r):
            continue
        at = f"{case}, rank {r}"
        assert _rel(res[f"{case}/loss"], one_loss, 1.0) <= F32_REL, at
        assert _rel(res[f"{case}/logits"], _replica(one_logits, case, r), 1.0) <= F32_REL, at
        got = _grads(res, case)
        assert set(got) == set(one_grads), at
        for name, g in one_grads.items():
            assert _rel(got[name], g) <= GRAD_REL, f"{at}: grad {name} {_rel(got[name], g):.3e}"
        for name, s in one_stats.items():
            assert _rel(res[f"{case}/buffer/{name}"], s, 1.0) <= F32_REL, f"{at}: {name}"


@pytest.mark.parametrize("case", RESNET_CASES)
def test_resnet_split_step_matches_vil_tpu(mesh_runs, ranks, case):
    """The split step against ``vil_tpu``'s one-device f64 step: the loss
    and every gradient to RESNET_TOL of max(1, max|ref|)."""
    ref_loss, ref_grads = mesh_runs[0][f"vil_tpu/{case.split('_')[0]}"]
    for r, res in enumerate(ranks):
        if not _in_case(case, r):
            continue
        assert abs(float(res[f"{case}/loss"]) - ref_loss) <= RESNET_TOL, (case, r)
        got = _grads(res, case)
        assert set(got) == set(ref_grads), (case, r)
        for name, g in ref_grads.items():
            assert _rel(got[name], g, 1.0) <= RESNET_TOL, f"{case}, rank {r}: {name}"


@pytest.mark.parametrize("case", RESNET_CASES)
def test_resnet_eval_logits_equal_on_every_spatial_rank(mesh_runs, ranks, case):
    """The eval forward after the step (the updated running statistics) on
    each rank's rows: equal on every rank and to the one-rank model's
    eval logits after its step, to F32_REL."""
    served = mesh_runs[0][case.split("_")[0]][4]
    for r, res in enumerate(ranks):
        if not _in_case(case, r):
            continue
        assert _rel(res[f"{case}/eval"], _replica(served, case, r), 1.0) <= F32_REL, (case, r)
        first = ranks[r - r % 2 if _replicas(case) == 2 else 0]
        assert np.array_equal(res[f"{case}/eval"], first[f"{case}/eval"]), (case, r)


# ----------------------------------------------------------------- families

@pytest.mark.parametrize("case", FAMILY_CASES)
def test_family_under_tp_matches_one_rank(mesh_runs, ranks, case):
    """Loss and every gradient (gathered whole) to TOL of each gradient's
    max|ref| on every rank: (2, 2) data × model, a rank its model group's
    heads of its replica's images; (1, 2, 2), a rank its heads of the
    whole image (the families' first stage gathers the rows)."""
    family = case.rsplit("_", 1)[0]
    one_loss, _, one_grads, _, _ = mesh_runs[0][family]
    for r, res in enumerate(ranks):
        at = f"{case}, rank {r}"
        assert abs(float(res[f"{case}/loss"]) - one_loss) <= TOL, at
        got = _grads(res, case)
        assert set(got) == set(one_grads), at
        for name, g in one_grads.items():
            # the srformer's proj_sr sums cancelling terms after the model
            # group's sum of the keys' gradient (tests/test_torch_efficient.py)
            tol = SR_CONV_TOL["model"] if name.endswith("proj_sr.weight") else TOL
            if g.size:
                assert _rel(got[name], g) <= tol, f"{at}: grad {name} {_rel(got[name], g):.3e}"


@pytest.mark.parametrize("family", list(FAMILIES))
def test_family_one_rank_step_matches_vil_tpu(mesh_runs, family):
    """The one-rank step that the meshes are held to, against ``vil_tpu``'s
    from the same weights: loss and every gradient to VIL_TOL of max|ref|
    (the srformer's ``proj_sr`` to SR_CONV_TOL['model'])."""
    one_loss, _, one_grads, _, _ = mesh_runs[0][family]
    ref_loss, ref_grads = mesh_runs[0][f"vil_tpu/{family}"]
    assert abs(one_loss - ref_loss) <= VIL_TOL
    assert set(one_grads) == set(ref_grads)
    for name, g in one_grads.items():
        tol = SR_CONV_TOL["model"] if name.endswith("proj_sr.weight") else VIL_TOL
        if g.size:
            assert _scaled(g, ref_grads[name]) <= tol, name


@pytest.mark.parametrize("mesh", list(TP_MESHES))
def test_performer_redraw_is_the_same_on_every_rank(mesh_runs, ranks, mesh):
    """The redraw from one seed gives every rank of every replica the
    one-rank model's projections, bit for bit."""
    want = mesh_runs[0]["projection/performer"]
    assert want
    for r, res in enumerate(ranks):
        for name, p in want.items():
            assert np.array_equal(res[f"performer_{mesh}/buffer/{name}"], p), (mesh, r, name)


def test_linformer_projections_are_partial_over_the_model_group():
    """Split over a model axis, each rank's heads read the whole sequence
    projections, so each holds a part of their gradient; unsplit they are
    not partial, and the srformer's reduction is whole on every rank."""
    tp = parallel.TensorParallel(None, 2, 0)
    for family, partial in (("linformer", 2), ("linformer_kv", 1), ("srformer", 0)):
        model = build_model(_cfg(_family_opts(family, "TPU.PARAM_SHARDING", "tp")),
                            device="cpu", mesh=parallel.Mesh(model=tp))
        names = {id(p): n for n, p in model.named_parameters()}
        got = [names[id(p)] for p in model.partial_over_model()]
        assert len(got) == partial * 2 and all("proj_" in n for n in got), (family, got)
        mods = [m for m in model.modules() if isinstance(m, LinformerAttention)]
        assert all(m.num_heads == 1 for m in mods)
    assert build_model(_cfg(_family_opts("linformer")), device="cpu").partial_over_model() == []


# ------------------------------------------------------------------ Trainer

def test_resnet_trainer_on_a_spatial_axis_matches_world_1(mesh_runs, ranks):
    """ResNet-18 at 64² on ('data', 'spatial') (2, 2), the rows split 32/32:
    the first EARLY logged losses to TOL of the run at world 1, every one
    finite, on every rank."""
    world1 = [r["loss"] for r in mesh_runs[0]["world1"].steps_log]
    assert len(world1) == 8 and np.isfinite(world1).all()
    for r, res in enumerate(ranks):
        got = res["resnet_spatial/losses"]
        assert len(got) == 8 and np.isfinite(got).all(), r
        np.testing.assert_allclose(got[:EARLY], world1[:EARLY], rtol=0, atol=TOL,
                                   err_msg=f"rank {r}")


# ------------------------------------------------------- without a spawn

@pytest.mark.parametrize("mesh", list(SPATIAL))
@pytest.mark.parametrize("name", list(RESNET_ZOO))
def test_check_ported_accepts_every_resnet_on_a_spatial_axis(name, mesh):
    check_ported(_cfg(["MODEL.ARCH", name, *SPATIAL[mesh]]))


@pytest.mark.parametrize("name", list(RESNET_ZOO))
def test_build_model_splits_every_resnet_by_blocks_of_32_rows(name):
    """Built on a one-rank spatial mesh (no process group, on the meta
    device), every zoo name splits INPUT.IMAGE_SIZE 224 (7 blocks) 4/3 over
    2 ranks and refuses 8 ranks, naming the image and the blocks."""
    cfg = _cfg(["MODEL.ARCH", name, *SPATIAL["spatial"][:2], "TPU.MESH_SHAPE", "[1,1]"])
    model = build_model(cfg, device="meta", mesh=parallel.mesh_from_cfg(cfg))
    assert model.spatial_split(2).image == ((0, 128), (128, 224))
    with pytest.raises(ValueError, match="224 rows split into 7 blocks of 32"):
        model.spatial_split(8)


@pytest.mark.parametrize("mesh", list(TP_MESHES))
@pytest.mark.parametrize("family", list(FAMILIES))
def test_check_ported_and_build_model_accept_every_family_under_tp(family, mesh):
    """Without a process group the model axis is one rank; a model built as
    rank 0 of 2 holds its heads of every split layer."""
    cfg = _cfg(_family_opts(family, *TP_MESHES[mesh]))
    check_ported(cfg)
    model = build_model(cfg, device="cpu", mesh=parallel.Mesh(
        model=parallel.TensorParallel(None, 2, 0)))
    assert model.param_shards and all(s.size == 2 for s in model.param_shards.values())
