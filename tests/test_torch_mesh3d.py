"""Heads and rows split at once: the port's training step on a ('data',
'spatial', 'model') mesh under TPU.PARAM_SHARDING 'tp' and on a ('data',
'spatial') mesh under 'fsdp', against itself on one rank and against
``vil_tpu``, on the CPU.

One spawn of four gloo ranks (``tests/test_torch_mesh3d_worker.py``, a
``FileStore`` in a temporary directory, one CPU thread a rank) takes every
case on both meshes in turn: (1, 2, 2) under 'tp', each rank its model
group's head of every block (2 heads in every stage, split by 2) of its
spatial group's rows, and (2, 2) under 'fsdp', the parameters sliced over
the data axis and whole across the spatial one. The narrow model is
``tests/test_torch_spatial_train.py``'s (104², W 3, whose 5 blocks of 24
input rows split 3/2 over the spatial axis), in f32, batch 8, drop path 0,
no mixup, its weights ``vil_tpu``'s parameters drawn from a seed, loaded
into the port (``tests/test_torch_split_options.py``'s).

* The mesh's groups: on (1, 2, 2) the spatial group is the ranks of a
  rank's (data, model) index, the model group those of its (data, spatial)
  index, the gradients' group (``Mesh.param_group``) those of its model
  index and the replica all four.
* The step under 'tp' at MODE 0, at every mode 1..8 (a sign error in the
  halo row shows only at dx = ±1) and at mode −1, and the step under
  'fsdp' at MODE 0: loss and every gradient against the port's one-rank
  step at the same mode to 1e-5 of each gradient's max|ref| (the mesh
  tests' limit), and against ``vil_tpu``'s one-device step at the same mode
  to 1e-4.
* REMAT 'full' and 'minimal' on both meshes: bit for bit the same mesh's
  step without REMAT, on every rank; every rank issues the same collectives
  in the same order, the recompute re-issuing a block's halo exchanges,
  its global branch's reductions and under 'tp' its model group's
  all-reduces, and under 'fsdp' no gather (the recompute finds the weights
  gathered).
* DROP 0.1 on both meshes: every mask a rank draws is its part of the mask
  the one-rank step draws at the same site (under 'tp' the MLP's hidden
  mask is a rank's rows and columns at once), and the step equals the
  one-rank DROP step to 1e-5 of each gradient's max|ref|.
* The Trainer (``run_experiment``) at world 4 on each mesh (under 'tp'
  with DROP 0.1 and REMAT 'minimal', under 'fsdp' with REMAT 'full'):
  every logged loss to 1e-5 of the same run at world 1 in this process,
  the evals' top1 equal; the checkpoint the mesh wrote holds each rank's
  parameters bit for bit, and a Trainer of one rank resumes it at its
  epoch and step and evaluates it to the mesh's top1.
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

from vil_tpu_torch import parallel
from vil_tpu_torch.models import build_model
from vil_tpu_torch.models.layers import Part
from vil_tpu_torch.train import engine, loss, optim
from vil_tpu_torch.train.trainer import Trainer, run_experiment
from vil_tpu_torch.utils import jax_import

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_split_options import (  # noqa: E402
    ARCH, BATCH, IMG, TRAINER_OPTS, _cfg, _draw_flax_params, _grads, _hold, _masks, _opts)
from test_torch_split_options_worker import MaskLog  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "test_torch_mesh3d_worker.py")
WORLD = 4
SPAWN_TIMEOUT = 420  # seconds, the one spawn
TOL = 1e-5  # the mesh tests' limit against the one-rank step
VIL_TOL = 1e-4  # against vil_tpu's step (PERF.md §2)
MESHES = {
    "tp": ["TPU.MESH_AXES", "['data','spatial','model']", "TPU.MESH_SHAPE", "[1,2,2]",
           "TPU.PARAM_SHARDING", "tp"],
    "fsdp": ["TPU.MESH_AXES", "['data','spatial']", "TPU.MESH_SHAPE", "[2,2]",
             "TPU.PARAM_SHARDING", "fsdp"],
}
DROPPED = ["MODEL.VIT.DROP", "0.1"]
MODES = [0, *range(1, 9), -1]
# the steps: name → (mesh, REMAT, DROP, neighbour mode)
STEPS = {f"tp_mode{m}": ("tp", "", 0.0, m) for m in MODES}
STEPS["fsdp_mode0"] = ("fsdp", "", 0.0, 0)
STEPS.update({f"{mesh}_{remat}": (mesh, remat, 0.0, 0) for mesh in MESHES
              for remat in ("minimal", "full")})
STEPS.update({f"{mesh}_drop": (mesh, "", 0.1, 0) for mesh in MESHES})
PLAIN = {mesh: f"{mesh}_mode0" for mesh in MESHES}  # each mesh's step without REMAT
# the Trainer's runs on each mesh: name → (options but the mesh's, the world-1 run it equals)
TRAINER_RUNS = {
    "tp": (DROPPED + ["TPU.REMAT", "minimal"], "drop"),
    "fsdp": (["TPU.REMAT", "full"], "plain"),
}
WORLD1 = {"plain": [], "drop": DROPPED}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One CPU thread for torch in this module, as each spawned rank has."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _case_opts(mesh, remat, drop):
    return _opts("TPU.REMAT", remat, "MODEL.VIT.DROP", str(drop), *MESHES[mesh])


def _one_rank_step(opts, weights, images, targets, mode, replica=None):
    """The port's step without a process group at ``mode``, seed 0: on the
    whole batch with the draws of data replica 0, or with ``replica`` = (d,
    D) on replica d's share of the batch with its draws. (loss, gradients,
    the masks drawn)."""
    model = build_model(_cfg(opts), device="cpu")
    model.load_state_dict(torch.load(weights, weights_only=True))
    mesh = None
    if replica is not None:
        d, size = replica
        n = len(images) // size
        images, targets = images[d * n:(d + 1) * n], targets[d * n:(d + 1) * n]
        mesh = parallel.Mesh(size, d)
    step = engine.make_train_step(model, loss.cross_entropy, optim.get_opt(_cfg(opts), model),
                                  device="cpu", seed=0, mesh=mesh)
    with MaskLog() as drawn:
        value = step(torch.from_numpy(images), torch.from_numpy(targets), modes=mode)["loss"]
    return value.item(), {n: p.grad.numpy() for n, p in model.named_parameters()}, drawn.masks


def _vil_tpu_steps(params, images, targets) -> dict:
    """``vil_tpu``'s one-device step in training at each of ``MODES``: mode
    → (loss, gradients under the port's names). Modes 0 and −1 are static;
    1..8 reach one compiled function as a traced per-block vector, as random
    shift runs them."""
    jcfg = jax_default_cfg()
    jcfg.merge_from_list(_opts())
    jmodel = jax_build_model(jcfg, use_pallas=False)
    x, y = jnp.asarray(images), jnp.asarray(targets)

    def grads_at(mode):
        def loss_fn(p):
            logits = jmodel.apply({"params": p}, x, deterministic=False, mode=mode)
            return jax_loss.cross_entropy(logits, y)
        return jax.value_and_grad(loss_fn)

    static = {m: jax.jit(grads_at(m)) for m in (0, -1)}
    traced = jax.jit(lambda p, modes: grads_at(modes)(p))
    depth = len(ARCH.split("_"))
    out = {}
    for m in MODES:
        value, grads = (static[m](params) if m in static else
                        traced(params, jnp.full((depth,), m, jnp.int32)))
        out[m] = float(value), {n: a for n, a in (jax_import._to_torch_leaf(k, np.asarray(v))
                                                 for k, v in jax_import._flatten(grads))}
    return out


def _launch(out_dir):
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1")
    return [subprocess.Popen([sys.executable, WORKER, str(out_dir), str(r), str(WORLD)],
                             env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                             text=True) for r in range(WORLD)]


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    """Writes the inputs and the weights, starts the one spawn, and while it
    runs computes what its cases are held to: the port's one-rank steps at
    every mode and with dropout (its masks recorded), ``vil_tpu``'s steps
    and the Trainer's runs at world 1. Yields (refs, the spawn's directory,
    its processes)."""
    out = tmp_path_factory.mktemp("mesh3d")
    rng = np.random.default_rng(0)
    images = rng.standard_normal((BATCH, IMG, IMG, 3)).astype(np.float32)
    targets = rng.integers(0, 10, BATCH).astype(np.int64)
    np.savez(out / "inputs.npz", images=images, targets=targets)
    params = _draw_flax_params(images, 1)
    torch.save(jax_import.load_jax_params(build_model(_cfg(_opts()), device="cpu"),
                                          params).state_dict(), out / "vil.pt")
    steps = {case: dict(opts=_case_opts(mesh, remat, drop), weights="vil.pt", modes=mode)
             for case, (mesh, remat, drop, mode) in STEPS.items()}
    spec = {"groups": MESHES["tp"], "steps": steps,
            "trainers": {name: TRAINER_OPTS + opts + MESHES[name]
                         for name, (opts, _) in TRAINER_RUNS.items()}}
    with open(out / "spec.json", "w") as f:
        json.dump(spec, f)
    procs = _launch(out)
    try:
        refs = {f"one/{m}": _one_rank_step(_opts(), out / "vil.pt", images, targets, m)
                for m in MODES}
        refs["one/drop"] = _one_rank_step(_opts(*DROPPED), out / "vil.pt", images, targets, 0)
        # under 'fsdp' each of the two data replicas draws its own masks
        for d in range(2):
            refs[f"one/drop/{d}"] = _one_rank_step(_opts(*DROPPED), out / "vil.pt", images,
                                                   targets, 0, (d, 2))
        refs["vil_tpu"] = _vil_tpu_steps(params, images, targets)
        for name, extra in WORLD1.items():
            refs[f"world1/{name}"] = run_experiment(_cfg(TRAINER_OPTS + extra + [
                "OUTPUT_DIR", str(tmp_path_factory.mktemp(f"world1_{name}"))]), device="cpu")
        yield refs, out, procs
    finally:
        for p in procs:
            p.kill()


@pytest.fixture(scope="module")
def ranks(mesh_runs):
    """Each rank's results, once the spawn has ended."""
    _, out, procs = mesh_runs
    outs = [p.communicate(timeout=SPAWN_TIMEOUT)[0] for p in procs]
    for r, (p, text) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and f"WORKER {r} DONE" in text, f"rank {r}:\n{text[-4000:]}"
    return [dict(np.load(out / f"rank{r}.npz")) for r in range(len(procs))]


def test_the_groups_of_a_three_axis_mesh(ranks):
    """(1, 2, 2), ranks numbered (data, spatial, model) row-major: rank
    2s + m is spatial rank s, model rank m."""
    for r, res in enumerate(ranks):
        groups = json.loads(str(res["groups"]))
        s, m = divmod(r, 2)
        assert groups["spatial"] == [m, 2 + m], r
        assert groups["model"] == [2 * s, 2 * s + 1], r
        assert groups["data"] == [r], r
        assert groups["param"] == [m, 2 + m], r
        assert groups["replica"] == [0, 1, 2, 3] and groups["data_rank"] == 0, r


@pytest.mark.parametrize("case", [c for c, (_, remat, drop, _) in STEPS.items()
                                  if not remat and not drop])
def test_step_matches_one_rank_and_vil_tpu(mesh_runs, ranks, case):
    """Against the port's one-rank step at the mesh tests' limit, and
    against ``vil_tpu``'s one-device step at 1e-4, at the case's mode."""
    refs = mesh_runs[0]
    mode = STEPS[case][3]
    one_loss, one_grads, _ = refs[f"one/{mode}"]
    vil_loss, vil_grads = refs["vil_tpu"][mode]
    for r, res in enumerate(ranks):
        at = f"{case}, rank {r}"
        got = _grads(res, case)
        assert abs(float(res[f"{case}/loss"]) - one_loss) <= TOL, at
        _hold(got, one_grads, TOL, at)
        assert abs(float(res[f"{case}/loss"]) - vil_loss) <= VIL_TOL, at
        _hold(got, vil_grads, VIL_TOL, f"{at} vs vil_tpu")


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("remat", ["minimal", "full"])
def test_remat_equals_the_same_mesh_without(ranks, mesh, remat):
    """Bit for bit, on every rank: the recompute redoes the same operations
    on the same values, its collectives included."""
    for r, res in enumerate(ranks):
        base, got = _grads(res, PLAIN[mesh]), _grads(res, f"{mesh}_{remat}")
        assert res[f"{mesh}_{remat}/loss"] == res[f"{PLAIN[mesh]}/loss"], (mesh, remat, r)
        assert set(got) == set(base)
        for name, g in base.items():
            assert np.array_equal(got[name], g), f"{mesh} {remat} rank {r}: {name}"


@pytest.mark.parametrize("mesh", list(MESHES))
def test_collectives_in_one_order_on_every_rank(ranks, mesh):
    """Each rank issues the same collectives in the same order, with REMAT
    and without, at every mode, and the ranks that hold the same rows of
    the same sizes (a model group's all-reduce of a row-parallel output
    carries its spatial rank's rows, 6 or 3 chunk rows at stage 1). Under
    'tp' the recompute re-issues the halo exchanges and the all-reduces (the
    global branch's over the spatial group, the row-parallel outputs' over
    the model group; 'minimal' as 'full'); under 'fsdp' it re-issues the
    spatial block's halo exchanges and reductions, and neither FSDP's
    gathers nor its one reduce-scatter."""
    cases = [c for c, how in STEPS.items() if how[0] == mesh]
    # the first rank of a rank's spatial index: rank 2s + m on (1, 2, 2), 2d + s on (2, 2)
    first = (lambda r: r - r % 2) if mesh == "tp" else (lambda r: r % 2)
    for case in cases:
        logs = [json.loads(str(res[f"{case}/collectives"])) for res in ranks]
        assert all([n for n, _ in log] == [n for n, _ in logs[0]] for log in logs), case
        for r, log in enumerate(logs):
            assert log == logs[first(r)], (case, r)
    log = {c: json.loads(str(ranks[0][f"{c}/collectives"])) for c in cases}
    plain, minimal, full = log[PLAIN[mesh]], log[f"{mesh}_minimal"], log[f"{mesh}_full"]
    assert minimal == full
    count = lambda entries, name: sum(n == name for n, _ in entries)
    grown = {n for n, _ in full if count(full, n) > count(plain, n)}
    assert grown == {"batch_isend_irecv", "all_reduce"}
    if mesh == "fsdp":
        for name in ("all_gather_into_tensor", "reduce_scatter_tensor"):
            assert count(full, name) == count(plain, name) > 0, name
        assert count(plain, "reduce_scatter_tensor") == 1
    else:
        assert count(log["tp_mode-1"], "batch_isend_irecv") == 0  # no halo at mode -1


def _drop_reference(refs, mesh, rank):
    """The one-rank DROP step a rank's masks are parts of: the whole
    batch's under 'tp' (one data replica), its data replica's under 'fsdp'
    (rank 2d + s of the (2, 2) mesh)."""
    return refs["one/drop"] if mesh == "tp" else refs[f"one/drop/{rank // 2}"]


@pytest.mark.parametrize("mesh", list(MESHES))
def test_each_rank_draws_its_part_of_the_one_rank_masks(mesh_runs, ranks, mesh):
    """Every mask a rank draws is its part of the one-rank step's mask at
    the same site, in the same order (under 'fsdp' the one-rank step of its
    data replica, on the replica's images with the replica's draws); some
    are parts of rows and hidden columns at once under 'tp'."""
    case = f"{mesh}_drop"
    for r, res in enumerate(ranks):
        one = _drop_reference(mesh_runs[0], mesh, r)[2]
        masks = _masks(res, case)
        cuts = json.loads(str(res[f"{case}/cuts"]))
        assert len(masks) == len(one), (case, r)
        for i, (mine, whole, cut) in enumerate(zip(masks, one, cuts)):
            part = Part(tuple((d_, t, tuple(tuple(s) for s in spans)) for d_, t, spans in cut))
            assert np.array_equal(mine, part.of(torch.from_numpy(whole)).numpy()), \
                f"{case} rank {r}: mask {i} ({cut})"
        if mesh == "tp":
            assert any({c[0] for c in cut} == {1, -1} for cut in cuts), (case, r)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_dropout_step_matches_one_rank(mesh_runs, ranks, mesh):
    """Against the one-rank DROP step: under 'fsdp' the mean of its two
    data replicas' steps (the loss, each gradient)."""
    refs, case = mesh_runs[0], f"{mesh}_drop"
    parts = [_drop_reference(refs, mesh, r) for r in ((0,) if mesh == "tp" else (0, 2))]
    one_loss = float(np.mean([p[0] for p in parts]))
    one_grads = {n: np.mean([p[1][n] for p in parts], axis=0) for n in parts[0][1]}
    for r, res in enumerate(ranks):
        at = f"{case}, rank {r}"
        assert abs(float(res[f"{case}/loss"]) - one_loss) <= TOL, at
        _hold(_grads(res, case), one_grads, TOL, at)


@pytest.mark.parametrize("name", list(TRAINER_RUNS))
def test_trainer_at_world_4_matches_world_1(mesh_runs, ranks, name):
    world1 = mesh_runs[0][f"world1/{TRAINER_RUNS[name][1]}"]
    losses = [r["loss"] for r in world1.steps_log]
    assert len(losses) == 8 and all(np.isfinite(losses))
    for r, res in enumerate(ranks):
        np.testing.assert_allclose(res[f"{name}/losses"], losses, rtol=0, atol=TOL,
                                   err_msg=f"{name}, rank {r}")
        assert list(res[f"{name}/top1"]) == [e["top1"] for e in world1.evals], (name, r)


@pytest.mark.parametrize("name", list(TRAINER_RUNS))
def test_mesh_checkpoint_resumes_on_one_rank(mesh_runs, ranks, name):
    """The checkpoint the mesh wrote (rank 0, gathered) holds every rank's
    parameters, and one rank resumes it: at the run's epoch and step, with
    the mesh's top1."""
    out = mesh_runs[1]
    assert all(bool(res[f"{name}/checkpoint_is_the_mesh"]) for res in ranks), name
    opts, _ = TRAINER_RUNS[name]
    trainer = Trainer(_cfg(TRAINER_OPTS + opts + ["OUTPUT_DIR", str(out / name)]), device="cpu")
    assert (trainer.start_epoch, trainer.train_step.step) == (1, 8)
    top1 = trainer.validate(trainer.testloaders[0])
    assert top1 == float(ranks[0][f"{name}/top1"][-1]), name


def test_a_data_and_model_mesh_sums_over_its_data_group():
    """A ``Mesh`` built by hand on data and model axes takes its data group
    as the group its gradients are summed over, as ``mesh_from_cfg``'s
    does: every rank of the world would sum the model ranks' whole copies
    of the replicated parameters. Beside a spatial axis the group is given
    (``mesh_from_cfg``: the data × spatial ranks)."""
    data_group = object()
    tp = parallel.TensorParallel(None, 3, 0)
    assert parallel.Mesh(2, 0, model=tp, data_group=data_group).param_group is data_group
    spatial = parallel.SpatialContext(None, 2, 0)
    assert parallel.Mesh(2, 0, spatial=spatial).param_group is None
    assert parallel.Mesh(2, 0, spatial=spatial, model=tp, data_group=data_group).param_group is None
