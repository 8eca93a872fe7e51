"""The port's spatial (chunk-row) parallelism against ``vil_tpu`` on the CPU.

Shapes are those of ``tests/test_spatial.py``: B 2, MX 8, MY 4, W 3, H 2,
M 8, Nglo 1, f32, inputs from ``np.random.default_rng``.

* The halo-input kernels' plain versions (B7a, B7b on the CPU) on every
  shard of a split into shards of one and of two chunk rows, against
  ``_xla_reference_ext_mh`` and its ``jax.vjp``, and against the Pallas halo
  kernels ``_pallas_forward_halo`` / ``backward_whole_image_halo`` in
  interpret mode (fed ``spatial.halo_tables``); the shards together equal the
  unsharded sliding-chunk attention and its gradients.
* Spawned gloo groups (``tests/test_torch_spatial_worker.py``, one spawn per
  scenario, each with a ``FileStore`` in ``tmp_path`` and a timeout of its
  own): world 1, 2 and 4 split over space only, and world 4 as a
  (data 2, spatial 2) mesh. At world 1 the halos and their gradients still
  go through the exchange's autograd Function. Each rank's shards, put
  together, must match ``jax.shard_map`` of ``vil_tpu.parallel.spatial`` on
  the 8 CPU devices and the unsharded oracles (the gradients of what every
  rank of a replica holds alike, summed over its ranks: each holds a part): the cyclic halos, the plain
  local attention at modes 0, −1 and 3 and its gradients, the global
  branch's values and gradients (and, with no context, its unsplit values
  whatever group exists), the halo-kernel path's values and gradients (halo rows'
  gradients returned to their owners), and ``spatial_forward`` of a narrow
  model (weights through ``utils/jax_import.load_jax_params``) against JAX's
  unsharded ``model.apply`` and the port's own unsharded forward.
* The layout probe P's plain version: both schemes give the same result.

Tolerances: 2e-5 for values and 5e-5 for gradients of the plain tier, as
``tests/test_spatial.py`` has them; 2e-4 for logits (the repo's parity
tolerance for whole models).
"""
import functools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

from vil_tpu.models.msvit import MsViT as JaxMsViT
from vil_tpu.ops.pallas import vil_backward as jax_vil_backward
from vil_tpu.ops.pallas import vil_kernel as jax_vil_kernel
from vil_tpu.parallel import spatial as jax_spatial

from vil_tpu_torch import parallel
from vil_tpu_torch.models import MsViT
from vil_tpu_torch.ops import masks
from vil_tpu_torch.ops.kernels import (
    KERNELS,
    mask_to_additive,
    vil_attention_bwd_reference,
    vil_attention_halo_bwd,
    vil_attention_halo_fwd,
    vil_attention_reference,
)
from vil_tpu_torch.tools import layout_probe
from vil_tpu_torch.utils.jax_import import load_jax_params

B, MX, MY, W, H, M, NGLO = 2, 8, 4, 3, 2, 8, 1
W2, C = W * W, H * M
VAL_TOL, GRAD_TOL, LOGITS_TOL = 2e-5, 5e-5, 2e-4
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "test_torch_spatial_worker.py")
SPAWN_TIMEOUT = 240  # seconds, per scenario
# narrow model at 64²: stage 1 has 8 chunk rows of 2, stage 2 has 4, then a
# dense stage; splits over 1, 2 or 4 ranks
ARCH = "l1,h2,d16,n1,s1,g1,p4,f2_l2,h2,d32,n2,s1,g1,p2,f2_l3,h2,d32,n1,s0,g1,p2,f2"
IMG = 64


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One CPU thread for torch in this module: the test runner's workers
    share the cores, and torch's own threads, one a core in each worker,
    spin against each other."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rng(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _mask(mode):
    """The whole grid's additive mask of ``mode``, (MX, MY, 1, Nglo+K·W²)."""
    return mask_to_additive(masks.invalid_mask(MX, MY, 0, 0, W, 0, mode), MX, MY, W2, NGLO)


def _inputs(seed=0):
    q, k, v, g = (_rng(seed + i, B, MX, MY, W2, C, scale=0.5) for i in range(4))
    kg, vg = _rng(seed + 4, B, NGLO, C, scale=0.5), _rng(seed + 5, B, NGLO, C, scale=0.5)
    bias = _rng(seed + 6, H, W2, NGLO + 9 * W2, scale=0.15)
    return q, k, v, kg, vg, bias, g


def _ext(t, s, mxs):
    """Shard ``s`` of ``mxs`` rows of the whole (B, MX, …) tensor, with the
    cyclic halo rows above and below: (B, mxs + 2, …)."""
    idx = [(s * mxs - 1) % MX, *range(s * mxs, (s + 1) * mxs), ((s + 1) * mxs) % MX]
    return np.ascontiguousarray(t[:, idx])


def _t(a):
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a))


def _close(ours, ref, tol, what=""):
    np.testing.assert_allclose(np.asarray(ours), np.asarray(ref), atol=tol, rtol=tol,
                               err_msg=what)


# ------------------------------------------------------- halo kernels (B7)

@jax.jit
def _xla_ext_vjp(ops, rows, g):
    """``_xla_reference_ext_mh`` on ``ops`` = (q, k_ext, v_ext, k_glo, v_glo,
    bias; None where absent) and its gradients against ``g``."""
    out, vjp = jax.vjp(lambda *a: jax_vil_kernel._xla_reference_ext_mh(*a, rows, H), *ops)
    return out, vjp(g)


@pytest.mark.parametrize("mxs", [1, 2])
@pytest.mark.parametrize("nglo,with_bias", [(1, True), (0, False)])
def test_halo_reference_matches_xla_ext_reference(mxs, nglo, with_bias):
    """Every shard: the plain forward and backward against
    ``_xla_reference_ext_mh`` and its ``jax.vjp``; the shards' outputs
    together equal the unsharded sliding-chunk attention, and their dk_ext,
    dv_ext folded onto the owner rows equal its dk, dv."""
    q, k, v, kg, vg, bias, g = _inputs(1)
    if not nglo:
        kg = vg = None
    if not with_bias:
        bias = None
    mask = mask_to_additive(masks.invalid_mask(MX, MY, 0, 0, W, 0, 0), MX, MY, W2, nglo)
    outs, dk_fold, dv_fold = [], np.zeros_like(k), np.zeros_like(v)
    dq_all, glo_grads = [], []
    for s in range(MX // mxs):
        sl = slice(s * mxs, (s + 1) * mxs)
        ops = (q[:, sl], _ext(k, s, mxs), _ext(v, s, mxs), kg, vg, bias)
        rows, gs = mask[sl], np.ascontiguousarray(g[:, sl])
        out = vil_attention_halo_fwd(*map(_t, ops), _t(rows), H)
        lse = torch.zeros(B, H, mxs, MY, W2)  # the plain backward recomputes it
        grads = vil_attention_halo_bwd(*map(_t, ops), _t(gs), out, _t(rows), lse, H)
        ref, ref_grads = _xla_ext_vjp(ops, rows, gs)
        _close(out.numpy(), ref, VAL_TOL, f"out, shard {s}")
        for name, ours, r in zip(("dq", "dk_ext", "dv_ext", "dkg", "dvg", "dbias"), grads,
                                 ref_grads):
            assert (ours is None) == (r is None), name
            if r is not None:
                _close(ours.numpy(), r, GRAD_TOL, f"{name}, shard {s}")
        outs.append(out.numpy())
        dq_all.append(grads[0].numpy())
        glo_grads.append([None if t is None else t.numpy() for t in grads[3:]])
        # the halo rows' gradients belong to the neighbours' rows
        idx = [(s * mxs - 1) % MX, *range(s * mxs, (s + 1) * mxs), ((s + 1) * mxs) % MX]
        for e, row in enumerate(idx):
            dk_fold[:, row] += grads[1].numpy()[:, e]
            dv_fold[:, row] += grads[2].numpy()[:, e]
    whole = list(map(_t, (q, k, v, kg, vg, bias)))
    _close(np.concatenate(outs, 1), vil_attention_reference(*whole, _t(mask), H), VAL_TOL,
           "shards vs the whole image")
    ref = vil_attention_bwd_reference(*whole, _t(g), _t(mask), H)
    _close(np.concatenate(dq_all, 1), ref[0], GRAD_TOL, "dq")
    _close(dk_fold, ref[1], GRAD_TOL, "dk folded")
    _close(dv_fold, ref[2], GRAD_TOL, "dv folded")
    for i, r in enumerate(ref[3:]):  # dk_glo, dv_glo, dbias: sums over the shards
        if r is not None:
            _close(sum(gg[i] for gg in glo_grads), r, GRAD_TOL, f"global grad {i}")


@functools.lru_cache(maxsize=None)
def _pallas_halo():
    """The Pallas halo forward and backward in interpret mode, jitted once,
    and the whole grid's row classes: the class table is a trace-time
    constant, a shard's row classes are traced."""
    classes, row_class = jax_spatial.halo_tables(_mask(0), NGLO)
    fwd = jax.jit(lambda q, k, v, kg, vg, bias, rc: jax_vil_kernel._pallas_forward_halo(
        q, k, v, kg, vg, bias, classes, rc, H, interpret=True))
    bwd = jax.jit(lambda q, k, v, kg, vg, bias, g, rc: jax_vil_backward.backward_whole_image_halo(
        q, k, v, kg, vg, bias, g, classes, rc, H, interpret=True))
    return fwd, bwd, row_class


@pytest.mark.parametrize("shard", range(MX // 2))
def test_halo_plain_versions_match_pallas_interpret(shard):
    """Shard ``shard`` of an mxs = 2 split: the plain forward and backward
    (the wrappers on CPU tensors) against the TPU halo kernels in interpret
    mode, which take the whole grid's mask classes and this shard's row
    classes (``spatial.halo_tables``)."""
    q, k, v, kg, vg, bias, g = _inputs(2)
    mask, mxs = _mask(0), 2
    fwd, bwd, row_class = _pallas_halo()
    sl = slice(shard * mxs, (shard + 1) * mxs)
    ops = (q[:, sl], _ext(k, shard, mxs), _ext(v, shard, mxs), kg, vg, bias)
    gs, rc = np.ascontiguousarray(g[:, sl]), jnp.asarray(row_class[sl])
    out = vil_attention_halo_fwd(*map(_t, ops), _t(mask[sl]), H)
    _close(out.numpy(), fwd(*map(jnp.asarray, ops), rc), VAL_TOL, "out")
    grads = vil_attention_halo_bwd(*map(_t, ops), _t(gs), out, _t(mask[sl]),
                                   torch.zeros(B, H, mxs, MY, W2), H)
    refs = bwd(*map(jnp.asarray, ops), jnp.asarray(gs), rc)
    for name, ours, ref in zip(("dq", "dk_ext", "dv_ext", "dkg", "dvg", "dbias"), grads, refs):
        _close(ours.numpy(), ref, GRAD_TOL, name)
    assert [fn.launches for fn in KERNELS] == [0] * len(KERNELS)


# -------------------------------------------------- spawned process groups

def _jax_mesh():
    return Mesh(np.asarray(jax.devices()[:8]).reshape(2, 4), ("data", "spatial"))


def _shard_map_local(mode):
    d5 = P("data", "spatial")
    return jax.shard_map(
        lambda q, k, v, kg, vg, bias, mask: jax_spatial.spatial_local_attention(
            q, k, v, kg, vg, bias, mask, H, "spatial", mode),
        mesh=_jax_mesh(), in_specs=(d5, d5, d5, P("data"), P("data"), P(), P("spatial")),
        out_specs=d5)


def _jax_global_branch(qg, k_img, v_img, kg, vg, g2g, g2l0):
    d5 = P("data", "spatial")
    return jax.shard_map(
        lambda qg, ki, vi, kg, vg, g2g, g2l0: jax_spatial.spatial_global_branch(
            qg, ki, vi, kg, vg, g2g, g2l0, None, "spatial"),
        mesh=_jax_mesh(),
        in_specs=(P("data"), d5, d5, P("data"), P("data"), P(), P()),
        out_specs=P("data"))(qg, k_img, v_img, kg, vg, g2g, g2l0)


@pytest.fixture(scope="module")
def spatial_case(tmp_path_factory):
    """The inputs every scenario shares, written for the workers, and the
    JAX results they are held to."""
    out_dir = tmp_path_factory.mktemp("spatial_inputs")
    q, k, v, kg, vg, bias, _ = _inputs(3)
    inputs = dict(q=q, k=k, v=v, kg=kg, vg=vg, H=np.asarray(H), img=np.asarray(IMG),
                  arange=np.arange(B * MX * MY * W2 * C, dtype=np.float32).reshape(
                      B, MX, MY, W2, C),
                  arch=np.frombuffer(ARCH.encode(), np.uint8))
    refs = {}
    for mode in (0, -1, 3):
        span = {0: 9, -1: 1}.get(mode, 2)
        inputs[f"mask{mode}"] = _mask(mode)
        inputs[f"bias{mode}"] = np.ascontiguousarray(bias[..., :NGLO + span * W2])
        refs[f"local{mode}"] = np.asarray(jax.jit(_shard_map_local(mode))(
            q, k, v, kg, vg, inputs[f"bias{mode}"], inputs[f"mask{mode}"]))
        if mode == 0:  # the unsharded oracle too
            _close(refs["local0"], vil_attention_reference(
                *map(_t, (q, k, v, kg, vg, bias, inputs["mask0"])), H), VAL_TOL)

    def loss_sharded(q, k, v):
        return jnp.sum(_shard_map_local(0)(q, k, v, kg, vg, bias, inputs["mask0"]) ** 2)

    def loss_whole(q, k, v, kg, vg, bias):
        return jnp.sum(jax_vil_kernel._xla_reference_mh(q, k, v, kg, vg, bias,
                                                        inputs["mask0"], H) ** 2)

    refs["local_sharded_grads"] = jax.jit(jax.grad(loss_sharded, argnums=(0, 1, 2)))(q, k, v)
    refs["local_out"] = jax_vil_kernel._xla_reference_mh(q, k, v, kg, vg, bias, inputs["mask0"],
                                                         H)
    refs["local_grads"] = jax.jit(jax.grad(loss_whole, argnums=tuple(range(6))))(
        q, k, v, kg, vg, bias)

    glo = dict(qg=_rng(20, B, H, NGLO, M, scale=0.5), k_img=_rng(21, B, MX, MY, W2, C, scale=0.5),
               v_img=_rng(22, B, MX, MY, W2, C, scale=0.5), kg_g=_rng(23, B, NGLO, C, scale=0.5),
               vg_g=_rng(24, B, NGLO, C, scale=0.5), g2g=_rng(25, H, NGLO, NGLO, scale=0.15),
               g2l0=_rng(26, H, NGLO, scale=0.15))
    inputs.update(glo)
    glo_args = [glo[n] for n in ("qg", "k_img", "v_img", "kg_g", "vg_g", "g2g", "g2l0")]
    refs["glo_out"] = jax.jit(_jax_global_branch)(*glo_args)
    refs["glo_grads"] = jax.jit(jax.grad(lambda *a: jnp.sum(_jax_global_branch(*a) ** 2),
                                         argnums=tuple(range(7))))(*glo_args)

    common = dict(arch=ARCH, img_size=IMG, num_classes=10, attn_type="longformerhand",
                  sharew=True, norm_embed=True)
    images = _rng(30, B, IMG, IMG, 3)
    jax_model = JaxMsViT(**common)
    # seeded weights in the flax tree's shapes (eval_shape: no initialisation
    # to compile), LayerNorm scales near 1
    shapes = jax.eval_shape(lambda: jax_model.init({"params": jax.random.PRNGKey(0)},
                                                   jnp.asarray(images)))["params"]
    rng = np.random.default_rng(32)
    params = jax.tree_util.tree_map_with_path(
        lambda path, sds: (float(path[-1].key == "scale")
                           + 0.05 * rng.standard_normal(sds.shape)).astype(np.float32),
        shapes)
    refs["logits"] = np.asarray(jax.jit(jax_model.apply)({"params": params},
                                                         jnp.asarray(images)))
    model = load_jax_params(MsViT(device="cpu", **common), params).eval()
    with torch.inference_mode():
        refs["logits_port"] = model(_t(images)).numpy()
    torch.save(model.state_dict(), out_dir / "model.pt")
    inputs["images"] = images
    np.savez(out_dir / "inputs.npz", **inputs)
    return out_dir, inputs, refs


def _spawn(case_dir, tmp_path, world, spatial):
    """Run the worker on ``world`` ranks; returns each rank's results."""
    for name in ("inputs.npz", "model.pt"):
        os.symlink(case_dir / name, tmp_path / name)
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, WORKER, str(tmp_path), str(r), str(world),
                               str(spatial)], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(world)]
    try:
        outs = [p.communicate(timeout=SPAWN_TIMEOUT)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and f"WORKER {r} DONE" in out, f"rank {r}:\n{out[-4000:]}"
    return [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(world)]


def _assemble(results, key, world, spatial):
    """The whole (B, MX, …) array from every rank's (batch, rows) block."""
    n_data = world // spatial
    data_blocks = []
    for d in range(n_data):
        ranks = sorted((r for r in results if int(r["data"]) == d),
                       key=lambda r: int(r["spatial_rank"]))
        data_blocks.append(np.concatenate([r[key] for r in ranks], axis=1))
    return np.concatenate(data_blocks, axis=0)


def _partial(results, key, world, spatial, over_data=False):
    """A gradient of a value every rank of a data replica holds alike, of
    which each rank holds a part (``parallel/spatial.py``): the parts summed
    over the replica's ranks, the replicas' along the batch, or summed over
    them too (``over_data``: parameters shared by the batch)."""
    blocks = [sum(r[key] for r in results if int(r["data"]) == d)
              for d in range(world // spatial)]
    return sum(blocks) if over_data else np.concatenate(blocks, axis=0)


def _batch(results, key, world, spatial, summed=False):
    """A value each rank holds whole for its data replica: the replicas'
    values along the batch, or summed over them (``summed``: parameters
    shared by the batch). Every rank of a replica must hold the same."""
    per_data = {}
    for r in results:
        d = int(r["data"])
        if d in per_data:
            np.testing.assert_array_equal(r[key], per_data[d], err_msg=f"{key} differs")
        per_data[d] = r[key]
    blocks = [per_data[d] for d in range(world // spatial)]
    return sum(blocks) if summed else np.concatenate(blocks, axis=0)


@pytest.mark.parametrize("world,spatial", [(1, 1), (2, 2), (4, 4), (4, 2)],
                         ids=["spatial1", "spatial2", "spatial4", "data2xspatial2"])
def test_spatial_group_matches_jax(spatial_case, tmp_path, world, spatial):
    case_dir, inputs, refs = spatial_case
    results = _spawn(case_dir, tmp_path, world, spatial)
    assert all(int(r["world"]) == world for r in results)
    np.testing.assert_array_equal(results[0]["gathered_ranks"], np.arange(world))
    get = functools.partial(_assemble, results, world=world, spatial=spatial)
    whole = functools.partial(_batch, results, world=world, spatial=spatial)
    part = functools.partial(_partial, results, world=world, spatial=spatial)

    # halo_rows is cyclic: shard s's top is global row s·mxs − 1, its bottom
    # row (s+1)·mxs, both mod MX
    mxs, x = MX // spatial, inputs["arange"]
    n_data = world // spatial
    for r in results:
        s, d = int(r["spatial_rank"]), int(r["data"])
        bsl = slice(d * B // n_data, (d + 1) * B // n_data)
        np.testing.assert_array_equal(r["top"][:, 0], x[bsl, (s * mxs - 1) % MX])
        np.testing.assert_array_equal(r["bot"][:, 0], x[bsl, ((s + 1) * mxs) % MX])

    for mode in (0, -1, 3):  # jax.shard_map on the 8 CPU devices
        _close(get(f"local{mode}"), refs[f"local{mode}"], VAL_TOL, f"mode {mode}")
    for name in ("local", "kernel"):  # plain tier, then the halo kernels' path
        _close(get(f"{name}_out"), refs["local_out"], VAL_TOL, name)
        if name == "local":  # shard_map's gradients of the sharded operands
            for g_name, ref in zip(("dq", "dk", "dv"), refs["local_sharded_grads"]):
                _close(get(f"local_{g_name}"), ref, GRAD_TOL, f"local {g_name} (shard_map)")
        ref_q, ref_k, ref_v, ref_kg, ref_vg, ref_bias = refs["local_grads"]
        for g_name, ref in (("dq", ref_q), ("dk", ref_k), ("dv", ref_v)):
            _close(get(f"{name}_{g_name}"), ref, GRAD_TOL, f"{name} {g_name}")
        _close(part(f"{name}_dkg"), ref_kg, GRAD_TOL, f"{name} dk_glo")
        _close(part(f"{name}_dvg"), ref_vg, GRAD_TOL, f"{name} dv_glo")
        _close(part(f"{name}_dbias", over_data=True), ref_bias, GRAD_TOL, f"{name} dbias")

    _close(whole("glo_out"), refs["glo_out"], VAL_TOL, "global branch")
    _close(whole("glo_unsplit"), refs["glo_out"], VAL_TOL, "global branch, no context")
    dqg, dki, dvi, dkg, dvg, dg2g, dg2l0 = refs["glo_grads"]
    _close(part("glo_dqg"), dqg, GRAD_TOL, "global dqg")
    _close(get("glo_dk_img"), dki, GRAD_TOL, "global dk_img")
    _close(get("glo_dv_img"), dvi, GRAD_TOL, "global dv_img")
    _close(part("glo_dkg"), dkg, GRAD_TOL, "global dk_glo")
    _close(part("glo_dvg"), dvg, GRAD_TOL, "global dv_glo")
    _close(part("glo_dg2g", over_data=True), dg2g, GRAD_TOL, "global dg2g")
    _close(part("glo_dg2l0", over_data=True), dg2l0, GRAD_TOL, "global dg2l0")

    logits = whole("logits")
    _close(logits, refs["logits"], LOGITS_TOL, "logits vs JAX")
    _close(logits, refs["logits_port"], LOGITS_TOL, "logits vs the unsharded port")


def test_spatial_forward_alone_and_bad_splits():
    """Without a process group the spatial forward is one rank's: the
    unsharded logits through the halo route (no sliding-chunk kernel of the
    classic path), in eval and in training. The split is chunk-aligned: 3
    ranks take the 4 blocks of 16 rows 2/1/1; 8 ranks would leave a rank no
    row and raise naming the stage. A model built with the fused block,
    which has no halo form, raises under the split."""
    model = MsViT(ARCH, img_size=IMG, num_classes=10, sharew=True, norm_embed=True,
                  device="cpu", generator=torch.Generator().manual_seed(0)).eval()
    x = _t(_rng(31, 2, IMG, IMG, 3))
    with torch.inference_mode():
        torch.testing.assert_close(
            parallel.spatial_forward(model, parallel.shard_image(x, model), None),
            model(x), atol=LOGITS_TOL, rtol=LOGITS_TOL)
    torch.testing.assert_close(model.train()(x, spatial=parallel.SpatialContext.of(None)),
                               model(x), atol=LOGITS_TOL, rtol=LOGITS_TOL)
    for size, rows in ((2, [32, 32]), (3, [32, 16, 16]), (4, [16] * 4)):
        assert [hi - lo for lo, hi in model.spatial_split(size).image] == rows
    with pytest.raises(ValueError, match="no row of stage 1"):
        model.spatial_split(8)
    fused = MsViT(ARCH, img_size=IMG, num_classes=10, sharew=True, norm_embed=True,
                  fused_block=True, device="cpu").eval()
    with torch.inference_mode(), pytest.raises(NotImplementedError, match="no halo form"):
        parallel.spatial_forward(fused, parallel.shard_image(x, fused), None)


# ------------------------------------------------------ layout probe (P)

def test_layout_probe_schemes_agree():
    """P's plain version, x·2, in both of the probe's schemes: the same
    result, in the chain and alone, and on the CPU the same copy ops per
    pass (the permutation costs none: x·2 keeps its input's strides)."""
    x, w_in, w_out = layout_probe.inputs("cpu", torch.float32, shape=(4, 2, 3, 5, 8))
    y = torch.matmul(x, w_in)
    torch.testing.assert_close(layout_probe.scheme_a(y), 2 * y, atol=0, rtol=0)
    torch.testing.assert_close(layout_probe.scheme_b(y), 2 * y, atol=0, rtol=0)
    a, b = (layout_probe.chain(fn, x, w_in, w_out, 3) for fn in layout_probe.SCHEMES.values())
    assert torch.equal(a, b)
    base, perm = (layout_probe.per_iteration_copies(fn, x, w_in, w_out, iters=(1, 3))
                  for fn in layout_probe.SCHEMES.values())
    assert base == perm and set(base) == {*layout_probe.COPY_OPS, "kernels"}
    assert [fn.launches for fn in layout_probe.KERNELS] == [0, 0]
