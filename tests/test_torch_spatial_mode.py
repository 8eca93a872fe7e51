"""Random shift (MODE 1..8) and the self chunk alone (mode −1) under the
port's spatial (chunk-row) split, against ``vil_tpu`` on the CPU, in f32.

Shapes are those of ``tests/test_spatial.py`` and
``tests/test_torch_spatial.py``: B 2, an 8×4 grid of 3×3 chunks, H 2, M 8,
inputs from ``np.random.default_rng``; the splits hold 4/4, 2/2/2/2 and the
ragged 3/3/2 chunk rows, every grid of at least 3×3 chunks a shard (so that a
flipped offset sign shows).

* The sampled-neighbour halo kernels' plain versions (B5h, B6h on the CPU),
  shard by shard, against ``vil_tpu``'s ``vil_mode_kernel.mode_forward`` /
  ``mode_backward`` in interpret mode, fed what ``vil_tpu`` feeds them on a
  shard: its q, ks and vs rows, and as knb, vnb the rows
  ``ext[:, 1 - sx : 1 - sx + mxs]`` of its halo-extended K/V rolled by sy
  (``vil_tpu.parallel.spatial.neighborhood_spatial``). The kernels are
  chunk-local, so the shards' operands go through them in one call, stacked
  along the rows (one compilation per configuration serves every mode and
  split). dknb, dvnb are rolled back onto the extended rows and added to
  dks, dvs; each shard's out, lse, dq, dk_ext and dv_ext are held to its
  rows, the global gradients and dbias, summed over the shards, to the
  call's. The shards together, their dk_ext, dv_ext folded onto the rows'
  owners, equal the port's unsplit ``vil_mode_attention_reference`` and its
  backward. Modes 1..8 × the three splits × (Nglo 1 with a bias, Nglo 0
  without).
* Mode −1 needs no halo: the self-only plain version on each shard's rows
  against ``vil_tpu.parallel.spatial.spatial_local_attention(..., mode=-1)``
  on the same rows (which exchanges nothing at −1) and its ``jax.vjp``, and
  the rows of the unsplit result.
* ``VilAttention`` under a spatial context of one rank (no process group:
  the halos are the shard's own rows, as on a 1 × 1 mesh) at modes 1..8 and
  −1, with shared and unshared (SHARE_W False) weights, kernels' route and
  plain route, equals the module without the context; the fused block
  under the split still raises naming A12, and a module split over a model
  axis as well runs there: its two model ranks' partial outputs sum to the
  unsplit module's.
* The training step's draws of random shift are keyed by (seed, step) alone:
  every (data, spatial) rank draws the same modes, and a step given a
  ``mode_generator`` on a spatial mesh raises.

Tolerances: 2e-5 for values and 5e-5 for gradients, as
``tests/test_spatial.py`` has them.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vil_tpu.parallel import spatial as jax_spatial
from vil_tpu.ops.pallas import vil_mode_kernel as jax_mode_kernel

from vil_tpu_torch import parallel
from vil_tpu_torch.models import MsViT
from vil_tpu_torch.models.attention import VilAttention
from vil_tpu_torch.models.layers import Linear
from vil_tpu_torch.ops import masks
from vil_tpu_torch.ops import sliding_chunk as sc
from vil_tpu_torch.ops.kernels import (
    KERNELS,
    mask_to_additive,
    vil_mode_attention_bwd_reference,
    vil_mode_attention_halo,
    vil_mode_attention_halo_bwd,
    vil_mode_attention_halo_fwd,
    vil_mode_attention_reference,
    vil_self_attention_bwd,
    vil_self_attention_fwd,
)
from vil_tpu_torch.train import engine, loss

B, MX, MY, W, H, M = 2, 8, 4, 3, 2, 8
W2, C = W * W, H * M
VAL_TOL, GRAD_TOL = 2e-5, 5e-5
SPLITS = {"2": (4, 4), "4": (2, 2, 2, 2), "ragged": (3, 3, 2)}
CONFIGS = {"glo1-bias": (1, True), "glo0": (0, False)}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One CPU thread for torch in this module: the shapes are small, and the
    test runner's workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(a):
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a))


def _close(ours, ref, tol, what=""):
    np.testing.assert_allclose(np.asarray(ours), np.asarray(ref), atol=tol, rtol=tol,
                               err_msg=what)


def _mask(mode, nglo):
    """The whole grid's additive mask of ``mode``, front order."""
    return mask_to_additive(masks.invalid_mask(MX, MY, 0, 0, W, 0, mode), MX, MY, W2, nglo)


def _inputs(seed, nglo, with_bias, span):
    rng = np.random.default_rng(seed)
    f = lambda *s, scale=0.5: (rng.standard_normal(s) * scale).astype(np.float32)
    q, k, v, g = (f(B, MX, MY, W2, C) for _ in range(4))
    kg, vg = (f(B, nglo, C) if nglo else None for _ in range(2))
    bias = f(H, W2, nglo + span * W2, scale=0.15) if with_bias else None
    return q, k, v, kg, vg, bias, g


def _rows(lo, n):
    """The extended rows of a shard [lo, lo + n): the previous shard's last
    row, its own rows, the next shard's first (cyclic)."""
    return [(lo - 1) % MX, *range(lo, lo + n), (lo + n) % MX]


def _shards(split):
    lo = 0
    for n in SPLITS[split]:
        yield lo, n
        lo += n


def _to_tail(a, nglo):
    """Front column order [glo ‖ self ‖ sampled] → tail [self ‖ sampled ‖ glo]."""
    return None if a is None else np.concatenate([a[..., nglo:], a[..., :nglo]], axis=-1)


def _to_front(a, nglo):
    return None if a is None else np.concatenate([a[..., a.shape[-1] - nglo:],
                                                  a[..., :a.shape[-1] - nglo]], axis=-1)


@functools.lru_cache(maxsize=None)
def _jax_mode_kernels(nglo, with_bias):
    """vil_tpu's mode forward (with its LSE) and backward in interpret mode,
    jitted once per configuration: the mode reaches them only through the
    operands and the mask."""
    def run(q, ks, knb, vs, vnb, kg, vg, bias, mask, g):
        out, lse = jax_mode_kernel.mode_forward(q, ks, knb, vs, vnb, kg, vg, bias, mask, H,
                                                interpret=True, with_lse=True)
        grads = jax_mode_kernel.mode_backward(q, ks, knb, vs, vnb, kg, vg, bias, mask, g, H,
                                              lse=lse, interpret=True)
        return out, lse, grads

    return jax.jit(run)


@functools.lru_cache(maxsize=None)
def _case(mode, config, split):
    """One case's inputs, and what vil_tpu's mode kernels give each shard:
    (inputs, masks, {shard lo: (out, lse, dq, dk_ext, dv_ext)}, summed
    (dk_glo, dv_glo, dbias) in front order)."""
    nglo, with_bias = CONFIGS[config]
    q, k, v, kg, vg, bias, g = _inputs(100 + mode, nglo, with_bias, 2)
    mask = _mask(mode, nglo)
    sx, sy = (int(s) for s in sc.MODE_ROLL_SHIFTS[mode])
    # each shard's operands as vil_tpu gathers them, stacked along the rows
    knb, vnb = [], []
    for lo, n in _shards(split):
        for t, out in ((k, knb), (v, vnb)):
            ext = t[:, _rows(lo, n)]
            out.append(np.roll(ext[:, 1 - sx:1 - sx + n], sy, axis=2))
    knb, vnb = np.concatenate(knb, 1), np.concatenate(vnb, 1)
    tail_mask = np.broadcast_to(_to_tail(mask, nglo), (MX, MY, W2, nglo + 2 * W2))
    out, lse, (dq, dks, dknb, dvs, dvnb, dkg, dvg, dbias) = _jax_mode_kernels(
        nglo, with_bias)(*map(jnp.asarray, (q, k, knb, v, vnb)),
                         None if kg is None else jnp.asarray(kg),
                         None if vg is None else jnp.asarray(vg),
                         None if bias is None else jnp.asarray(_to_tail(bias, nglo)),
                         jnp.asarray(tail_mask), jnp.asarray(g))
    per_shard = {}
    for lo, n in _shards(split):
        sl = slice(lo, lo + n)
        dext = []
        for ds, dnb in ((dks, dknb), (dvs, dvnb)):
            d = np.zeros((B, n + 2, MY, W2, C), np.float32)
            d[:, 1:1 + n] += np.asarray(ds)[:, sl]
            d[:, 1 - sx:1 - sx + n] += np.roll(np.asarray(dnb)[:, sl], -sy, axis=2)
            dext.append(d)
        per_shard[lo] = (np.asarray(out)[:, sl], np.asarray(lse)[:, :, sl],
                         np.asarray(dq)[:, sl], *dext)
    glo = (None if dkg is None else np.asarray(dkg), None if dvg is None else np.asarray(dvg),
           None if dbias is None else _to_front(np.asarray(dbias), nglo))
    return (q, k, v, kg, vg, bias, g), mask, per_shard, glo


@pytest.mark.parametrize("split", list(SPLITS))
@pytest.mark.parametrize("config", list(CONFIGS))
@pytest.mark.parametrize("mode", range(1, 9))
def test_halo_mode_plain_versions_match_vil_tpu_per_shard(mode, config, split):
    """B5h and B6h's plain versions on every shard against vil_tpu's mode
    kernels on that shard's gathered operands; the shards together against
    the unsplit sampled-neighbour attention and its gradients."""
    (q, k, v, kg, vg, bias, g), mask, refs, glo_ref = _case(mode, config, split)
    outs, dq_all = [], []
    dk, dv = np.zeros_like(k), np.zeros_like(v)
    glo = [None, None, None]
    for lo, n in _shards(split):
        sl, rows = slice(lo, lo + n), _rows(lo, n)
        ops = list(map(_t, (q[:, sl], k[:, rows], v[:, rows], kg, vg, bias)))
        m_rows, gs = _t(mask[sl]), _t(g[:, sl])
        out, lse = vil_mode_attention_halo_fwd(*ops, m_rows, H, mode, with_lse=True)
        grads = vil_mode_attention_halo_bwd(*ops, gs, out, m_rows, lse, H, mode)
        at = f"mode {mode}, shard at row {lo} of {SPLITS[split]}"
        for name, ours, ref in zip(("out", "lse", "dq", "dk_ext", "dv_ext"),
                                   (out, lse, *grads[:3]), refs[lo]):
            _close(ours.numpy(), ref, VAL_TOL if name in ("out", "lse") else GRAD_TOL,
                   f"{name}, {at}")
        outs.append(out.numpy())
        dq_all.append(grads[0].numpy())
        for e, row in enumerate(rows):  # the halo rows' gradients to their owners
            dk[:, row] += grads[1].numpy()[:, e]
            dv[:, row] += grads[2].numpy()[:, e]
        glo = [None if t is None else t.numpy() + (0 if s is None else s)
               for t, s in zip(grads[3:], glo)]
    for name, ours, ref in zip(("dk_glo", "dv_glo", "dbias"), glo, glo_ref):
        assert (ours is None) == (ref is None), name
        if ref is not None:
            _close(ours, ref, GRAD_TOL, f"{name} summed over the shards")
    whole = list(map(_t, (q, k, v, kg, vg, bias)))
    _close(np.concatenate(outs, 1), vil_mode_attention_reference(*whole, _t(mask), H, mode),
           VAL_TOL, "shards vs the whole grid")
    ref = vil_mode_attention_bwd_reference(*whole, _t(g), _t(mask), H, mode)
    for name, ours, r in (("dq", np.concatenate(dq_all, 1), ref[0]), ("dk", dk, ref[1]),
                          ("dv", dv, ref[2]), *zip(("dk_glo", "dv_glo", "dbias"), glo,
                                                   ref[3:])):
        if r is not None:
            _close(ours, r.numpy(), GRAD_TOL, f"{name}, the shards folded vs the whole grid")


@functools.lru_cache(maxsize=None)
def _jax_self_local(n, nglo, with_bias):
    """vil_tpu's spatial local attention at mode −1 on a shard of ``n`` rows
    and its vjp, jitted: at −1 it reads the shard's rows alone and calls no
    collective, so it runs outside shard_map."""
    def run(q, k, v, kg, vg, bias, mask, g):
        out, vjp = jax.vjp(lambda *a: jax_spatial.spatial_local_attention(
            *a, mask, H, "spatial", -1), q, k, v, kg, vg, bias)
        return out, vjp(g)

    return jax.jit(run)


@pytest.mark.parametrize("split", list(SPLITS))
@pytest.mark.parametrize("config", list(CONFIGS))
def test_self_only_on_a_shard_matches_vil_tpu(config, split):
    """Mode −1 under the split: the self-only plain versions on each shard's
    rows, without a halo, against vil_tpu's spatial local attention at −1 on
    the same rows and its vjp, and against the rows of the unsplit
    result."""
    nglo, with_bias = CONFIGS[config]
    q, k, v, kg, vg, bias, g = _inputs(200, nglo, with_bias, 1)
    mask = _mask(-1, nglo)
    whole = list(map(_t, (q, k, v, kg, vg, bias)))
    ref_out = vil_mode_attention_reference(*whole, _t(mask), H, -1)
    ref_grads = vil_mode_attention_bwd_reference(*whole, _t(g), _t(mask), H, -1)
    glo = [0.0, 0.0, 0.0]
    for lo, n in _shards(split):
        sl = slice(lo, lo + n)
        ops = list(map(_t, (q[:, sl], k[:, sl], v[:, sl], kg, vg, bias)))
        m_rows, gs = _t(mask[sl]), _t(g[:, sl])
        out, lse = vil_self_attention_fwd(*ops, m_rows, H, with_lse=True)
        grads = vil_self_attention_bwd(*ops, gs, out, m_rows, lse, H)
        jax_out, jax_grads = _jax_self_local(n, nglo, with_bias)(
            *(None if a is None else jnp.asarray(a)
              for a in (q[:, sl], k[:, sl], v[:, sl], kg, vg, bias)),
            jnp.asarray(mask[sl]), jnp.asarray(g[:, sl]))
        at = f"shard at row {lo} of {SPLITS[split]}"
        _close(out.numpy(), jax_out, VAL_TOL, f"out, {at}")
        _close(out.numpy(), ref_out[:, sl].numpy(), VAL_TOL, f"out vs the whole grid, {at}")
        for i, name in enumerate(("dq", "dk", "dv", "dk_glo", "dv_glo", "dbias")):
            assert (grads[i] is None) == (jax_grads[i] is None), name
            if grads[i] is None:
                continue
            _close(grads[i].numpy(), jax_grads[i], GRAD_TOL, f"{name}, {at}")
            if i < 3:
                _close(grads[i].numpy(), ref_grads[i][:, sl].numpy(), GRAD_TOL,
                       f"{name} vs the whole grid, {at}")
            else:
                glo[i - 3] = glo[i - 3] + grads[i].numpy()
    for i, r in enumerate(ref_grads[3:]):  # dk_glo, dv_glo, dbias: sums over the shards
        if r is not None:
            _close(glo[i], r.numpy(), GRAD_TOL, f"global grad {i} summed over the shards")


def test_halo_mode_wrappers_check_their_operands():
    """The halo wrappers take modes 1..8 and K/V of two rows more than q;
    the autograd Function gives autograd's gradients of the plain version;
    nothing launches on the CPU."""
    for fn in KERNELS:
        fn.launches = 0
    (q, k, v, kg, vg, bias, g), mask, _, _ = _case(6, "glo1-bias", "ragged")
    ops = list(map(_t, (q[:, :3], k[:, _rows(0, 3)], v[:, _rows(0, 3)], kg, vg, bias)))
    m_rows = _t(mask[:3])
    leaves = [t.clone().requires_grad_() for t in ops]
    vil_mode_attention_halo(*leaves, m_rows, H, 6).backward(_t(g[:, :3]))
    out, lse = vil_mode_attention_halo_fwd(*ops, m_rows, H, 6, with_lse=True)
    grads = vil_mode_attention_halo_bwd(*ops, _t(g[:, :3]), out, m_rows, lse, H, 6)
    for a, b in zip(grads, leaves):
        torch.testing.assert_close(a, b.grad, atol=1e-6, rtol=1e-6)
    assert [fn.launches for fn in KERNELS] == [0] * len(KERNELS)
    for bad_mode in (0, -1, 9):
        with pytest.raises(ValueError):
            vil_mode_attention_halo_fwd(*ops, m_rows, H, bad_mode)
    with pytest.raises(ValueError):  # K/V of the shard's rows alone: no halo
        vil_mode_attention_halo_fwd(ops[0], ops[0], ops[0], *ops[3:], m_rows, H, 6)
    with pytest.raises(ValueError):  # a mode-0 table: 9 chunks
        vil_mode_attention_halo_fwd(*ops, _t(_mask(0, 1)[:3]), H, 6)


# ---------------------------------------------------- the module, the step

def _module_inputs(nglo=1):
    rng = np.random.default_rng(300)
    nx, ny = MX * W - 2, MY * W - 1  # a padded 8×4 grid of 3×3 chunks
    x_glo = _t(rng.standard_normal((B, nglo, C)).astype(np.float32))
    x_img = sc.chunkify(_t(rng.standard_normal((B, nx * ny, C)).astype(np.float32)), nx, ny, W)
    return nx, ny, x_glo, x_img


@pytest.mark.parametrize("sharew", [True, False], ids=["shared", "unshared"])
@pytest.mark.parametrize("use_kernels", [True, False], ids=["kernels", "plain"])
def test_vil_attention_under_a_one_rank_split_at_every_mode(use_kernels, sharew):
    """A one-rank spatial context (no process group: its halos are its own
    rows, as on a 1 × 1 mesh) at modes 1..8 and −1 gives the module's own
    output and gradients, through the kernels' route (B5h/B6h and the
    self-only B5/B6) and the plain tier, with shared and unshared weights."""
    nx, ny, x_glo, x_img = _module_inputs()
    attn = VilAttention(dim=C, num_heads=H, w=W, nglo=1, sharew=sharew, use_kernels=use_kernels)
    with torch.no_grad():
        for p in attn.parameters():
            p.copy_(torch.randn(p.shape, generator=torch.Generator().manual_seed(p.numel())) * 0.2)
    ctx = parallel.SpatialContext(None, 1, 0, (0, MX))
    for mode in (*range(1, 9), -1):
        runs = []
        for spatial in (None, ctx):
            attn.zero_grad()
            xs = [x_glo.clone().requires_grad_(), x_img.clone().requires_grad_()]
            out_glo, out_img = attn(tuple(xs), nx, ny, mode, spatial=spatial)
            (out_glo.square().sum() + out_img.square().sum()).backward()
            runs.append([out_glo, out_img, *(x.grad for x in xs),
                         *(p.grad.clone() for p in attn.parameters())])
        for a, b in zip(*runs):
            torch.testing.assert_close(a, b, atol=VAL_TOL, rtol=VAL_TOL, msg=f"mode {mode}")


def test_fused_block_and_model_axis_under_the_split_still_raise():
    """The fused block has no halo form: it raises naming A12 under the
    split, at any mode. A module split over a model axis as well runs the
    split's route at its heads: without a process group each of the two
    model ranks' modules (the unsplit module's weights, cut by
    ``Linear.shards``) leaves its partial output unsummed, and the two, less
    the output projection's bias the second adds again, sum to the unsplit
    module's output, at modes 0, 3 and −1."""
    nx, ny, x_glo, x_img = _module_inputs()
    ctx = parallel.SpatialContext(None, 1, 0, (0, MX))
    fused = VilAttention(dim=C, num_heads=H, w=W, nglo=1, fused_block=True)
    for mode in (0, 3, -1):
        with pytest.raises(NotImplementedError, match="A12"):
            fused((x_glo, x_img), nx, ny, mode, spatial=ctx)
    whole = VilAttention(dim=C, num_heads=H, w=W, nglo=1)
    parts = [VilAttention(dim=C, num_heads=H, w=W, nglo=1,
                          tp=parallel.TensorParallel(None, 2, r)) for r in range(2)]
    with torch.no_grad():
        for part in parts:
            for name, mod in part.named_modules():
                if isinstance(mod, Linear):
                    src = whole.get_submodule(name)
                    for leaf in ("weight", "bias"):
                        shard = mod.shards().get(leaf)
                        full = getattr(src, leaf)
                        getattr(mod, leaf).copy_(full if shard is None else shard.local(full))
        for mode in (0, 3, -1):
            ref = whole((x_glo, x_img), nx, ny, mode, spatial=ctx)
            outs = [part((x_glo, x_img), nx, ny, mode, spatial=ctx) for part in parts]
            for got, want in zip(zip(*outs), ref):
                torch.testing.assert_close(got[0] + got[1] - whole.proj.bias, want,
                                           atol=VAL_TOL, rtol=VAL_TOL, msg=f"mode {mode}")


def test_random_shift_draws_alike_on_every_rank_of_a_mesh():
    """The step's modes are keyed by (seed, step) alone: every (data,
    spatial) rank of a 2 × 2 mesh draws the same per-block modes at every
    step, and a ``mode_generator`` on a spatial mesh raises."""
    arch = "l1,h2,d16,n1,s1,g1,p4,f2_l2,h2,d32,n2,s1,g1,p2,f2_l3,h2,d32,n1,s0,g1,p2,f2"
    model = MsViT(arch, img_size=32, num_classes=10, device="cpu")
    draws = {}
    for d in range(2):
        for r in range(2):
            mesh = parallel.Mesh(2, d, parallel.SpatialContext(None, 2, r))
            step = engine.make_train_step(model, loss.cross_entropy,
                                          torch.optim.SGD(model.parameters(), lr=0.1),
                                          device="cpu", random_shift=True, seed=7, mesh=mesh)
            draws[d, r] = []
            for s in (0, 1, 5):
                step.step = s
                draws[d, r].append(engine.sample_vil_modes(step._mode_generator(), model.depth))
    first = draws[0, 0]
    assert all(d == first for d in draws.values()), draws
    assert len({tuple(m) for m in first}) == 3  # the steps draw anew
    with pytest.raises(ValueError, match="spatial axis"):
        engine.make_train_step(model, loss.cross_entropy,
                               torch.optim.SGD(model.parameters(), lr=0.1), device="cpu",
                               random_shift=True, mode_generator=torch.Generator(), seed=7,
                               mesh=parallel.Mesh(spatial=parallel.SpatialContext(None, 1, 0)))
