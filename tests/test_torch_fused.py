"""The port's fused-kernel configuration against ``vil_tpu``, on the CPU.

The fused configuration is TPU.FUSED_LN (the block pre-norms through the
LayerNorm kernels B8) and the fused attention block (B9, the JAX package's
``VIL_TPU_FUSED_BLOCK=1``). On the CPU the port's wrappers run their plain
versions; the JAX side runs its Pallas kernels in interpret mode, as
``tests/test_layer_norm.py`` and ``tests/test_vil_block.py`` do, each JAX
function jitted once per configuration. Inputs come from
``np.random.default_rng``. Tolerances: LayerNorm atol 1e-5 in f32 and one
bf16 ulp of the output in bf16; the block f32 atol 1e-5 forward and 5e-5 for
gradients scaled by their largest magnitude (``test_vil_block.py``'s), the
bf16 backward 2e-2 of each gradient's largest magnitude (``BF16_BLOCK_TOL``);
whole models at the repo's parity tolerance, atol 2e-4 / rtol 1e-3.
"""
import functools
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vil_tpu.config import get_default_cfg
from vil_tpu.models import attention as jax_attention
from vil_tpu.models import build_model as jax_build_model
from vil_tpu.models.msvit import MsViT as JaxMsViT
from vil_tpu.ops import masks as jax_masks
from vil_tpu.ops.pallas import full_attention as jax_full_attention
from vil_tpu.ops.pallas import layer_norm as jax_ln
from vil_tpu.ops.pallas import vil_backward as jax_vil_backward
from vil_tpu.ops.pallas import vil_block as jax_vil_block
from vil_tpu.ops.pallas import vil_kernel as jax_vil_kernel
from vil_tpu.train import loss as jax_loss

from vil_tpu_torch.models import MsViT, build_model
from vil_tpu_torch.models.attention import VilAttention
from vil_tpu_torch.models.layers import FusedLayerNorm, LayerNorm
from vil_tpu_torch.ops import sliding_chunk as sc
from vil_tpu_torch.ops.kernels.layer_norm import BWD_MIN_ROWS, BWD_PARTIALS, bwd_geometry
from vil_tpu_torch.ops.kernels import (
    KERNELS,
    layer_norm,
    layer_norm_bwd,
    layer_norm_fwd,
    layer_norm_reference,
    vil_block,
    vil_block_bwd,
    vil_block_fwd,
    vil_block_reference,
)
from vil_tpu_torch.train import loss, recipe
from vil_tpu_torch.utils import jax_import
from vil_tpu_torch.utils.jax_import import load_jax_params

# test_vil_block.py's narrow 64² model: a 4×4 grid of 4×4 chunks, a cyclic
# 2×2 grid, then a dense stage
ARCH_64 = "l1,h2,d32,n1,s1,g1,p4,f4_l2,h2,d64,n1,s1,g1,p2,f4_l3,h2,d64,n1,s0,g0,p2,f4"
COMMON = dict(attn_type="longformerhand", sharew=True, norm_embed=True)
make_fused = jax_vil_block.make_fused_vil_block


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One CPU thread for torch in this module: the test runner's workers
    share the cores, and torch's own threads, one a core in each worker,
    spin against each other."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def interpret(monkeypatch):
    """The JAX package's Pallas kernels in interpret mode, and its fused
    attention block switched on."""
    for mod in (jax_ln, jax_vil_block, jax_vil_kernel, jax_vil_backward, jax_full_attention):
        monkeypatch.setattr(mod, "INTERPRET", True)
    monkeypatch.setattr(jax_attention, "FUSED_BLOCK", True)


def _t(a):
    return None if a is None else torch.from_numpy(np.asarray(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


def _bf16_ulp(ref):
    """One bf16 ulp of each f32 value (of the smallest normal at 0)."""
    mag = np.maximum(np.abs(ref), np.finfo(np.float32).tiny)
    return np.exp2(np.floor(np.log2(mag)) - 7)


# ------------------------------------------------------------------ B8


@pytest.mark.parametrize("C", [48, 96])
@pytest.mark.parametrize("shape", [(4, 8), (7, 3)], ids=["tiled", "xla"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_plain_matches_pallas(interpret, dtype, shape, C):
    """B8's plain versions against vil_tpu's layer_norm and its VJP: 32 rows
    take the Pallas kernels (interpret mode), 21 rows its XLA path."""
    shape = shape + (C,)
    assert (jax_ln._pick_row_tile(int(np.prod(shape[:-1]))) > 0) == (shape[0] == 4)
    rng = np.random.default_rng(C + len(dtype))
    x = rng.standard_normal(shape).astype(np.float32) * 2.0 + 0.5
    gamma = (rng.standard_normal(C) * 0.2 + 1.0).astype(np.float32)
    beta = (rng.standard_normal(C) * 0.1).astype(np.float32)
    dy = rng.standard_normal(shape).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    xj, dyj = jnp.asarray(x, jdt), jnp.asarray(dy, jdt)

    @jax.jit
    def fwd_vjp(x_, g_, b_, dy_):
        y, vjp = jax.vjp(lambda *a: jax_ln.layer_norm(*a, 1e-6), x_, g_, b_)
        return (y, *vjp(dy_))

    ref = [np.asarray(a, np.float32) for a in fwd_vjp(xj, gamma, beta, dyj)]
    xt, dyt = _t(np.asarray(xj, np.float32)).to(tdt), _t(np.asarray(dyj, np.float32)).to(tdt)
    y = layer_norm_fwd(xt, _t(gamma), _t(beta), 1e-6)
    dx, dgamma, dbeta = layer_norm_bwd(xt, _t(gamma), dyt, 1e-6)
    assert y.dtype == dx.dtype == tdt and dgamma.dtype == dbeta.dtype == torch.float32
    ours = [t.float().numpy() for t in (y, dx, dgamma, dbeta)]
    for name, a, b in zip(("y", "dx", "dgamma", "dbeta"), ours, ref):
        if dtype == "float32" or name in ("dgamma", "dbeta"):
            # dγ, dβ: f32 sums over the rows in another order
            np.testing.assert_allclose(a, b, atol=1e-5, rtol=1e-6, err_msg=name)
        else:
            assert (np.abs(a - b) <= _bf16_ulp(b)).all(), (name, np.abs(a - b).max())


def test_layer_norm_autograd_function_and_checks():
    """The differentiable entry point gives autograd's gradients of the plain
    version and launches nothing on the CPU; shapes the kernels do not take
    raise."""
    for fn in KERNELS:
        fn.launches = 0
    rng = np.random.default_rng(3)
    x, dy = (_t(rng.standard_normal((5, 6, 40)).astype(np.float32)) for _ in range(2))
    gamma, beta = (_t(rng.standard_normal(40).astype(np.float32)) for _ in range(2))
    grads = []
    for fn in (layer_norm, layer_norm_reference):
        leaves = [t.clone().requires_grad_() for t in (x, gamma, beta)]
        torch.testing.assert_close(fn(*leaves), layer_norm_reference(x, gamma, beta),
                                   atol=0, rtol=0)
        fn(*leaves).backward(dy)
        grads.append([t.grad for t in leaves])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)
    assert [fn.launches for fn in KERNELS] == [0] * len(KERNELS)
    with pytest.raises(ValueError, match="1024"):
        layer_norm_fwd(torch.zeros(2, 1025), torch.ones(1025), torch.zeros(1025))
    with pytest.raises(TypeError):
        layer_norm_fwd(x.half(), gamma, beta)
    with pytest.raises(ValueError, match="contiguous"):
        layer_norm_fwd(x.transpose(0, 1), gamma, beta)
    with pytest.raises(ValueError, match="gamma"):
        layer_norm_fwd(x, gamma[:20], beta)
    with pytest.raises(ValueError, match="dy"):
        layer_norm_bwd(x, gamma, dy[:2])


# B8b's grid at the six row shapes of ViL-Small's fused training step, and
# at one row and at C 1000
@pytest.mark.parametrize("rows,C", [(200704, 96), (64, 96), (50176, 192), (64, 192),
                                    (12608, 384), (3136, 768), (1, 96), (3000, 100),
                                    (1, 1000)])
def test_layer_norm_backward_grid_covers_every_row_once(rows, C):
    """layer_norm_bwd's grid: its blocks' row spans cover every row exactly
    once, none is empty, and their partials fit the (blocks, 2, C) scratch:
    at most BWD_PARTIALS of them, each block over at least BWD_MIN_ROWS rows
    where there are as many."""
    blocks, per_block = bwd_geometry(rows)
    assert 1 <= blocks <= BWD_PARTIALS
    seen = np.zeros(rows, np.int64)
    for b in range(blocks):
        r0, r1 = b * per_block, min(rows, (b + 1) * per_block)
        assert r0 < r1, (b, r0, r1)
        seen[r0:r1] += 1
    assert (seen == 1).all()
    assert per_block >= min(rows, BWD_MIN_ROWS)
    # partial b at [2 C b, 2 C (b + 1)) of the scratch, dγ and dβ after them
    assert blocks * 2 * C + 2 * C <= (BWD_PARTIALS + 1) * 2 * C


# ------------------------------------------------------------------ B9

BLOCK_ORDER = ("wq", "bq", "wk", "bk", "wv", "bv", "wo", "bo", "kg", "vg", "bias")


def _block_case(nglo, with_bias, qkv_bias=True, H=3, C=48, mx=4, my=4, w=3, B=2, seed=0):
    """test_vil_block.py's _setup: x and the fused block's operands in JAX's
    form (biases (1, C)), and the additive mask."""
    w2 = w * w
    rng = np.random.default_rng(seed)
    f = lambda *s: (rng.standard_normal(s) * 0.2).astype(np.float32)
    x = f(B, mx, my, w2, C)
    args = dict(wq=f(C, C), wk=f(C, C), wv=f(C, C), wo=f(C, C),
                bq=f(1, C) if qkv_bias else None, bk=f(1, C) if qkv_bias else None,
                bv=f(1, C) if qkv_bias else None, bo=f(1, C),
                kg=f(B, nglo, C) if nglo else None, vg=f(B, nglo, C) if nglo else None,
                bias=f(H, w2, nglo + 9 * w2) if with_bias else None)
    mask = jax_vil_kernel.mask_to_additive(jax_masks.invalid_mask(mx, my, 0, 0, w, 0, 0),
                                           mx, my, w2, nglo)
    return x, [args[k] for k in BLOCK_ORDER], mask, H


def _port_args(rest):
    """The operands in the port's form: biases (C,)."""
    return [None if a is None else _t(a.reshape(-1) if a.shape[0] == 1 and a.ndim == 2 else a)
            for a in rest]


def _block_loss(y, k, v, lib):
    """test_vil_block.py's loss: all three outputs take part."""
    return lib.sum(lib.tanh(y)) + lib.sum(k * 0.1) + lib.sum(v * 0.05)


# bf16: the plain versions of vil_block_fwd (f32 sums over the bf16 values,
# q, k, v, attn and y rounded to bf16) and of vil_block_bwd (autograd in f32
# over the bf16 values) against _pallas_block_forward and
# _pallas_block_backward on the same values, each output and gradient to
# max|err| / max|ref| (dbk, whose exact value is 0, at dWk's scale). The TPU
# kernels round P to bf16 in the forward (vil_kernel.py:332) and dattn, P, dS,
# dq, dk and dv in the backward (vil_block.py:263, :304, :321, :396-399)
# where the plain versions keep f32, each a relative 2^-9 at most: the
# gradients read here at ≤ 8.6e-3, and dbk at ≤ 1.4e-2 (both sides' dbk is
# the rounding of a sum whose exact value is 0). The limit is
# chip_smoke.py's CHUNK_SCALED_TOL, which holds the kernels in bf16 the same
# way: these are the functions the kernels are held against on the card.
BF16_BLOCK_TOL = 2e-2


def _block_bf16_errors(x, rest, mask, H):
    """vil_block_fwd's (y, k, v, lse) and vil_block_bwd in bf16 (the plain
    versions on the CPU) against _pallas_block_forward and
    _pallas_block_backward in interpret mode, all from x and the weights in
    bf16 (biases and the RPE bias f32); the backward from the JAX forward's
    LSE and one g: {output or gradient index: max|err| / max|ref|}."""
    bf = lambda a: None if a is None else jnp.asarray(a, jnp.bfloat16)
    # the weights and global rows in bf16, the biases (1, C) and the RPE bias f32
    jrest = [bf(a) if k in ("wq", "wk", "wv", "wo", "kg", "vg") else _j(a)
             for k, a in zip(BLOCK_ORDER, rest)]
    xj = bf(x)
    fwd = jax.jit(lambda *a: jax_vil_block._pallas_block_forward(
        *a, mask, H, with_lse=True, interpret=True))(xj, *jrest)
    lse = fwd[3]
    t16 = lambda a: None if a is None else _t(np.asarray(a, np.float32)).to(torch.bfloat16)
    args = [t16(a) if k in ("wq", "wk", "wv", "wo", "kg", "vg") else b
            for k, a, b in zip(BLOCK_ORDER, rest, _port_args(rest))]
    ours = vil_block_fwd(t16(x), *args, _t(mask), H, with_lse=True)
    assert [t.dtype for t in ours] == [torch.bfloat16] * 3 + [torch.float32]
    errs = {}
    for name, a, r in zip(("y", "k", "v", "lse"), ours, fwd):
        r = np.asarray(r, np.float32)
        errs[name] = np.abs(a.float().numpy() - r).max() / np.abs(r).max()
    g = np.random.default_rng(8).standard_normal(x.shape).astype(np.float32)
    ref = jax.jit(lambda *a: jax_vil_block._pallas_block_backward(
        *a[:-2], mask, H, a[-2], a[-1], interpret=True))(xj, *jrest, bf(g), lse)
    ref = [None if r is None else np.asarray(r, np.float32) for r in ref]
    if ref[11] is not None:  # dbias: the TPU kernel's tail order → front order
        nloc = 9 * x.shape[3]
        ref[11] = np.concatenate([ref[11][..., nloc:], ref[11][..., :nloc]], axis=-1)
    ours = vil_block_bwd(t16(x), *args, t16(g), _t(mask), _t(np.asarray(lse)), H, None)
    assert ours[0].dtype == torch.bfloat16
    for i, (a, r) in enumerate(zip(ours, ref)):
        assert (a is None) == (r is None), i
        if r is None:
            continue
        scale = np.abs(ref[3 if i == 4 else i]).max()
        errs[i] = np.abs(a.float().numpy().reshape(r.shape) - r).max() / scale
    return errs


@pytest.mark.parametrize("nglo,with_bias,dtype", [
    pytest.param(1, False, "float32", id="1-False"),
    pytest.param(1, True, "float32", id="1-True"),
    pytest.param(0, False, "float32", id="0-False"),
    pytest.param(0, True, "float32", id="0-True"),
    pytest.param(1, False, "bfloat16", id="bf16-1-False"),
    pytest.param(1, True, "bfloat16", id="bf16-1-True"),
    pytest.param(0, False, "bfloat16", id="bf16-0-False"),
    pytest.param(0, True, "bfloat16", id="bf16-0-True"),
])
def test_vil_block_plain_matches_pallas(interpret, nglo, with_bias, dtype):
    """B9's plain versions: (y, k, v, lse) against _pallas_block_forward, and
    the gradients of VilBlockFunction (vil_block_bwd's y part plus the fold
    of k's and v's) against make_fused_vil_block's VJP, both in interpret
    mode; in bf16, (y, k, v, lse) against _pallas_block_forward and
    vil_block_bwd against _pallas_block_backward."""
    x, rest, mask, H = _block_case(nglo, with_bias)
    if dtype == "bfloat16":
        errs = _block_bf16_errors(x, rest, mask, H)
        assert max(errs.values()) <= BF16_BLOCK_TOL, errs
        return
    fwd = jax.jit(lambda *a: jax_vil_block._pallas_block_forward(
        *a, mask, H, with_lse=True, interpret=True))
    ref = fwd(jnp.asarray(x), *map(_j, rest))
    ours = vil_block_fwd(_t(x), *_port_args(rest), _t(mask), H, with_lse=True)
    for name, a, b in zip(("y", "k", "v", "lse"), ours, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5, rtol=0, err_msg=name)

    fused = jax_vil_block.make_fused_vil_block(mask, H)
    argnums = tuple(i for i, a in enumerate([x] + rest) if a is not None)
    ref_grads = jax.jit(jax.grad(lambda *a: _block_loss(*fused(*a), jnp), argnums=argnums))(
        jnp.asarray(x), *map(_j, rest))
    leaves = [None if a is None else a.clone().requires_grad_()
              for a in [_t(x)] + _port_args(rest)]
    _block_loss(*vil_block(*leaves, _t(mask), H), torch).backward()
    for i, ref_g in zip(argnums, ref_grads):
        ref_g = np.asarray(ref_g).reshape(leaves[i].shape)
        scale = np.abs(ref_g).max() + 1e-6
        np.testing.assert_allclose(leaves[i].grad.numpy() / scale, ref_g / scale, atol=5e-5,
                                   err_msg=f"argnum {i}")


def _large_bias_case(seed=3, B=2, mx=4, C=96, H=3):
    """The model's operands at ViL-Small's stage-1 width on an mx × mx grid of
    7×7 chunks, x ~ N(0, 1), weights scale-folded as the model passes them,
    and q, k, v biases as large as the products (bq folded too)."""
    rng = np.random.default_rng(seed)
    M, w2 = C // H, 49
    f = lambda *s, scale=1.0: (rng.standard_normal(s) * scale).astype(np.float32)
    x = f(B, mx, mx, w2, C)
    args = dict(wq=f(C, C, scale=(C * M) ** -0.5), wk=f(C, C, scale=C ** -0.5),
                wv=f(C, C, scale=C ** -0.5), wo=f(C, C, scale=C ** -0.5),
                bq=f(1, C, scale=M ** -0.5), bk=f(1, C), bv=f(1, C), bo=f(1, C, scale=0.02),
                kg=f(B, 1, C), vg=f(B, 1, C), bias=None)
    mask = jax_vil_kernel.mask_to_additive(jax_masks.invalid_mask(mx, mx, 0, 0, 7, 0, 0),
                                           mx, mx, w2, 1)
    return x, [args[k] for k in BLOCK_ORDER], mask, H


def test_vil_block_bf16_with_large_qkv_biases_matches_pallas(interpret):
    """The bf16 plain versions against the TPU kernels (interpret mode) when
    the q, k and v biases are as large as the products, as in the case that
    holds B9a's bias epilogue on the card (chip_smoke.py). The TPU kernel's
    own dWq reads farther from the plain version here than at the model's
    small biases (9.4e-3 against 5.0e-3 at this size; 1.0e-2, and dbq
    1.3e-2, on ViL-Small's 8 × 8 stage-1 grid): its dS, rounded to bf16,
    leaves each query's row a small sum, which the keys' common bias
    multiplies into dq. Held at the same BF16_BLOCK_TOL."""
    errs = _block_bf16_errors(*_large_bias_case())
    assert max(errs.values()) <= BF16_BLOCK_TOL, errs


def test_vil_block_autograd_function_and_checks():
    """vil_block_bwd's gradients of y are autograd's through the plain
    version, the forward's q and attn are the plain version's, nothing
    launches on the CPU, and operands the kernels do not take raise."""
    for fn in KERNELS:
        fn.launches = 0
    x, rest, mask, H = _block_case(1, True, qkv_bias=False, seed=4)
    args = _port_args(rest)
    xt, mt = _t(x), _t(mask)
    g = _t(np.random.default_rng(5).standard_normal(x.shape).astype(np.float32))
    y, k, v, lse, q, attn = vil_block_fwd(xt, *args, mt, H, with_lse=True, saved=True)
    grads = vil_block_bwd(xt, *args, g, mt, lse, H, (q, k, v, attn))
    assert grads[2] is None and grads[4] is None and grads[6] is None  # no qkv bias
    leaves = [None if a is None else a.clone().requires_grad_() for a in [xt] + args]
    vil_block_reference(*leaves, mt, H)[0].backward(g)
    for a, b in zip(grads, leaves):
        assert (a is None) == (b is None)
        if a is not None:
            torch.testing.assert_close(a, b.grad, atol=1e-6, rtol=1e-6)
    assert [fn.launches for fn in KERNELS] == [0] * len(KERNELS)
    with pytest.raises(ValueError, match="wq"):
        vil_block_fwd(xt, args[0][:, :16].contiguous(), *args[1:], mt, H)
    with pytest.raises(ValueError, match="wk"):
        vil_block_fwd(xt, args[0], None, args[2].t(), *args[3:], mt, H)
    with pytest.raises(ValueError, match="bo"):
        vil_block_fwd(xt, *args[:7], args[7].double(), *args[8:], mt, H)
    with pytest.raises(ValueError, match="head dim"):
        vil_block_fwd(xt, *args, mt, 2)


@pytest.mark.parametrize("nglo,exact", [(1, 0), (0, -1), (2, 1)])
def test_vil_attention_fused_route_matches_flax(interpret, nglo, exact):
    """VilAttention with fused_block against flax's VilAttention with
    FUSED_BLOCK on a padded 3×3 grid of 3×3 chunks, forward."""
    nx, ny, w, C, H, B = 7, 8, 3, 48, 3, 2
    rng = np.random.default_rng(30 + nglo)
    x_glo = rng.standard_normal((B, nglo, C)).astype(np.float32) if nglo else None
    x_img = sc.chunkify(_t(rng.standard_normal((B, nx * ny, C)).astype(np.float32)),
                        nx, ny, w).numpy()
    flax_mod = jax_attention.VilAttention(dim=C, num_heads=H, w=w, nglo=nglo, sharew=True,
                                          exact=exact, use_pallas=True)
    x_jax = (_j(x_glo), jnp.asarray(x_img))
    params = jax.tree_util.tree_map(np.asarray, flax_mod.init(
        {"params": jax.random.PRNGKey(0)}, x_jax, nx, ny, True)["params"])
    calls = []
    with pytest.MonkeyPatch.context() as mp:  # the JAX module takes its fused route
        mp.setattr(jax_vil_block, "make_fused_vil_block",
                   lambda *a: calls.append(1) or make_fused(*a))
        ref_glo, ref_img = jax.jit(
            lambda p, xs: flax_mod.apply({"params": p}, xs, nx, ny, True))(params, x_jax)
    assert calls
    ours = load_jax_params(VilAttention(dim=C, num_heads=H, w=w, nglo=nglo, exact=exact,
                                        fused_block=True), params)
    with torch.inference_mode():
        out_glo, out_img = ours((_t(x_glo), _t(x_img)), nx, ny)
    np.testing.assert_allclose(out_img.numpy(), np.asarray(ref_img), atol=1e-5, rtol=1e-5)
    if nglo:
        np.testing.assert_allclose(out_glo.numpy(), np.asarray(ref_glo), atol=1e-5, rtol=1e-5)
    else:
        assert out_glo is None and ref_glo is None


def _torch_tree(tree) -> dict:
    """A flax-shaped tree under the port's names and layouts."""
    return {name: arr for name, arr in (jax_import._to_torch_leaf(n, np.asarray(a))
                                        for n, a in jax_import._flatten(tree))}


def _flax_params(ours, jax_model, x):
    """The port model's seeded parameters as the flax tree of ``jax_model``."""
    shapes = jax.eval_shape(lambda: jax_model.init({"params": jax.random.PRNGKey(0)},
                                                   jnp.asarray(x)))["params"]
    params = {n: p.detach().float().numpy() for n, p in ours.named_parameters()}

    def leaf(path, sds):
        name = ".".join(str(k.key) for k in path)
        arr = params[jax_import._to_torch_leaf(name, np.zeros(sds.shape, np.float32))[0]]
        if name.endswith("kernel"):
            arr = arr.T if arr.ndim == 2 else arr.transpose(2, 3, 1, 0)
        assert arr.shape == sds.shape, name
        return jnp.asarray(arr)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _narrow(fused, **kw):
    return MsViT(ARCH_64, img_size=64, num_classes=10, device="cpu", fused_ln=fused,
                 fused_block=fused, generator=torch.Generator().manual_seed(0), **COMMON, **kw)


def test_fused_msvit_matches_jax(interpret):
    """The narrow model in the fused configuration against vil_tpu's with
    fused_ln and FUSED_BLOCK (every LayerNorm, fused block and dense kernel
    in interpret mode): eval logits, then the training loss and every
    parameter gradient (batch 2, drop path 0)."""
    rng = np.random.default_rng(40)
    x = rng.standard_normal((2, 64, 64, 3)).astype(np.float32)
    labels = np.array([3, 7])
    ours = _narrow(True)
    jax_model = JaxMsViT(arch=ARCH_64, img_size=64, num_classes=10, use_pallas=True,
                         fused_ln=True, **COMMON)
    params = _flax_params(ours, jax_model, x)
    ref_logits = jax.jit(lambda p: jax_model.apply({"params": p}, jnp.asarray(x)))(params)
    with torch.inference_mode():
        logits = ours.eval()(_t(x))
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits), atol=2e-4, rtol=1e-3)

    def jax_loss_fn(p):
        logits = jax_model.apply({"params": p}, jnp.asarray(x), deterministic=False)
        return jax_loss.cross_entropy(logits, jnp.asarray(labels))

    ref_loss, ref_grads = jax.jit(jax.value_and_grad(jax_loss_fn))(params)
    out = loss.cross_entropy(ours.train()(_t(x)), _t(labels))
    out.backward()
    np.testing.assert_allclose(out.item(), float(ref_loss), atol=2e-4, rtol=1e-3)
    ref = _torch_tree(ref_grads)
    assert set(ref) == {n for n, _ in ours.named_parameters()}
    for name, p in ours.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), ref[name], atol=2e-4, rtol=1e-3,
                                   err_msg=name)


def test_fused_and_classic_paths_agree():
    """vil_tpu's test_model_level_block_on_off for the port: the fused and
    the classic configuration from the same weights give the same logits and
    the same gradients (f32, 1e-5), and the CPU launches nothing."""
    for fn in KERNELS:
        fn.launches = 0
    rng = np.random.default_rng(41)
    x = _t(rng.standard_normal((2, 64, 64, 3)).astype(np.float32))
    labels = torch.tensor([1, 2])
    results = []
    for fused in (True, False):
        model = _narrow(fused)
        with torch.inference_mode():
            logits = model.eval()(x)
        loss.cross_entropy(model.train()(x), labels).backward()
        results.append((logits, {n: p.grad for n, p in model.named_parameters()}))
    (l_on, g_on), (l_off, g_off) = results
    torch.testing.assert_close(l_on, l_off, atol=1e-5, rtol=0)
    assert set(g_on) == set(g_off)
    for name, g in g_on.items():
        torch.testing.assert_close(g, g_off[name], atol=1e-5, rtol=0, msg=name)
    assert [fn.launches for fn in KERNELS] == [0] * len(KERNELS)


def _vil_small_cfg(fused_ln, arch="vil_small", img=224):
    cfg = get_default_cfg()
    cfg.merge_from_list(["MODEL.ARCH", arch, "MODEL.VIT.MSVIT.ARCH", ARCH_64,
                         "INPUT.IMAGE_SIZE", str(img), "MODEL.VIT.NORM_EMBED", "True",
                         "MODEL.VIT.MSVIT.SHARE_W", "True", "TPU.COMPUTE_DTYPE", "float32",
                         "TPU.FUSED_LN", str(fused_ln)])
    return cfg


def test_build_model_reads_the_fused_switches(monkeypatch):
    """TPU.FUSED_LN puts the kernels' LayerNorm in the block pre-norms (not
    the patch-embedding or final norms) when the kernels are on, as vil_tpu's
    build_model does with use_pallas; VIL_TPU_FUSED_BLOCK, read at each
    call, or fused_block turns on the fused attention block."""
    cfg = _vil_small_cfg(True, "msvit", 64)
    assert jax_build_model(cfg).fused_ln and not jax_build_model(cfg, use_pallas=False).fused_ln

    def kinds(model):
        norms = [type(m) for m in model.modules() if isinstance(m, LayerNorm)]
        blocks = {m.fused_block for m in model.modules() if isinstance(m, VilAttention)}
        return norms.count(FusedLayerNorm), len(norms), blocks

    monkeypatch.delenv("VIL_TPU_FUSED_BLOCK", raising=False)
    assert kinds(build_model(cfg, device="cpu")) == (6, 6 + 3 + 1, {False})
    assert kinds(build_model(cfg, device="cpu", use_kernels=False))[0] == 0
    assert kinds(build_model(_vil_small_cfg(False, "msvit", 64), device="cpu"))[0] == 0
    monkeypatch.setenv("VIL_TPU_FUSED_BLOCK", "1")
    assert kinds(build_model(cfg, device="cpu"))[2] == {True}
    assert kinds(build_model(cfg, device="cpu", fused_block=False))[2] == {False}
    monkeypatch.setenv("VIL_TPU_FUSED_BLOCK", "0")
    assert kinds(build_model(cfg, device="cpu"))[2] == {False}
    assert kinds(build_model(cfg, device="cpu", fused_block=True))[2] == {True}


def test_vil_small_fused_runs_30_layer_norms_and_3_blocks(interpret):
    """Per forward of ViL-Small 224² in the fused configuration: 30 LayerNorm
    calls (3 chunked blocks × 2 pre-norms × (global rows, image), 9 dense
    blocks × 2) in the JAX model (counted while jax.eval_shape traces it) and
    in the port (batch 1, on the CPU). The port runs all 3 sliding-chunk
    blocks as fused blocks; the JAX package only the 2 of stage 2, whose
    whole image fits its VMEM gate (block_fits), and stage 1 classically."""
    cfg = _vil_small_cfg(True)
    counts = {"ln": 0, "block": 0}

    def counting(fn, key):
        @functools.wraps(fn)
        def wrapped(*a, **kw):
            counts[key] += 1
            return fn(*a, **kw)
        return wrapped

    jax_model = jax_build_model(cfg)
    x = jnp.zeros((1, 224, 224, 3))
    shapes = jax.eval_shape(lambda: jax_model.init({"params": jax.random.PRNGKey(0)}, x))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_ln, "layer_norm", counting(jax_ln.layer_norm, "ln"))
        mp.setattr(jax_vil_block, "make_fused_vil_block", counting(make_fused, "block"))
        jax.eval_shape(lambda v: jax_model.apply(v, x), shapes)
    assert counts == {"ln": 30, "block": 2}
    assert not jax_vil_block.block_fits(jnp.zeros((1, 8, 8, 49, 96)), 3, 1, False)
    assert jax_vil_block.block_fits(jnp.zeros((1, 4, 4, 49, 192)), 3, 1, False)

    ours = build_model(cfg, device="cpu", fused_block=True)
    counts.update(ln=0, block=0)
    for m in ours.modules():
        if isinstance(m, FusedLayerNorm):
            m.register_forward_hook(lambda *_: counts.__setitem__("ln", counts["ln"] + 1))
    import vil_tpu_torch.models.attention as port_attention
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_attention, "vil_block", counting(port_attention.vil_block, "block"))
        with torch.inference_mode():
            ours.eval()(torch.zeros(1, 224, 224, 3))
    assert counts == {"ln": 30, "block": 3}


def test_load_jax_params_loads_a_fused_flax_tree():
    """A flax tree of the fused model (FusedLayerNorm's scale/bias) loads
    strictly into the port's fused model."""
    jax_model = JaxMsViT(arch=ARCH_64, img_size=64, num_classes=10, use_pallas=True,
                         fused_ln=True, **COMMON)
    shapes = jax.eval_shape(lambda: jax_model.init({"params": jax.random.PRNGKey(0)},
                                                   jnp.zeros((1, 64, 64, 3))))["params"]
    rng = np.random.default_rng(42)
    params = jax.tree_util.tree_map(
        lambda s: rng.standard_normal(s.shape).astype(np.float32), shapes)
    ours = load_jax_params(_narrow(True), params)
    norm = ours.stage2_block0_attn.norm
    assert isinstance(norm, FusedLayerNorm)
    np.testing.assert_array_equal(norm.weight.detach().numpy(),
                                  params["stage2_block0_attn"]["norm"]["scale"])
    short = dict(params)
    del short["stage1_block0_mlp"]
    with pytest.raises(KeyError, match="stage1_block0_mlp.norm.weight"):
        load_jax_params(_narrow(True), short)


def test_fused_recipe():
    """vil_small_cfg(fused=True) differs from the recipe in TPU.FUSED_LN
    alone (False there, as in vil_tpu's defaults); vil_small(fused=True)
    builds the fused configuration from the same seeded weights."""
    def leaves(tree, prefix=""):
        for key, value in vars(tree).items():
            if isinstance(value, SimpleNamespace):
                yield from leaves(value, f"{prefix}{key}.")
            else:
                yield prefix + key, value

    base, fused = dict(leaves(recipe.vil_small_cfg())), dict(leaves(recipe.vil_small_cfg(
        fused=True)))
    assert {k for k in base if base[k] != fused[k]} == {"TPU.FUSED_LN"}
    assert base["TPU.FUSED_LN"] is False and fused["TPU.FUSED_LN"] is True
    assert get_default_cfg().TPU.FUSED_LN is False
    plain = recipe.vil_small(torch.float32, device="cpu")
    model = recipe.vil_small(torch.float32, device="cpu", fused=True)
    assert isinstance(model.stage3_block0_mlp.norm, FusedLayerNorm)
    assert model.stage1_block0_attn.attn.fused_block and model.stage2_block1_attn.attn.fused_block
    for (name, a), (_, b) in zip(model.named_parameters(), plain.named_parameters()):
        torch.testing.assert_close(a, b, atol=0, rtol=0, msg=name)
