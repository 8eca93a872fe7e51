"""Relative position bias (``a0``) in the port against ``vil_tpu``, on the CPU.

``vil_tpu_torch.ops.rpe`` is a copy of ``vil_tpu/ops/rpe.py`` and is held
equal to it. The modules that hold the tables (``FullAttention``,
``VilAttention`` at mode 0 and at the sampled-neighbour modes, the fused
block) and the whole ``MsViT`` are held to the flax modules with the JAX
package's Pallas kernels in interpret mode: outputs, and the gradients of the
projections and of all three tables (``jax.grad``). The tables are drawn at
σ = 1, so that the bias moves the scores as much as q·k does and a dropped or
misplaced bias shows. Inputs come from ``np.random.default_rng``; everything
is f32. Tolerance: 1e-5 absolute and relative for module outputs, 1e-4 of
max(1, max|ref|) for module gradients, the repo's atol 2e-4 / rtol 1e-3 for
whole models. Then the serving cache (equal to the uncached path, ignored in
training, never served stale), the no-decay group and the builders.

The flax modules, their initial parameters and their jitted gradients are
built once per configuration and shared by its cases (``_flax_vil``,
``_jax_msvit``); the sampled-neighbour modes reach the JAX package's mode
kernels as one traced scalar, as its random-shift training passes them, so
that one compilation serves modes 1..8.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vil_tpu.models import attention as jax_attention
from vil_tpu.models.msvit import MsViT as JaxMsViT
from vil_tpu.ops import rpe as jax_rpe
from vil_tpu.ops.pallas import full_attention as jax_full_attention
from vil_tpu.ops.pallas import layer_norm as jax_ln
from vil_tpu.ops.pallas import vil_backward as jax_vil_backward
from vil_tpu.ops.pallas import vil_block as jax_vil_block
from vil_tpu.ops.pallas import vil_kernel as jax_vil_kernel
from vil_tpu.ops.pallas import vil_mode_kernel as jax_mode_kernel
from vil_tpu.train import loss as jax_loss

from vil_tpu_torch import parallel
from vil_tpu_torch.models import MsViT, build_model, precompute_rpe_cache
from vil_tpu_torch.models.attention import FullAttention, VilAttention, full_rpe_bias
from vil_tpu_torch.ops import rpe
from vil_tpu_torch.ops import sliding_chunk as sc
from vil_tpu_torch.ops.kernels import KERNELS
from vil_tpu_torch.train import loss, optim, recipe
from vil_tpu_torch.utils import jax_import
from vil_tpu_torch.utils.jax_import import load_jax_params

COMMON = dict(attn_type="longformerhand", sharew=True, norm_embed=True)
# narrow 4-stage RPE model: a 16² stage-1 grid of 4×4 chunks with one global
# token, a cyclic 2×2 grid with two, then dense stages at N 1 + 16 and 4
ARCH_RPE = ("l1,h2,d32,n1,s1,g1,p4,f4,a0_l2,h2,d32,n1,s1,g2,p2,f4,a0_"
            "l3,h2,d32,n1,s0,g1,p2,f4,a0_l4,h2,d32,n1,s0,g0,p2,f4,a0")
# a padded 14² stage-1 grid (4×4 chunks of 4×4), RPE in stages 1 and 3 only
ARCH_PAD_RPE = "l1,h2,d32,n1,s1,g1,p4,f4,a0_l2,h2,d64,n1,s1,g2,p2,f4_l3,h2,d64,n1,s0,g1,p2,f4,a0"
TABLES = ("local_relative_position_bias_table", "g2l_relative_position_bias",
          "g2g_relative_position_bias")


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
    """Run the JAX package's Pallas kernels in interpret mode."""
    for mod in (jax_vil_kernel, jax_vil_backward, jax_full_attention, jax_mode_kernel,
                jax_vil_block, jax_ln):
        monkeypatch.setattr(mod, "INTERPRET", True)


def _t(a):
    return None if a is None else torch.from_numpy(np.asarray(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


def _big_tables(params, seed):
    """``params`` with every relative-position table drawn at σ = 1."""
    rng = np.random.default_rng(seed)

    def walk(tree):
        return {k: walk(v) if isinstance(v, dict) else
                (rng.standard_normal(v.shape).astype(np.float32) if k in TABLES else v)
                for k, v in tree.items()}

    return walk(params)


def _torch_tree(tree) -> dict:
    """A flax-shaped tree under the port's names and layouts."""
    return {name: arr for name, arr in (jax_import._to_torch_leaf(n, np.asarray(a))
                                        for n, a in jax_import._flatten(tree))}


def _close_grads(module, ref_grads, tol=1e-4):
    """Every parameter gradient of ``module`` against the flax tree
    ``ref_grads``, to ``tol`` of max(1, max|ref|); the tables must be there."""
    ref = _torch_tree(ref_grads)
    names = {n for n, _ in module.named_parameters()}
    assert set(ref) == names and any(n.endswith(TABLES[0]) for n in names)
    for name, p in module.named_parameters():
        scale = max(1.0, float(np.abs(ref[name]).max()))
        np.testing.assert_allclose(p.grad.numpy(), ref[name], atol=tol * scale, rtol=0,
                                   err_msg=name)


# --------------------------------------------------------------- index tables

@pytest.mark.parametrize("w", range(2, 10))
def test_rpe_index_tables_equal_jax(w):
    """``ops/rpe.py`` is the JAX package's, bit for bit: the sliding-chunk
    index at W, its slices at modes -1, 0 and 1..8 and their stack, and the
    dense index on every grid up to 14×14 whose side is W or 14."""
    assert np.array_equal(rpe.sliding_chunk_rpe_index(w), jax_rpe.sliding_chunk_rpe_index(w))
    for mode in range(-1, 9):
        ours = rpe.sliding_chunk_rpe_index_mode(w, mode)
        assert ours.dtype == np.int32
        assert np.array_equal(ours, jax_rpe.sliding_chunk_rpe_index_mode(w, mode)), mode
    assert np.array_equal(rpe.all_mode_rpe_indices(w), jax_rpe.all_mode_rpe_indices(w))
    for wx, wy in {(w, w), (w, 14), (14, w), (1, w), (w, 1), (14, 14)}:
        ours = rpe.full_rpe_index(wx, wy)
        assert ours.dtype == np.int32 and np.array_equal(ours, jax_rpe.full_rpe_index(wx, wy))


# ------------------------------------------------------------------- modules

@pytest.mark.parametrize("nglo", [0, 1])
def test_full_attention_rpe_matches_flax(interpret, nglo):
    """FullAttention(rpe) against flax FullAttention(rpe=True,
    use_pallas=True) on a 3×4 grid: the output, and the gradients of the
    qkv and proj weights and of the tables."""
    wx, wy, C, H, B = 3, 4, 16, 2, 2
    N = nglo + wx * wy
    rng = np.random.default_rng(50 + nglo)
    x = rng.standard_normal((B, N, C)).astype(np.float32)
    g = rng.standard_normal((B, N, C)).astype(np.float32)
    flax_mod = jax_attention.FullAttention(dim=C, num_heads=H, rpe=True, wx=wx, wy=wy,
                                           nglo=nglo, use_pallas=True)
    params = jax.tree_util.tree_map(np.asarray, flax_mod.init(
        {"params": jax.random.PRNGKey(0)}, jnp.asarray(x), wx, wy, True)["params"])
    params = _big_tables(params, 51)
    assert set(params) == {"qkv", "proj", *TABLES[:1 + 2 * bool(nglo)]}

    def f(p):
        out = flax_mod.apply({"params": p}, jnp.asarray(x), wx, wy, True)
        return jnp.sum(out * g), out

    (_, ref), ref_grads = jax.jit(jax.value_and_grad(f, has_aux=True))(params)
    ours = load_jax_params(FullAttention(dim=C, num_heads=H, rpe=True, wx=wx, wy=wy,
                                         nglo=nglo), params)
    out = ours(_t(x), wx, wy)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)
    (out * _t(g)).sum().backward()
    _close_grads(ours, ref_grads)
    with pytest.raises(ValueError, match="nglo"):
        ours(_t(x)[:, 1:], wx, wy)


def _vil_case(seed, nglo, C=24, nx=7, ny=8, B=2):
    rng = np.random.default_rng(seed)
    x_glo = rng.standard_normal((B, nglo, C)).astype(np.float32) if nglo else None
    x_img = sc.chunkify(_t(rng.standard_normal((B, nx * ny, C)).astype(np.float32)),
                        nx, ny, 3).numpy()
    g_glo = rng.standard_normal((B, nglo, C)).astype(np.float32) if nglo else None
    g_img = rng.standard_normal(x_img.shape).astype(np.float32)
    return x_glo, x_img, g_glo, g_img


@functools.lru_cache(maxsize=None)
def _flax_vil(shapes, nx, ny, fused, kw):
    """flax VilAttention(rpe=True) of ``kw`` on inputs of ``shapes`` ((x_glo
    or None, x_img) shapes), built once per configuration: the module, its
    initial parameters (they depend on the shapes alone) and its jitted
    gradient of Σ out·g, at mode 0 (static) and at a traced mode 1..8."""
    kw = dict(kw)
    flax_mod = jax_attention.VilAttention(dim=shapes[1][-1], sharew=True, rpe=True,
                                          use_pallas=True, **kw)
    x_jax = tuple(None if s is None else jnp.zeros(s, jnp.float32) for s in shapes)
    params = jax.tree_util.tree_map(np.asarray, flax_mod.init(
        {"params": jax.random.PRNGKey(0)}, x_jax, nx, ny, True)["params"])

    def f(p, x_glo, x_img, g_glo, g_img, mode):
        out_glo, out_img = flax_mod.apply({"params": p}, (x_glo, x_img), nx, ny, True, mode)
        s = jnp.sum(out_img * g_img)
        return (s if out_glo is None else s + jnp.sum(out_glo * g_glo)), (out_glo, out_img)

    grad = jax.value_and_grad(f, has_aux=True)
    return params, jax.jit(functools.partial(grad, mode=0)), jax.jit(grad)


def _vil_pair(x_glo, x_img, g_glo, g_img, nx, ny, mode, seed, fused=False, **kw):
    """flax VilAttention(rpe=True) and the port's, the same σ = 1 tables:
    (ref outputs, ref gradients, our module, our outputs)."""
    C = x_img.shape[-1]
    shapes = (None if x_glo is None else x_glo.shape, x_img.shape)
    params, grad0, grad_mode = _flax_vil(shapes, nx, ny, fused, tuple(sorted(kw.items())))
    params = _big_tables(params, seed)
    args = (params, _j(x_glo), jnp.asarray(x_img), _j(g_glo), jnp.asarray(g_img))
    (_, ref), ref_grads = grad0(*args) if mode == 0 else grad_mode(*args, jnp.int32(mode))
    ours = load_jax_params(VilAttention(dim=C, rpe=True, fused_block=fused, **kw), params)
    out_glo, out_img = ours((_t(x_glo), _t(x_img)), nx, ny, mode)
    s = (out_img * _t(g_img)).sum()
    (s if out_glo is None else s + (out_glo * _t(g_glo)).sum()).backward()
    return ref, ref_grads, ours, (out_glo, out_img)


# (mode, nglo, SW_EXACT): mode 0 at every Nglo and SW_EXACT; the sampled
# modes 1, 4 (chunk index mode − 1), 5 and 8 (chunk index mode) at every
# Nglo under SW_EXACT 0 and -1 (SW_EXACT 1 has no tables for them)
VIL_CASES = ([(0, nglo, exact) for nglo in (0, 1, 2) for exact in (0, 1, -1)]
             + [(mode, nglo, exact) for mode in (1, 4, 5, 8) for nglo in (0, 1, 2)
                for exact in ((0, -1) if (mode + nglo) % 2 else (-1, 0))[:1 + (nglo == 1)]])


@pytest.mark.parametrize("mode,nglo,exact", VIL_CASES)
def test_vil_attention_rpe_matches_flax(interpret, mode, nglo, exact):
    """VilAttention(rpe) against flax VilAttention(rpe=True, use_pallas=True)
    on a padded 3×3 grid of 3×3 chunks, through the sliding-chunk kernels
    at mode 0 and the sampled-neighbour kernels at modes 1..8 (front-order
    bias here, tail order there): both outputs and every gradient, the
    three tables' included."""
    nx, ny = 7, 8
    case = _vil_case(60 + 3 * mode + nglo, nglo)
    ref, ref_grads, ours, out = _vil_pair(*case, nx, ny, mode, 61 + mode, num_heads=3, w=3,
                                          nglo=nglo, exact=exact)
    for a, b in zip(out, ref):
        if b is None:
            assert a is None
        else:
            np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), atol=1e-5, rtol=1e-5)
    _close_grads(ours, ref_grads)


@pytest.mark.parametrize("nglo,exact", [(1, 0), (0, -1), (2, 1)])
def test_fused_block_rpe_matches_flax(interpret, monkeypatch, nglo, exact):
    """VilAttention(rpe, fused_block) against flax's with FUSED_BLOCK and
    ``vil_block.INTERPRET``: the fused block takes the front-order bias
    and returns its gradient; outputs and every gradient."""
    monkeypatch.setattr(jax_attention, "FUSED_BLOCK", True)
    calls = []
    make = jax_vil_block.make_fused_vil_block
    monkeypatch.setattr(jax_vil_block, "make_fused_vil_block",
                        lambda *a: calls.append(1) or make(*a))
    nx, ny = 7, 8
    case = _vil_case(70 + nglo, nglo, C=48)
    ref, ref_grads, ours, out = _vil_pair(*case, nx, ny, 0, 71, fused=True, num_heads=3,
                                          w=3, nglo=nglo, exact=exact)
    assert calls  # the JAX module took its fused route
    for a, b in zip(out, ref):
        if b is not None:
            np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), atol=1e-5, rtol=1e-5)
    _close_grads(ours, ref_grads)


# --------------------------------------------------------------- whole model

@functools.lru_cache(maxsize=None)
def _jax_msvit(arch, img):
    """vil_tpu's MsViT of ``arch`` at ``img`` px, built once per (arch, img):
    its parameter shapes, its jitted logits, and its jitted loss gradient
    (at mode 0 without ``modes``, else at the traced per-layer vector)."""
    jax_model = JaxMsViT(arch=arch, img_size=img, num_classes=10, use_pallas=True, **COMMON)
    shapes = jax.eval_shape(lambda: jax_model.init({"params": jax.random.PRNGKey(0)},
                                                   jnp.zeros((1, img, img, 3))))["params"]
    logits = jax.jit(lambda p, x: jax_model.apply({"params": p}, x))

    def loss_fn(p, x, labels, modes=None):
        kw = {} if modes is None else dict(mode=modes)
        out = jax_model.apply({"params": p}, x, deterministic=False, **kw)
        return jax_loss.cross_entropy(out, labels)

    return shapes, logits, jax.jit(jax.value_and_grad(loss_fn))


def _flax_params(ours, shapes):
    """The port model's parameters as the flax tree of ``shapes``."""
    params = {n: p.detach().float().numpy() for n, p in ours.named_parameters()}

    def leaf(path, sds):
        name = ".".join(str(k.key) for k in path)
        arr = params[jax_import._to_torch_leaf(name, np.zeros(sds.shape, np.float32))[0]]
        if name.endswith("kernel"):
            arr = arr.T if arr.ndim == 2 else arr.transpose(2, 3, 1, 0)
        assert arr.shape == sds.shape, name
        return jnp.asarray(arr)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _rpe_model(arch=ARCH_RPE, img=64, seed=0, **kw):
    return MsViT(arch, img_size=img, num_classes=10, device="cpu",
                 generator=torch.Generator().manual_seed(seed), **COMMON, **kw)


@torch.no_grad()
def _draw_tables(model, seed, std=1.0):
    gen = torch.Generator().manual_seed(seed)
    for name, p in model.named_parameters():
        if "relative_position" in name:
            p.copy_(torch.randn(p.shape, generator=gen) * std)


@pytest.mark.parametrize("arch,img,modes", [(ARCH_RPE, 64, None), (ARCH_RPE, 64, [5, 8, 0, 0]),
                                            (ARCH_PAD_RPE, 56, None)],
                         ids=["mode0", "modes-5-8", "padded"])
def test_msvit_rpe_matches_jax(interpret, arch, img, modes):
    """The narrow a0 model against vil_tpu's MsViT: eval logits, then the
    training loss and every parameter gradient, the tables of every block
    included (drop path 0), at mode 0 or at a per-layer mode vector. The
    port's parameters reach JAX through the flax tree; the tree loads back
    with ``load_jax_params``, strictly."""
    rng = np.random.default_rng(80)
    x = rng.standard_normal((2, img, img, 3)).astype(np.float32)
    labels = np.array([3, 7])
    ours = _rpe_model(arch, img)
    _draw_tables(ours, 81)
    shapes, jax_logits, jax_grad = _jax_msvit(arch, img)
    params = _flax_params(ours, shapes)
    twin = load_jax_params(_rpe_model(arch, img, seed=1), jax.tree_util.tree_map(np.asarray,
                                                                                  params))
    for (name, a), (_, b) in zip(ours.named_parameters(), twin.named_parameters()):
        torch.testing.assert_close(a, b, atol=0, rtol=0, msg=name)
    ref_logits = jax_logits(params, jnp.asarray(x))
    with torch.inference_mode():
        logits = twin.eval()(_t(x))
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits), atol=2e-4, rtol=1e-3)

    ref_loss, ref_grads = jax_grad(params, jnp.asarray(x), jnp.asarray(labels),
                                   None if modes is None else jnp.array(modes))
    out = loss.cross_entropy(twin.train()(_t(x), mode=0 if modes is None else modes),
                             _t(labels))
    out.backward()
    np.testing.assert_allclose(out.item(), float(ref_loss), atol=2e-4, rtol=1e-3)
    ref = _torch_tree(ref_grads)
    tables = [n for n, _ in twin.named_parameters() if "relative_position" in n]
    assert len(tables) == (10 if arch == ARCH_RPE else 6)
    for name, p in twin.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), ref[name], atol=2e-4, rtol=1e-3,
                                   err_msg=name)


def test_rpe_spatial_forward_matches_classic():
    """The spatial route (no process group: the halos are slices) of an
    RPE model equals its classic forward: the bias and g2g/g2l reach the
    halo tier and the spread global branch."""
    model = _rpe_model()
    _draw_tables(model, 90)
    x = torch.from_numpy(np.random.default_rng(91).standard_normal((2, 64, 64, 3))
                         .astype(np.float32))
    with torch.inference_mode():
        ref = model.eval()(x)
        out = parallel.spatial_forward(model, parallel.shard_image(x, model))
    torch.testing.assert_close(out, ref, atol=1e-5, rtol=1e-5)


def test_rpe_tables_reach_every_kernel_and_counters_stay_zero():
    """With the kernels or the plain versions the RPE model computes the
    same logits on the CPU (the wrappers run their plain versions), no
    kernel launches, and tables drawn at σ = 1 move the logits against
    zero tables."""
    for fn in KERNELS:
        fn.launches = 0
    x = torch.from_numpy(np.random.default_rng(92).standard_normal((2, 64, 64, 3))
                         .astype(np.float32))
    outs = {}
    for key, use_kernels, std in (("kernels", True, 1.0), ("plain", False, 1.0),
                                  ("zero", True, 0.0)):
        model = _rpe_model(use_kernels=use_kernels).eval()
        _draw_tables(model, 93, std)
        with torch.inference_mode():
            outs[key] = model(x)
    torch.testing.assert_close(outs["kernels"], outs["plain"], atol=0, rtol=0)
    # far above f32 rounding (1e-7), at random weights of σ 0.02
    assert (outs["kernels"] - outs["zero"]).abs().max() > 1e-4
    assert [fn.launches for fn in KERNELS] == [0] * len(KERNELS)


def test_table_gradients_are_deterministic():
    """Two backwards of one step give the tables the same bits (the
    gather's and the skew assembly's backwards sum each row's terms in one
    fixed order)."""
    x = torch.from_numpy(np.random.default_rng(94).standard_normal((2, 64, 64, 3))
                         .astype(np.float32))
    grads = []
    for _ in range(2):
        model = _rpe_model().train()
        _draw_tables(model, 95)
        loss.cross_entropy(model(x), torch.tensor([1, 2])).backward()
        grads.append({n: p.grad.clone() for n, p in model.named_parameters()
                      if "relative_position" in n})
    # (the global queries of a stage's last block reach no output: their g2g
    # and g2l[0] gradients are 0 in either port)
    for name, g in grads[0].items():
        assert "local" not in name or g.abs().max() > 0, name
        torch.testing.assert_close(g, grads[1][name], atol=0, rtol=0, msg=name)


def test_full_rpe_bias_layout():
    """The dense bias puts g2g and g2l[0] on the global queries' rows and
    g2l[1] on the local queries' global columns, the local table by
    relative offset (dx, dy) → (dx + wx − 1)(2wy − 1) + dy + wy − 1."""
    wx, wy, H, nglo = 2, 3, 2, 1
    table = torch.arange((2 * wx - 1) * (2 * wy - 1) * H, dtype=torch.float32).reshape(-1, H)
    g2l = torch.tensor([[[100.0], [101.0]], [[200.0], [201.0]]])
    g2g = torch.tensor([[[300.0]], [[301.0]]])
    bias = full_rpe_bias(table, g2l, g2g, wx, wy)
    assert bias.shape == (H, 7, 7) and bias.dtype == torch.float32
    assert (bias[:, 0, 0] == g2g[:, 0, 0]).all()
    assert (bias[1, 0, 1:] == 101.0).all() and (bias[0, 1:, 0] == 200.0).all()
    # query (1, 2), key (0, 0): dx 1, dy 2 → row (1 + 1)·5 + 2 + 2 = 14
    assert bias[1, 1 + 1 * wy + 2, 1 + 0].item() == table[14, 1].item()


# ------------------------------------------------------------- serving cache

def _serve(model, x):
    with torch.inference_mode():
        return model.eval()(x)


def test_rpe_cache_equals_uncached_path():
    """precompute_rpe_cache assembles every block's bias once; eval logits
    read it and equal the uncached ones bit for bit."""
    model = _rpe_model()
    _draw_tables(model, 100)
    x = torch.from_numpy(np.random.default_rng(101).standard_normal((2, 64, 64, 3))
                         .astype(np.float32))
    ref = _serve(model, x)
    assert precompute_rpe_cache(model) is model
    blocks = [m for m in model.modules() if isinstance(m, (FullAttention, VilAttention))]
    assert len(blocks) == 4 and all(m._rpe_cache is not None for m in blocks)
    calls = []
    for m in blocks:
        assemble = m._assemble_rpe
        m._assemble_rpe = lambda mode, a=assemble: calls.append(mode) or a(mode)
    torch.testing.assert_close(_serve(model, x), ref, atol=0, rtol=0)
    assert not calls  # served from the cache


def test_rpe_cache_is_ignored_in_training():
    """A training forward assembles its bias from the tables, so the tables
    get their gradients; the cache stays for the next eval forward."""
    x = torch.from_numpy(np.random.default_rng(102).standard_normal((2, 64, 64, 3))
                         .astype(np.float32))
    grads = []
    for cached in (False, True):
        model = _rpe_model()
        _draw_tables(model, 103)
        if cached:
            precompute_rpe_cache(model)
        loss.cross_entropy(model.train()(x), torch.tensor([1, 2])).backward()
        grads.append({n: p.grad.clone() for n, p in model.named_parameters()
                      if "relative_position" in n})
    block = model.stage3_block0_attn.attn
    assert block._rpe_cache is not None
    calls = []
    assemble = block._assemble_from  # the dense bias from the tables, either route
    block._assemble_from = lambda *tables: calls.append(len(tables)) or assemble(*tables)
    # eval with a gradient to take: assembled in the forward, and rebuilt in
    # the backward by the kernels' autograd Function
    model.eval()(x).sum().backward()
    assert calls == [3, 3]
    _serve(model, x)  # serving: the cache
    assert calls == [3, 3]
    for name, g in grads[0].items():
        assert "local" not in name or g.abs().max() > 0, name
        torch.testing.assert_close(grads[1][name], g, atol=0, rtol=0, msg=name)


@pytest.mark.parametrize("change", ["load_jax_params", "optimizer_step", "to", "copy_"])
def test_rpe_cache_is_never_served_stale(change):
    """A cache built before the tables change is dropped, not served: the
    logits after the change equal those of an uncached twin with the same
    weights."""
    x = torch.from_numpy(np.random.default_rng(104).standard_normal((2, 64, 64, 3))
                         .astype(np.float32))
    model = _rpe_model()
    _draw_tables(model, 105)
    precompute_rpe_cache(model)
    before = _serve(model, x)
    if change == "load_jax_params":
        fresh = _rpe_model()
        _draw_tables(fresh, 106)
        tree = {}
        for name, p in fresh.named_parameters():  # the flax layout of each leaf
            node = tree
            *path, leaf = name.split(".")
            for key in path:
                node = node.setdefault(key, {})
            arr = p.detach().numpy()
            if leaf == "weight" and arr.ndim == 2:
                node["kernel"] = arr.T
            elif leaf == "weight" and arr.ndim == 4:
                node["kernel"] = arr.transpose(2, 3, 1, 0)
            elif leaf == "weight":
                node["scale"] = arr
            else:
                node[leaf] = arr
        load_jax_params(model, tree)
    elif change == "optimizer_step":
        opt = optim.get_opt(recipe.vil_small_cfg(), model, lr=1e-2)
        loss.cross_entropy(model.train()(x), torch.tensor([1, 2])).backward()
        opt.step()
    elif change == "to":
        model = model.to(torch.bfloat16)
    else:
        with torch.no_grad():
            model.stage1_block0_attn.attn.g2l_relative_position_bias.mul_(3.0)
    after = _serve(model, x)
    uncached = _rpe_model(param_dtype=torch.bfloat16 if change == "to" else torch.float32)
    uncached.load_state_dict(model.state_dict())
    torch.testing.assert_close(after, _serve(uncached, x), atol=0, rtol=0)
    assert (after - before).abs().max() > 1e-6  # the change shows (f32 rounding: 1e-8)
    dropped = {n: m._rpe_cache is None for n, m in model.named_modules()
               if isinstance(m, (FullAttention, VilAttention))}
    # an in-place write to one block's table drops that block's cache alone
    assert dropped == {n: change != "copy_" or n == "stage1_block0_attn.attn" for n in dropped}


# --------------------------------------------------------- optimizer, builders

def test_rpe_tables_are_in_the_no_decay_group():
    """The three tables of every block get WD0, as every parameter whose
    name holds ``relative_position`` does in the JAX package."""
    model = _rpe_model()
    tables = {n for n, _ in model.named_parameters() if "relative_position" in n}
    assert len(tables) == 10
    mask = optim.decay_mask(model)
    assert not any(mask[n] for n in tables)
    decay, no_decay = optim.param_groups(model, 0.05, 0.0, decoupled=True)
    ids = {id(p) for p in no_decay["params"]}
    named = dict(model.named_parameters())
    assert all(id(named[n]) in ids for n in tables) and no_decay["weight_decay"] == 0.0
    assert not {id(p) for p in decay["params"]} & ids


def test_build_model_and_recipe_build_vil_small_rpe():
    """vil_small_cfg(rpe=True) carries ViL-Small's ARCH with a0 in every
    stage; build_model builds it (any a0 stage of a small arch too), with
    the JAX package's table shapes: (4W−1)² rows in the sliding-chunk
    stages, (2wx−1)(2wy−1) in the dense ones, g2l and g2g where Nglo > 0."""
    cfg = recipe.vil_small_cfg(rpe=True)
    assert cfg.MODEL.VIT.MSVIT.ARCH == (
        "l1,h3,d96,n1,s1,g1,p4,f7,a0_l2,h3,d192,n2,s1,g1,p2,f7,a0_"
        "l3,h6,d384,n8,s0,g1,p2,f7,a0_l4,h12,d768,n1,s0,g0,p2,f7,a0")
    assert recipe.rpe_arch("l1,h2,a1_l2,h3") == "l1,h2,a0_l2,h3,a0"
    model = build_model(cfg, device="cpu")
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters() if "relative_position" in n}
    assert len(shapes) == 3 * 11 + 1
    assert shapes["stage1_block0_attn.attn.local_relative_position_bias_table"] == (729, 3)
    assert shapes["stage2_block1_attn.attn.g2l_relative_position_bias"] == (2, 3, 1)
    assert shapes["stage3_block7_attn.attn.local_relative_position_bias_table"] == (729, 6)
    assert shapes["stage3_block7_attn.attn.g2g_relative_position_bias"] == (6, 1, 1)
    assert shapes["stage4_block0_attn.attn.local_relative_position_bias_table"] == (169, 12)
    assert "stage4_block0_attn.attn.g2l_relative_position_bias" not in shapes
    small = _rpe_model(ARCH_PAD_RPE, 56)
    assert small.stage2_block0_attn.attn.rpe is False
    assert small.stage3_block0_attn.attn.local_relative_position_bias_table.shape == (25, 2)
