"""Relative position bias at high resolution in the port against ``vil_tpu``, on the CPU.

The dense blocks' bias is built by the skew assembly (``models/attention.py``,
``vil_tpu.models.attention._skew_local_bias`` / ``_assemble_full_rpe_bias``)
inside ``FullAttentionRPEFunction`` (``vil_tpu``'s
``make_fused_full_attention_rpe``), which saves the tables and rebuilds the
bias in the backward. Held here:

* the skew assembly equals the gather and ``vil_tpu``'s assembly bit for
  bit; its table gradients agree with both to 1e-6 of max|ref| (sums in
  another order);
* the Function against ``vil_tpu``'s, with the Pallas kernels in interpret
  mode (the whole-image tier, and the q-tiled tier through ``tile_q``): out
  to 1e-5, dq, dk, dv and the tables' gradients to 1e-5 of max|ref|;
* no RPE dense block saves an (H, N, N) tensor for its backward;
* a narrow four-stage ``a0`` MsViT against ``vil_tpu``'s: logits, one
  training loss and every gradient at the repo's atol 2e-4 / rtol 1e-3;
* the biased backwards' grouped dbias partials (B2 by chunk groups, B4 by
  image groups): the wrappers' group arithmetic at the main path's shapes,
  and the plain version of the partials' summation order against the
  ungrouped sum, to 1e-6 of max|ref|.

Inputs come from ``np.random.default_rng``; everything is f32.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vil_tpu.models import attention as jax_attention
from vil_tpu.models.msvit import MsViT as JaxMsViT
from vil_tpu.ops.pallas import full_attention as jax_full_attention
from vil_tpu.ops.pallas import layer_norm as jax_ln
from vil_tpu.ops.pallas import vil_backward as jax_vil_backward
from vil_tpu.ops.pallas import vil_block as jax_vil_block
from vil_tpu.ops.pallas import vil_kernel as jax_vil_kernel
from vil_tpu.ops.pallas import vil_mode_kernel as jax_mode_kernel
from vil_tpu.train import loss as jax_loss

from vil_tpu_torch.models import MsViT
from vil_tpu_torch.models.attention import (
    full_rpe_bias,
    full_rpe_bias_skew,
    skew_local_bias,
)
from vil_tpu_torch.ops.kernels.full_attention import (
    full_attention,
    full_attention_bwd_reference,
    full_attention_rpe,
    image_group,
)
from vil_tpu_torch.ops.kernels.vil_attention import (
    SMS,
    chunk_group,
    group_partials,
    vil_attention_bwd_reference,
    vil_attention_reference,
)
from vil_tpu_torch.train import loss
from vil_tpu_torch.utils import jax_import

COMMON = dict(attn_type="longformerhand", sharew=True, norm_embed=True)
# narrow four-stage a0 model at 96 px: a 24² stage-1 grid of 6×6 chunks, a
# 12² grid of 3×3, then dense stages over 6×6 (N 37) and 3×3 (N 9) grids
ARCH = ("l1,h2,d32,n1,s1,g1,p4,f4,a0_l2,h2,d32,n1,s1,g1,p2,f4,a0_"
        "l3,h2,d32,n1,s0,g1,p2,f4,a0_l4,h2,d32,n1,s0,g0,p2,f4,a0")
IMG = 96


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
    """Run the JAX package's Pallas kernels in interpret mode, the dense
    bias by its default (skew) assembly."""
    for mod in (jax_vil_kernel, jax_vil_backward, jax_full_attention, jax_mode_kernel,
                jax_vil_block, jax_ln):
        monkeypatch.setattr(mod, "INTERPRET", True)
    monkeypatch.delenv("VIL_TPU_RPE_ASSEMBLY", raising=False)


def _tables(rng, wx, wy, H, nglo):
    """(local table, g2l, g2g) as numpy f32 at σ 1; None without globals."""
    table = rng.standard_normal(((2 * wx - 1) * (2 * wy - 1), H)).astype(np.float32)
    if not nglo:
        return table, None, None
    return (table, rng.standard_normal((2, H, nglo)).astype(np.float32),
            rng.standard_normal((H, nglo, nglo)).astype(np.float32))


def _t(a, grad=False):
    return None if a is None else torch.from_numpy(np.asarray(a)).requires_grad_(grad)


def _scaled(ours, ref) -> float:
    """max|err| / max|ref|."""
    ref = np.asarray(ref)
    return float(np.abs(np.asarray(ours) - ref).max() / np.abs(ref).max())


# ------------------------------------------------------------ the assembly

@pytest.mark.parametrize("nglo", [0, 1])
@pytest.mark.parametrize("wx,wy", [(2, 3), (7, 7), (12, 12)])
def test_skew_assembly_equals_gather_and_jax(interpret, wx, wy, nglo):
    """The skew assembly equals the gather and ``vil_tpu``'s skew assembly
    bit for bit (local part and joined bias); the tables' gradients from
    the skew's backward (slices and sums), the gather's (index_put_) and
    ``jax.vjp`` of ``vil_tpu``'s agree to 1e-6 of max|ref|."""
    H = 3
    rng = np.random.default_rng(100 + 10 * wx + nglo)
    tables = _tables(rng, wx, wy, H, nglo)
    N = nglo + wx * wy
    ct = rng.standard_normal((H, N, N)).astype(np.float32)
    present = [t for t in tables if t is not None]

    ref_local = jax_attention._skew_local_bias(wx, wy, H, jnp.asarray(tables[0]))
    assert np.array_equal(skew_local_bias(_t(tables[0]), wx, wy).numpy(), np.asarray(ref_local))
    assemble = lambda *ts: jax_attention._assemble_full_rpe_bias(wx, wy, nglo, H, *ts)
    ref, vjp = jax.vjp(assemble, *map(jnp.asarray, present))
    ref_grads = vjp(jnp.asarray(ct))

    grads = {}
    for name, build in (("skew", full_rpe_bias_skew), ("gather", full_rpe_bias)):
        leaves = [_t(t, grad=True) for t in tables]
        bias = build(*leaves, wx, wy)
        assert bias.shape == (H, N, N) and bias.is_contiguous()
        assert np.array_equal(bias.detach().numpy(), np.asarray(ref)), name
        bias.backward(_t(ct))
        grads[name] = [t.grad.numpy() for t in leaves if t is not None]
    for i, ref_g in enumerate(ref_grads):
        assert _scaled(grads["skew"][i], ref_g) <= 1e-6
        assert _scaled(grads["skew"][i], grads["gather"][i]) <= 1e-6


# ------------------------------------------------------- the autograd Function

def _jax_rpe_reference(q, k, v, g, tables, wx, wy, nglo, H, tile_q):
    """``vil_tpu``'s dense RPE attention and its gradients: through
    ``make_fused_full_attention_rpe`` (whole-image kernels), or with
    ``tile_q`` through the q-tiled forward and backward kernels with the
    biased path, dbias taken back through ``jax.vjp`` of the assembly.
    Returns (out, dq, dk, dv, *table grads)."""
    assemble = functools.partial(jax_attention._assemble_full_rpe_bias, wx, wy, nglo, H)
    present = [jnp.asarray(t) for t in tables if t is not None]
    q, k, v, g = map(jnp.asarray, (q, k, v, g))
    if tile_q is None:
        fused = jax_full_attention.make_fused_full_attention_rpe(H, assemble)
        out, vjp = jax.vjp(fused, q, k, v, *present)
        return (out, *vjp(g))
    bias, assemble_vjp = jax.vjp(assemble, *present)
    out, lse = jax_full_attention._pallas_forward_tiled(q, k, v, H, bias=bias, with_lse=True,
                                                        tile_q=tile_q)
    dq, dk, dv, dbias = jax_full_attention._pallas_backward_tiled(q, k, v, g, lse, H,
                                                                  bias=bias, tile_q=tile_q)
    return (out, dq, dk, dv, *assemble_vjp(dbias))


@pytest.mark.parametrize("wx,wy,nglo,tile_q", [(3, 5, 1, None), (4, 4, 0, None),
                                               (3, 5, 1, 8)],
                         ids=["whole-image", "nglo0", "q-tiled"])
def test_full_attention_rpe_function_matches_jax(interpret, wx, wy, nglo, tile_q):
    """``FullAttentionRPEFunction`` (on the CPU: the plain versions under
    its bias rebuild) against ``vil_tpu``'s RPE attention: out to 1e-5, dq,
    dk, dv and every table's gradient to 1e-5 of max|ref|."""
    B, H, C = 2, 2, 16
    N = nglo + wx * wy
    rng = np.random.default_rng(200 + N)
    q, k, v = (rng.standard_normal((B, N, C)).astype(np.float32) * C ** -0.25
               for _ in range(3))
    g = rng.standard_normal((B, N, C)).astype(np.float32)
    tables = _tables(rng, wx, wy, H, nglo)
    ref = _jax_rpe_reference(q, k, v, g, tables, wx, wy, nglo, H, tile_q)

    leaves = [_t(a, grad=True) for a in (q, k, v)]
    present = [_t(t, grad=True) for t in tables if t is not None]
    assemble = lambda *ts: full_rpe_bias_skew(*ts, *[None] * (3 - len(ts)), wx, wy)
    out = full_attention_rpe(*leaves, assemble, present, H)
    assert type(out.grad_fn).__name__ == "FullAttentionRPEFunctionBackward"
    out.backward(_t(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref[0]), atol=1e-5, rtol=0)
    for name, t, r in zip(("dq", "dk", "dv", "table", "g2l", "g2g"), leaves + present, ref[1:]):
        assert _scaled(t.grad.numpy(), r) <= 1e-5, name


def _saved_shapes(run) -> list:
    """The shapes of every tensor autograd saves while ``run()`` builds its
    graph."""
    shapes = []

    def pack(t):
        shapes.append(tuple(t.shape))
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        run()
    return shapes


def test_rpe_dense_block_saves_no_dense_bias():
    """An RPE dense block saves the tables, not the (H, N, N) bias: in a
    training forward of the narrow a0 model no saved tensor has the shape
    of a dense stage's bias (N 37 and 9 here). The control, a bias passed to
    the kernels' plain Function, is seen by the same hook."""
    model = MsViT(ARCH, img_size=IMG, num_classes=10, device="cpu",
                  generator=torch.Generator().manual_seed(0), **COMMON).train()
    x = torch.randn(2, IMG, IMG, 3, generator=torch.Generator().manual_seed(1))
    shapes = _saved_shapes(lambda: model(x))
    dense = [(2, 37, 37), (2, 9, 9)]
    assert shapes and not set(dense) & set(shapes)
    # the tables are what the dense blocks save: (2·6 − 1)², (2·3 − 1)² rows
    assert (121, 2) in shapes and (25, 2) in shapes
    bias = torch.zeros(2, 9, 9, requires_grad=True)
    qkv = [torch.randn(1, 9, 32, requires_grad=True) for _ in range(3)]
    control = _saved_shapes(lambda: full_attention(*qkv, bias, 2))
    assert (2, 9, 9) in control


# ------------------------------------------------------------- whole model

@functools.lru_cache(maxsize=None)
def _jax_model():
    """``vil_tpu``'s MsViT for ARCH at IMG, its parameter shapes and its
    jitted logits and loss gradient, built once for the file."""
    model = JaxMsViT(arch=ARCH, img_size=IMG, num_classes=10, use_pallas=True, **COMMON)
    shapes = jax.eval_shape(lambda: model.init({"params": jax.random.PRNGKey(0)},
                                               jnp.zeros((1, IMG, IMG, 3))))["params"]
    logits = jax.jit(lambda p, x: model.apply({"params": p}, x))
    grad = jax.jit(jax.value_and_grad(lambda p, x, y: jax_loss.cross_entropy(
        model.apply({"params": p}, x, deterministic=False), y)))
    return shapes, logits, grad


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


def test_msvit_rpe_highres_matches_jax(interpret):
    """The narrow a0 model (dense stages 6×6 and 3×3, their bias by the
    skew assembly inside the Function) against ``vil_tpu``'s MsViT with its
    RPE custom VJP: eval logits, then the training loss and every parameter
    gradient, the tables of all eight blocks included (drop path 0), at
    atol 2e-4, rtol 1e-3."""
    rng = np.random.default_rng(300)
    x = rng.standard_normal((2, IMG, IMG, 3)).astype(np.float32)
    labels = np.array([3, 7])
    model = MsViT(ARCH, img_size=IMG, num_classes=10, device="cpu",
                  generator=torch.Generator().manual_seed(0), **COMMON)
    gen = torch.Generator().manual_seed(301)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if "relative_position" in name:
                p.copy_(torch.randn(p.shape, generator=gen))
    shapes, jax_logits, jax_grad = _jax_model()
    params = _flax_params(model, shapes)
    ref_logits = jax_logits(params, jnp.asarray(x))
    with torch.inference_mode():
        logits = model.eval()(_t(x))
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits), atol=2e-4, rtol=1e-3)

    ref_loss, ref_grads = jax_grad(params, jnp.asarray(x), jnp.asarray(labels))
    out = loss.cross_entropy(model.train()(_t(x)), _t(labels))
    out.backward()
    np.testing.assert_allclose(out.item(), float(ref_loss), atol=2e-4, rtol=1e-3)
    ref = {name: arr for name, arr in (jax_import._to_torch_leaf(n, np.asarray(a))
                                       for n, a in jax_import._flatten(ref_grads))}
    assert len([n for n in ref if "relative_position" in n]) == 10
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), ref[name], atol=2e-4, rtol=1e-3,
                                   err_msg=name)


# ------------------------------------------------- grouped dbias partials

@pytest.mark.parametrize("B,N,H,want", [(8, 4097, 6, 8), (8, 1024, 12, 4), (64, 577, 6, 8),
                                        (64, 144, 12, 8), (64, 197, 6, 4), (2, 17, 2, 1)])
def test_b4_image_group(B, N, H, want):
    """B4's biased pass 1 walks the largest image group that divides the
    batch and keeps two blocks an SM (64-row q tiles × H × groups), or one
    image a block where even that grid is smaller."""
    per = image_group(B, N, H)
    blocks = -(-N // 64) * H
    assert per == want and B % per == 0
    if per > 1:
        assert blocks * (B // per) >= 2 * SMS
    assert all(blocks * (B // d) < 2 * SMS for d in range(per + 1, B + 1) if B % d == 0)


@pytest.mark.parametrize("B,mx,w2,H,want", [(8, 37, 49, 3, 63), (2, 37, 49, 3, 15),
                                            (64, 8, 49, 3, 22), (64, 4, 49, 3, 6),
                                            (64, 14, 49, 3, 66), (8, 19, 49, 3, 17),
                                            (2, 3, 144, 2, 1)])
def test_b2_chunk_group(B, mx, w2, H, want):
    """B2's biased pass 1 walks the fewest chunk groups of an image whose
    grid (groups × 64-row slices × H × B) holds four blocks an SM: every
    chunk in one group, the last group ragged, no group empty."""
    chunks = mx * mx
    per = chunk_group(B, mx, mx, w2, H)
    groups = -(-chunks // per)
    assert per == want and (groups - 1) * per < chunks <= groups * per
    assert groups == chunks or groups * B * H * -(-w2 // 64) >= 4 * SMS


def test_b4_grouped_partials_sum_to_the_batch_dbias():
    """The plain version of B4's image-group partials (each group's images
    summed in order, then the groups) from each image's own dbias equals the
    batch's dbias (the plain backward's) to 1e-6 of max|ref|, for every
    group size that divides the batch."""
    B, N, C, H = 8, 17, 16, 2
    rng = np.random.default_rng(400)
    q, k, v, g = (_t(rng.standard_normal((B, N, C)).astype(np.float32)) for _ in range(4))
    bias = _t(rng.standard_normal((H, N, N)).astype(np.float32))
    ref = full_attention_bwd_reference(q, k, v, bias, g, H)[3]
    terms = torch.stack([full_attention_bwd_reference(q[b:b + 1], k[b:b + 1], v[b:b + 1], bias,
                                                      g[b:b + 1], H)[3] for b in range(B)])
    for per in (1, 2, 4, 8):
        parts = group_partials(terms, per, 0)
        assert parts.shape == (B // per, H, N, N)
        dbias = parts[0] if per == B else parts.sum(dim=0)
        assert _scaled(dbias.numpy(), ref.numpy()) <= 1e-6, per


def test_b2_grouped_partials_sum_to_the_batch_dbias():
    """The plain version of B2's chunk-group partials: each chunk's dS (the
    gradient of a per-chunk additive mask, one image and one head at a
    time) summed in groups of every size 1..9 over a 3×3 grid, the last
    group ragged, then over (image, group) as the wrapper sums them, equals
    the batch's dbias to 1e-6 of max|ref|."""
    B, mx, w, C, H, nglo = 2, 3, 3, 8, 1, 1
    w2, cols = w * w, nglo + 9 * w * w
    rng = np.random.default_rng(500)
    q, k, v = (_t(rng.standard_normal((B, mx, mx, w2, C)).astype(np.float32)) for _ in range(3))
    kg, vg = (_t(rng.standard_normal((B, nglo, C)).astype(np.float32)) for _ in range(2))
    g = _t(rng.standard_normal((B, mx, mx, w2, C)).astype(np.float32))
    bias = _t(rng.standard_normal((H, w2, cols)).astype(np.float32))
    mask = torch.zeros(mx, mx, w2, cols)
    ref = vil_attention_bwd_reference(q, k, v, kg, vg, bias, g, mask, H)[5]
    terms = []  # (B, mx·my, H, w2, cols): image b's dS in chunk (i, j)
    for b in range(B):
        leaf = mask.clone().requires_grad_()
        out = vil_attention_reference(*(t[b:b + 1] for t in (q, k, v, kg, vg)), bias, leaf, H)
        (dterm,) = torch.autograd.grad(out, leaf, g[b:b + 1])
        terms.append(dterm.reshape(mx * mx, H, w2, cols))
    terms = torch.stack(terms)
    for per in range(1, mx * mx + 1):
        groups = -(-mx * mx // per)
        parts = group_partials(terms, per, 1)
        assert parts.shape == (B, groups, H, w2, cols)
        dbias = parts.reshape(B * groups, H, w2, cols).sum(dim=0)
        assert _scaled(dbias.numpy(), ref.numpy()) <= 1e-6, per
