"""The paper's other attention families in the port against ``vil_tpu`` on the CPU.

Linformer, SRformer and Performer (``models/attention_efficient.py``), the
only-global and unshared-global ViL (``models/attention.py``), the
performer's redraw (``train/redraw.py``) and the MAC count
(``ops/flops.py``). Inputs come from ``np.random.default_rng``; the JAX side
runs with ``use_pallas=False``. The performer's projection cannot be drawn
alike in the two frameworks, so each test carries one side's buffer to the
other. Limits: single modules' outputs and gradients ≤ 1e-5 of max|ref|,
whole models' f32 logits ≤ 1e-4 and every parameter gradient ≤ 1e-4 of its
max|ref|, bf16 logits ≤ 2.5e-2 of max|ref| (``chip_smoke.py``'s serve limit).

One leaf is held apart: the gradient of the SRformer's ``proj_sr``. The
instance norm after it runs in f32 on both sides (in ``vil_tpu`` under f64
too), and its gradient reaches the convolution's weight as a sum over
positions whose terms cancel (the norm takes out each channel's mean). The
two frameworks sum in different orders, and that alone moves the weight's
gradient by 1.4-5.4e-5 of its max in a module (measured with every other
operation in f64 on both sides) and 1.2e-4 in a model; it is held to
``SR_CONV_TOL`` there.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vil_tpu.models import attention_efficient as jax_eff
from vil_tpu.models.msvit import MsViT as JaxMsViT
from vil_tpu.ops import flops as jax_flops
from vil_tpu.train import redraw as jax_redraw

from vil_tpu_torch.models import MsViT
from vil_tpu_torch.models import attention_efficient as eff
from vil_tpu_torch.ops import flops
from vil_tpu_torch.train import recipe, redraw
from vil_tpu_torch.utils import jax_import
from vil_tpu_torch.utils.jax_import import load_jax_params

MODULE_TOL = 1e-5
LOGITS_TOL = 1e-4
GRAD_TOL = 1e-4
BF16_TOL = 2.5e-2
SR_CONV_TOL = {"module": 1e-4, "model": 3e-4}


def _rng(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _scaled(out, ref) -> float:
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(out - ref).max() / max(np.abs(ref).max(), 1e-30))


def _torch_tree(tree) -> dict:
    """A flax-shaped tree under the port's names and layouts."""
    return {name: arr for name, arr in (jax_import._to_torch_leaf(n, np.asarray(a))
                                        for n, a in jax_import._flatten(tree))}


def _flax_tree(tensors: dict, shapes):
    """The port's tensors {name: tensor} as a flax tree shaped like
    ``shapes``: the inverse of ``load_jax_params``."""

    def leaf(path, sds):
        name = ".".join(str(k.key) for k in path)
        arr = tensors[jax_import._to_torch_leaf(name, np.zeros(sds.shape, np.float32))[0]]
        arr = arr.detach().float().numpy()
        if name.endswith("kernel"):
            arr = arr.T if arr.ndim == 2 else arr.transpose(2, 3, 1, 0)
        assert arr.shape == sds.shape, name
        return jnp.asarray(arr)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


# -- single modules ------------------------------------------------------------------
MODULES = {
    # name: (flax module, port module, nx, ny, nglo)
    "linformer-shared": (lambda: jax_eff.LinformerAttention(dim=32, seq_len=17, num_feats=8,
                                                            num_heads=2, share_kv=True),
                         lambda: eff.LinformerAttention(32, 17, 8, 2, share_kv=True), 4, 4, 1),
    "linformer-unshared": (lambda: jax_eff.LinformerAttention(dim=32, seq_len=18, num_feats=5,
                                                              num_heads=4, share_kv=False),
                           lambda: eff.LinformerAttention(32, 18, 5, 4, share_kv=False),
                           4, 4, 2),
    # 7×7 reduced grids, as ViL-Small's stages have them
    "srformer-r2": (lambda: jax_eff.SRAttention(dim=32, rratio=2, num_heads=2),
                    lambda: eff.SRAttention(32, 2, 2), 14, 14, 1),
    # 15 rows and columns at a stride of 2: the VALID convolution drops one
    "srformer-r2-valid": (lambda: jax_eff.SRAttention(dim=32, rratio=2, num_heads=4),
                          lambda: eff.SRAttention(32, 2, 4), 15, 15, 1),
    "srformer-r4": (lambda: jax_eff.SRAttention(dim=16, rratio=4, num_heads=1),
                    lambda: eff.SRAttention(16, 4, 1), 28, 28, 2),
    "performer-f8": (lambda: jax_eff.PerformerAttention(dim=32, num_heads=2, nb_features=8),
                     lambda: eff.PerformerAttention(32, 2, 8), 4, 4, 1),
    # nb_features 0: int(M log M) = 44 at M = 16, two full blocks and a remainder
    "performer-mlogm": (lambda: jax_eff.PerformerAttention(dim=32, num_heads=2, nb_features=0),
                        lambda: eff.PerformerAttention(32, 2, 0), 5, 4, 1),
}


@pytest.mark.parametrize("name", list(MODULES))
def test_module_matches_flax(name):
    """Output, input gradient and every parameter gradient, f32."""
    make_flax, make_port, nx, ny, nglo = MODULES[name]
    flax_mod = make_flax()
    dim = flax_mod.dim
    x = _rng(1, 2, nglo + nx * ny, dim)
    g = _rng(2, 2, nglo + nx * ny, dim)
    variables = flax_mod.init({"params": jax.random.PRNGKey(0)}, jnp.asarray(x), nx, ny)
    params = variables["params"]
    buffers = variables.get("buffers")

    def f(p, xx):
        out = flax_mod.apply({"params": p, **({"buffers": buffers} if buffers else {})},
                             xx, nx, ny)
        return jnp.sum(out * jnp.asarray(g)), out

    (_, ref), (ref_dp, ref_dx) = jax.jit(jax.value_and_grad(f, argnums=(0, 1), has_aux=True))(
        params, jnp.asarray(x))
    ours = load_jax_params(make_port(), params, buffers)
    xt = torch.from_numpy(x).requires_grad_()
    out = ours(xt, nx, ny)
    out.backward(torch.from_numpy(g))
    assert _scaled(out.detach(), ref) <= MODULE_TOL
    assert _scaled(xt.grad, ref_dx) <= MODULE_TOL
    ref_grads = _torch_tree(ref_dp)
    grads = {n: p.grad for n, p in ours.named_parameters()}
    assert set(grads) == set(ref_grads)
    for n, grad in grads.items():
        tol = SR_CONV_TOL["module"] if n == "proj_sr.weight" else MODULE_TOL
        assert _scaled(grad, ref_grads[n]) <= tol, n


def test_linformer_asserts_its_sequence_length():
    with pytest.raises(ValueError, match="must be 17 - 16 given"):
        eff.LinformerAttention(32, 17, 8, 2)(torch.zeros(1, 16, 32), 4, 4)


@pytest.mark.parametrize("rows,cols", [(5, 8), (8, 8), (19, 8)])
def test_gaussian_orthogonal_random_matrix_blocks(rows, cols):
    """Each block of ``cols`` rows is orthogonal, every row scaled by its
    own norm; ``scaling`` 1 gives norms √cols; one seed draws one matrix."""
    draw = lambda scaling=0: eff.gaussian_orthogonal_random_matrix(
        rows, cols, scaling, generator=torch.Generator().manual_seed(4))
    mat = draw().double()
    assert mat.shape == (rows, cols) and mat.dtype == torch.float64
    torch.testing.assert_close(draw(), draw(), atol=0, rtol=0)
    unit = mat / mat.norm(dim=1, keepdim=True)
    for start in range(0, rows, cols):
        block = unit[start:start + cols]
        torch.testing.assert_close(block @ block.T, torch.eye(len(block), dtype=torch.float64),
                                   atol=1e-6, rtol=0)
    norms = draw(1).norm(dim=1)
    torch.testing.assert_close(norms, torch.full((rows,), math.sqrt(cols)), atol=1e-5, rtol=0)
    with pytest.raises(ValueError, match="Invalid scaling"):
        draw(2)


def test_redraw_projections_draws_every_buffer_in_place():
    """Every performer's buffer changes, in place, to a new orthogonal draw;
    the parameters do not; one seed gives the same draw."""
    model = MsViT(ARCHS["performer"], img_size=64, num_classes=5, attn_type="performer",
                  device="cpu", generator=torch.Generator().manual_seed(0))
    before = {n: b.clone() for n, b in model.named_buffers()}
    ptrs = {n: b.data_ptr() for n, b in model.named_buffers()}
    params = {n: p.clone() for n, p in model.named_parameters()}
    assert len(before) == 2 and all(n.endswith("attn.projection_matrix") for n in before)
    assert redraw.redraw_projections(model, torch.Generator().manual_seed(1)) == 2
    after = dict(model.named_buffers())
    for n, b in after.items():
        assert b.data_ptr() == ptrs[n] and not torch.equal(b, before[n])
    for n, p in model.named_parameters():
        assert torch.equal(p, params[n])
    again = MsViT(ARCHS["performer"], img_size=64, num_classes=5, attn_type="performer",
                  device="cpu", generator=torch.Generator().manual_seed(0))
    redraw.redraw_projections(again, torch.Generator().manual_seed(1))
    for n, b in again.named_buffers():
        assert torch.equal(b, after[n])


def test_redraw_schedule_matches_vil_tpu():
    """Over 3 epochs of 7 steps the redraws fall on the same steps, and a new
    schedule (a resumed Trainer's) counts afresh in both."""
    def steps(schedule, epochs, per_epoch=7):
        out, step = [], 0
        for epoch in epochs:
            schedule.set_epoch(epoch)
            for _ in range(per_epoch):
                if schedule.should_redraw():
                    out.append((epoch, step))
                step += 1
        return out

    ours = steps(redraw.RedrawSchedule(), range(3))
    assert ours == steps(jax_redraw.RedrawSchedule(), range(3))
    assert [s for _, s in ours] == [1, 3, 5, 12]
    resumed = steps(redraw.RedrawSchedule(), [2, 3], 12)
    assert resumed == steps(jax_redraw.RedrawSchedule(), [2, 3], 12)


def test_load_jax_params_buffers_are_strict():
    flax_mod = jax_eff.PerformerAttention(dim=16, num_heads=2, nb_features=4)
    variables = flax_mod.init({"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 5, 16)))
    params, buffers = variables["params"], variables["buffers"]
    ours = load_jax_params(eff.PerformerAttention(16, 2, 4), params, buffers)
    # the port keeps the buffer in f32 (JAX draws it in f64 where another
    # test has turned x64 on in this process)
    np.testing.assert_array_equal(ours.projection_matrix.numpy(),
                                  np.asarray(buffers["projection_matrix"], np.float32))
    with pytest.raises(KeyError, match="unused"):
        load_jax_params(ours, params, {**buffers, "extra": np.zeros(3)})
    with pytest.raises(KeyError, match="projection_matrix"):
        load_jax_params(ours, params, {})
    with pytest.raises(KeyError, match="projection_matrix"):
        load_jax_params(ours, params)


# -- whole models --------------------------------------------------------------------
# 64² images: stage grids 16², 8², then a dense 4²; the last stage has no
# global token, so the global-only model pools (tests/test_msvit.py)
ARCHS = {
    "linformer": "l1,h2,d16,n1,s1,g1,p4,f8_l2,h2,d32,n1,s1,g1,p2,f6_l3,h2,d32,n1,s0,g0,p2,f4",
    "srformer": "l1,h2,d16,n1,s1,g1,p4,f4_l2,h2,d32,n1,s1,g1,p2,f2_l3,h2,d32,n1,s0,g0,p2,f4",
    "performer": "l1,h2,d16,n1,s1,g1,p4,f8_l2,h2,d32,n1,s1,g1,p2,f12_l3,h2,d32,n1,s0,g0,p2,f4",
    "global": "l1,h2,d16,n1,s1,g2,p4,f4_l2,h2,d32,n1,s1,g1,p2,f4_l3,h2,d32,n1,s0,g0,p2,f4",
    # a 14² grid in chunks of 4: padded, its pad keys masked in the global branch
    "unshared": "l1,h2,d16,n1,s1,g1,p4,f4_l2,h2,d32,n1,s1,g2,p2,f4_l3,h2,d32,n1,s0,g1,p2,f4",
}
CASES = {
    "linformer-shared": dict(arch=ARCHS["linformer"], attn_type="linformer", share_kv=True),
    "linformer-unshared": dict(arch=ARCHS["linformer"], attn_type="linformer", share_kv=False),
    "srformer": dict(arch=ARCHS["srformer"], attn_type="srformer"),
    "performer": dict(arch=ARCHS["performer"], attn_type="performer"),
    "global": dict(arch=ARCHS["global"], only_glo=True, avg_pool=True),
    "unshared": dict(arch=ARCHS["unshared"], sharew=False, img_size=56),
}


def _models(case, dtype=torch.float32):
    kw = dict(img_size=64, num_classes=10, norm_embed=True, sharew=True)
    kw.update(CASES[case])
    ours = MsViT(device="cpu", dtype=dtype, generator=torch.Generator().manual_seed(0), **kw)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jax_model = JaxMsViT(use_pallas=False, dtype=jdt, **kw)
    x = _rng(3, 2, kw["img_size"], kw["img_size"], 3)
    shapes = jax.eval_shape(lambda: jax_model.init({"params": jax.random.PRNGKey(0)},
                                                   jnp.asarray(x)))
    variables = {"params": _flax_tree(dict(ours.named_parameters()), shapes["params"])}
    if "buffers" in shapes:
        variables["buffers"] = _flax_tree(dict(ours.named_buffers()), shapes["buffers"])
    return ours, jax_model, variables, x


@pytest.mark.parametrize("case", list(CASES))
def test_msvit_logits_and_gradients_match_jax(case):
    """f32 logits in eval mode, and every parameter gradient of a cross
    entropy in training mode (drop path 0), against ``jax.grad``."""
    ours, jax_model, variables, x = _models(case)
    labels = np.array([3, 7])
    params, rest = variables["params"], {k: v for k, v in variables.items() if k != "params"}

    def loss_fn(p):
        logits = jax_model.apply({"params": p, **rest}, jnp.asarray(x), deterministic=False)
        onehot = jax.nn.one_hot(jnp.asarray(labels), logits.shape[-1])
        return -jnp.mean(jnp.sum(onehot * jax.nn.log_softmax(logits), axis=-1)), logits

    (_, ref_logits), ref_grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    with torch.inference_mode():
        logits = ours.eval()(torch.from_numpy(x))
    assert np.abs(logits.numpy() - np.asarray(ref_logits)).max() <= LOGITS_TOL
    out = ours.train()(torch.from_numpy(x))
    torch.nn.functional.cross_entropy(out, torch.from_numpy(labels)).backward()
    ref = _torch_tree(ref_grads)
    grads = {n: p.grad for n, p in ours.named_parameters()}
    assert set(grads) == set(ref)
    for name, g in grads.items():
        tol = SR_CONV_TOL["model"] if name.endswith("proj_sr.weight") else GRAD_TOL
        if g.numel():  # not the (1, 0, C) position table of a stage without globals
            assert _scaled(g, ref[name]) <= tol, name


@pytest.mark.parametrize("case", ["linformer-shared", "srformer", "performer", "global"])
def test_msvit_bf16_logits_match_jax(case):
    """bf16 compute over f32 parameters on both sides, eval mode, for the
    families whose attention has rounding points of its own (the unshared
    ViL's are the shared one's)."""
    ours, jax_model, variables, x = _models(case, torch.bfloat16)
    ref = jax.jit(lambda v: jax_model.apply(v, jnp.asarray(x)))(variables)
    with torch.inference_mode():
        out = ours.eval()(torch.from_numpy(x))
    assert out.dtype == torch.bfloat16 and torch.isfinite(out).all()
    assert _scaled(out.float(), np.asarray(ref, np.float32)) <= BF16_TOL


# -- MACs ----------------------------------------------------------------------------
@pytest.mark.parametrize("attn_type,sharew,share_kv", [
    ("full", True, True), ("longformerhand", True, True), ("longformerhand", False, True),
    ("linformer", True, True), ("linformer", True, False), ("srformer", True, True),
    ("performer", True, True),
])
def test_model_macs_matches_vil_tpu(attn_type, sharew, share_kv):
    for arch in (recipe.ARCH_ZOO["vil_small"], *(v["arch"] for v in recipe.VARIANTS.values()
                                                if "arch" in v), ARCHS["global"]):
        for img in (224, 64):
            kw = dict(img_size=img, attn_type=attn_type, sharew=sharew, share_kv=share_kv)
            assert flops.model_macs(arch, **kw) == jax_flops.model_macs(arch, **kw)
