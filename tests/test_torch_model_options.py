"""Mode -1, dropout and TPU.REMAT of the port's MsViT against ``vil_tpu`` on
the CPU, in f32.

* Mode -1 (the self chunk alone): ``VilAttention`` and the whole ``MsViT``
  against ``vil_tpu``'s XLA tier (``apply(..., mode=-1)``, the only tier it
  has for that mode), with APE, with RPE and on a padded grid: outputs and
  every gradient to 1e-5 of their scale (floored at 1). The port's
  self-only wrappers run their plain versions on the CPU. Its mask table and
  relative-position index are mode -1's own, never mode 1's or mode 7's.
* Dropout (MODEL.VIT.DROP): each site's output is x·m/(1-p) for the mask it
  drew from the step's generator; with the masks forced to ones the step at
  DROP 0.1 is the step at DROP 0 bit for bit; attention dropout still raises.
* REMAT: the port's step under 'minimal' and 'full' at dropout and drop
  path 0.1 equals its step without (to 1e-6) while its blocks run twice; at
  zero rates each equals ``vil_tpu``'s jitted step with the same REMAT (to
  1e-5); build_model drops REMAT at MODE 1 as ``vil_tpu``'s does.

Inputs are drawn with ``np.random.default_rng``; the port's weights from a
seeded generator, carried into the flax tree.
"""
import logging

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vil_tpu.config import get_default_cfg as jax_default_cfg
from vil_tpu.models import attention as jax_attention
from vil_tpu.models import build_model as jax_build_model
from vil_tpu.models.msvit import MsViT as JaxMsViT
from vil_tpu.train import engine as jax_engine
from vil_tpu.train import loss as jax_loss
from vil_tpu.train import optim as jax_optim

from vil_tpu_torch import parallel
from vil_tpu_torch.config import get_default_cfg
from vil_tpu_torch.models import MsViT, attention, build_model, layers
from vil_tpu_torch.models.attention import VilAttention, sliding_chunk_rpe_bias
from vil_tpu_torch.models.layers import Dropout
from vil_tpu_torch.ops import masks as masks_lib
from vil_tpu_torch.ops import rpe as rpe_lib
from vil_tpu_torch.ops import sliding_chunk as sc
from vil_tpu_torch.ops.kernels import (
    KERNELS,
    mask_to_additive,
    vil_mode_attention_fwd,
    vil_mode_attention_reference,
    vil_self_attention_bwd,
    vil_self_attention_fwd,
)
from vil_tpu_torch.train import engine, loss, optim
from vil_tpu_torch.utils import jax_import

TOL = 1e-5
# a 3-stage model whose 14×14 stage-1 grid pads to 4×4 chunks of 4×4, then a
# 7×7 one (2×2 chunks, pad 1) with two global tokens, then a dense stage;
# at 64 px the same stages are unpadded (4×4 and 2×2 chunks)
ARCH = "l1,h2,d32,n1,s1,g1,p4,f4_l2,h2,d64,n1,s1,g2,p2,f4_l3,h2,d64,n1,s0,g1,p2,f4"
ARCH_RPE = "_".join(s + ",a0" for s in ARCH.split("_"))
COMMON = dict(attn_type="longformerhand", sharew=True, norm_embed=True, num_classes=10)
# APE on the padded grid, RPE on the unpadded one (VilAttention's cases below
# take both on a padded grid)
CASES = {"ape-padded": (ARCH, 56), "rpe": (ARCH_RPE, 64)}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One CPU thread for torch in this module, as tests/test_torch_resnet.py
    and tests/test_torch_spatial_train.py take: the driver's workers share
    the machine's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(a):
    return None if a is None else torch.from_numpy(np.asarray(a))


def _rng(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _torch_tree(tree) -> dict:
    """A flax-shaped tree under the port's names and layouts."""
    return {n: a for n, a in (jax_import._to_torch_leaf(k, np.asarray(v))
                              for k, v in jax_import._flatten(tree))}


def _flax_params(ours, shapes):
    """The port module's parameters as the flax tree of ``shapes``."""
    params = {n: p.detach().float().numpy() for n, p in ours.named_parameters()}

    def leaf(path, sds):
        name = ".".join(str(k.key) for k in path)
        arr = params[jax_import._to_torch_leaf(name, np.zeros(sds.shape, np.float32))[0]]
        if name.endswith("kernel"):
            arr = arr.T if arr.ndim == 2 else arr.transpose(2, 3, 1, 0)
        assert arr.shape == sds.shape, name
        return jnp.asarray(arr)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _scaled(got, ref, what):
    err = np.abs(np.asarray(got) - np.asarray(ref)).max(initial=0.0)
    assert err <= TOL * max(1.0, np.abs(np.asarray(ref)).max(initial=0.0)), f"{what}: {err:.3e}"


def _draw_tables(model, seed=4):
    """Relative-position tables at σ 0.5, so that a misplaced bias shows."""
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if "relative_position" in name:
                p.copy_(torch.from_numpy(rng.standard_normal(p.shape).astype(np.float32) * 0.5))


# ------------------------------------------------------------------ mode -1

@pytest.mark.parametrize("case", list(CASES))
def test_msvit_mode_minus_one_matches_vil_tpu(case):
    """MsViT at mode -1: the served logits and a training forward's every
    gradient against vil_tpu's apply(..., mode=-1)."""
    arch, img = CASES[case]
    ours = MsViT(arch, img_size=img, device="cpu", generator=torch.Generator().manual_seed(1),
                 **COMMON)
    _draw_tables(ours)
    jmodel = JaxMsViT(arch=arch, img_size=img, **COMMON)
    x = _rng(2, (2, img, img, 3))
    shapes = jax.eval_shape(lambda: jmodel.init({"params": jax.random.PRNGKey(0)},
                                                jnp.asarray(x)))["params"]
    params = _flax_params(ours, shapes)
    g = _rng(3, (2, 10))

    @jax.jit
    def served_and_grads(p, x):  # one compile for both
        return jmodel.apply({"params": p}, x, mode=-1), jax.grad(lambda p: jnp.sum(
            jmodel.apply({"params": p}, x, deterministic=False, mode=-1) * g))(p)

    want, grads = served_and_grads(params, jnp.asarray(x))
    with torch.inference_mode():
        got = ours.eval()(_t(x), mode=-1)
        at_zero = ours(_t(x))
    _scaled(got.numpy(), want, f"{case} logits")
    assert np.abs(got.numpy() - at_zero.numpy()).max() > 10 * TOL  # not the mode-0 function

    (ours.train()(_t(x), mode=-1) * _t(g)).sum().backward()
    ref = _torch_tree(grads)
    assert set(ref) == {n for n, _ in ours.named_parameters()}
    for name, p in ours.named_parameters():
        _scaled(p.grad.numpy(), ref[name], f"{case} grad {name}")


@pytest.mark.parametrize("nglo,rpe,exact", [(1, False, 0), (2, True, -1), (0, True, 0)])
def test_vil_attention_mode_minus_one_matches_vil_tpu(nglo, rpe, exact):
    """VilAttention on the chunked pair of a padded 10×11 grid (W 4, 3×3
    chunks): both branches' outputs and the gradients of the inputs and of
    every parameter."""
    dim, heads, w, nx, ny, B = 32, 2, 4, 10, 11, 2
    _, _, mx, my = sc.chunk_grid(nx, ny, w)
    ours = VilAttention(dim, heads, w=w, nglo=nglo, exact=exact, rpe=rpe, device="cpu")
    rng = np.random.default_rng(5)
    with torch.no_grad():
        for p in ours.parameters():
            p.copy_(torch.from_numpy(rng.standard_normal(p.shape).astype(np.float32) * 0.2))
    jmod = jax_attention.VilAttention(dim=dim, num_heads=heads, w=w, nglo=nglo, exact=exact,
                                      rpe=rpe, sharew=True)
    x_glo = _rng(6, (B, nglo, dim)) if nglo else None
    x_img = _rng(7, (B, mx, my, w * w, dim))
    valid = masks_lib.chunk_valid(nx, ny, w)[None, :, :, :, None]
    x_img = x_img * valid  # zero pad positions, as chunkify leaves them
    jx = (None if x_glo is None else jnp.asarray(x_glo), jnp.asarray(x_img))
    shapes = jax.eval_shape(lambda: jmod.init({"params": jax.random.PRNGKey(0)}, jx, nx, ny,
                                              True, -1))["params"]
    params = _flax_params(ours, shapes)
    g_glo, g_img = _rng(8, (B, nglo, dim)), _rng(9, x_img.shape)

    def objective(p, xg, xi):
        yg, yi = jmod.apply({"params": p}, (xg, xi), nx, ny, False, -1)
        return jnp.sum(yi * g_img) + (0.0 if yg is None else jnp.sum(yg * g_glo)), (yg, yi)

    (_, (want_glo, want_img)), grads = jax.jit(jax.value_and_grad(
        objective, argnums=(0, 1, 2), has_aux=True))(params, *jx)
    t_glo = None if x_glo is None else _t(x_glo).requires_grad_()
    t_img = _t(x_img).requires_grad_()
    y_glo, y_img = ours.train()((t_glo, t_img), nx, ny, -1)
    obj = (y_img * _t(g_img)).sum() + (0.0 if y_glo is None else (y_glo * _t(g_glo)).sum())
    obj.backward()
    _scaled(y_img.detach().numpy(), want_img, "x_img out")
    _scaled(t_img.grad.numpy(), grads[2], "x_img grad")
    if nglo:
        _scaled(y_glo.detach().numpy(), want_glo, "x_glo out")
        _scaled(t_glo.grad.numpy(), grads[1], "x_glo grad")
    ref = _torch_tree(grads[0])
    for name, p in ours.named_parameters():
        _scaled(p.grad.numpy(), ref[name], f"grad {name}")


def test_mode_minus_one_has_its_own_tables():
    """Mode -1 reads its own mask table (mx·my, W²) and its own RPE index
    (W², W²): never mode 1's (mx·my, 2W²) table, which _mask once returned
    for any mode ≠ 0, nor mode 7's (W², 2W²) index, which
    all_mode_rpe_indices(w)[mode - 1] gave; each built alone and after the
    sampled modes' stack."""
    w, nx, ny, nglo = 4, 10, 11, 1
    padx, pady, mx, my = sc.chunk_grid(nx, ny, w)
    ours = VilAttention(32, 2, w=w, nglo=nglo, rpe=True, device="cpu")
    _draw_tables(ours)
    own = torch.from_numpy(mask_to_additive(masks_lib.invalid_mask(mx, my, padx, pady, w, 0, -1),
                                            mx, my, w * w, nglo))
    for first in (None, 1):  # alone, and after the stack of modes 1..8
        attn = VilAttention(32, 2, w=w, nglo=nglo, device="cpu")
        if first is not None:
            attn._mask(nx, ny, first, "cpu")
        table = attn._mask(nx, ny, -1, "cpu")
        assert torch.equal(table, own) and table.shape == (mx, my, 1, nglo + w * w)
        assert attn._mask(nx, ny, 1, "cpu").shape == (mx, my, 1, nglo + 2 * w * w)
    table, g2l = ours.local_relative_position_bias_table, ours.g2l_relative_position_bias
    bias = sliding_chunk_rpe_bias(table, g2l, w, -1)
    index = torch.from_numpy(rpe_lib.sliding_chunk_rpe_index_mode(w, -1).astype(np.int64))
    want = torch.cat([g2l[1].float()[:, None, :].expand(2, w * w, nglo),
                      table.float()[index].permute(2, 0, 1)], dim=-1)
    assert torch.equal(bias, want) and bias.shape == (2, w * w, nglo + w * w)
    for mode in range(1, 9):  # the sampled modes' bias as before: the stack's entry
        stack = torch.from_numpy(rpe_lib.all_mode_rpe_indices(w)[mode - 1].astype(np.int64))
        assert torch.equal(sliding_chunk_rpe_bias(table, g2l, w, mode)[..., nglo:],
                           table.float()[stack].permute(2, 0, 1))


def test_self_only_wrappers():
    """The self-only wrappers on the CPU: the plain version, [glo ‖ self]
    columns (a bias of the sampled modes' width raises), their own launch
    counts untouched on the CPU, and vil_mode_attention_fwd(mode=-1)
    through them; mode 0 is not a mode of these kernels."""
    B, mx, my, w2, C, H, nglo = 2, 3, 2, 16, 32, 2, 1
    q, k, v = (_t(_rng(10 + i, (B, mx, my, w2, C))) for i in range(3))
    kg, vg = _t(_rng(13, (B, nglo, C))), _t(_rng(14, (B, nglo, C)))
    mask = torch.zeros(mx, my, 1, nglo + w2)
    bias = _t(_rng(15, (H, w2, nglo + w2)))
    assert vil_self_attention_fwd in KERNELS and vil_self_attention_bwd in KERNELS
    before = [f.launches for f in KERNELS]
    out, lse = vil_self_attention_fwd(q, k, v, kg, vg, bias, mask, H, with_lse=True)
    ref, ref_lse = vil_mode_attention_reference(q, k, v, kg, vg, bias, mask, H, -1,
                                                with_lse=True)
    assert torch.equal(out, ref) and torch.equal(lse, ref_lse)
    assert torch.equal(vil_mode_attention_fwd(q, k, v, kg, vg, bias, mask, H, -1), ref)
    # the self chunk alone: each query chunk's output from its own keys only
    solo = vil_mode_attention_reference(q[:, :1, :1], k[:, :1, :1], v[:, :1, :1], kg, vg, bias,
                                        mask[:1, :1], H, -1)
    torch.testing.assert_close(solo, ref[:, :1, :1], rtol=0, atol=1e-6)
    g = _t(_rng(16, (B, mx, my, w2, C)))
    grads = vil_self_attention_bwd(q, k, v, kg, vg, bias, g, out, mask, lse, H)
    assert [x.shape for x in grads] == [q.shape, k.shape, v.shape, kg.shape, vg.shape,
                                         bias.shape]
    assert [f.launches for f in KERNELS] == before
    with pytest.raises(ValueError, match="bias"):
        vil_self_attention_fwd(q, k, v, kg, vg, _t(_rng(17, (H, w2, nglo + 2 * w2))),
                               torch.zeros(mx, my, 1, nglo + w2), H)
    with pytest.raises(ValueError, match="1..8 or -1"):
        vil_mode_attention_fwd(q, k, v, kg, vg, None, mask, H, 0)


def test_mode_minus_one_routes(monkeypatch):
    """Mode -1 under the fused block takes the classic projections (the
    fused block runs at mode 0 alone) and refuses SW_EXACT 1, whose tables
    are mode 0's alone. Under a spatial context of one rank it gives the
    module's own output (the self chunk needs no halo); a fused-block module
    still refuses the split (A12)."""
    x = _t(_rng(20, (2, 56, 56, 3)))
    kw = dict(img_size=56, device="cpu", **COMMON)
    fused = MsViT(ARCH, fused_block=True, generator=torch.Generator().manual_seed(1), **kw)
    classic = MsViT(ARCH, generator=torch.Generator().manual_seed(1), **kw)

    def refuse(*a, **k):
        raise AssertionError("the fused block ran at mode -1")

    monkeypatch.setattr(attention, "vil_block", refuse)
    with torch.inference_mode():
        assert torch.equal(fused.eval()(x, mode=-1), classic.eval()(x, mode=-1))
    attn = classic.stage1_block0_attn.attn
    chunks = (_t(_rng(21, (1, 1, 32))), _t(_rng(22, (1, 4, 4, 16, 32))))
    ctx = parallel.SpatialContext.of(None).at((0, 4))
    with torch.inference_mode():
        for ours, ref in zip(attn(chunks, 14, 14, -1, ctx), attn(chunks, 14, 14, -1)):
            torch.testing.assert_close(ours, ref, atol=1e-6, rtol=1e-6)
    with pytest.raises(NotImplementedError, match="no halo form.*A12"):
        fused.stage1_block0_attn.attn(chunks, 14, 14, -1, ctx)
    exact1 = MsViT(ARCH, sw_exact=1, generator=torch.Generator().manual_seed(1), **kw)
    with pytest.raises(ValueError, match="SW_EXACT 1"):
        exact1.train()(x, mode=-1)


# ------------------------------------------------------------------ dropout

FAMILIES = {"longformerhand": {}, "global": dict(only_glo=True),
            "linformer": dict(attn_type="linformer", arch=ARCH.replace("f4", "f16")),
            "srformer": dict(attn_type="srformer", arch=ARCH.replace("f4", "f2")),
            "performer": dict(attn_type="performer", arch=ARCH.replace("f4", "f16"))}


@pytest.mark.parametrize("family", list(FAMILIES))
def test_dropout_sites_apply_their_masks(family):
    """In training every Dropout site (after the position embedding, in the
    MLPs, after the attention's output projections) returns x·m/(1-p) for
    the mask m it drew from the step's generator; every site is reached;
    the same generator state gives the same output, another one another."""
    spec = dict(COMMON, **FAMILIES[family])
    arch = spec.pop("arch", ARCH)
    model = MsViT(arch, img_size=64, device="cpu", drop_rate=0.3, drop_path_rate=0.1,
                  generator=torch.Generator().manual_seed(1), **spec).train()
    sites = [m for m in model.modules() if isinstance(m, Dropout)]
    assert sites and all(m.rate == 0.3 for m in sites)
    seen, calls = set(), []

    def pre(mod, args):
        x, gen = args
        calls.append([gen.get_state()])

    def post(mod, args, out):
        x, gen = args
        replay = torch.Generator().set_state(calls[-1][0])
        kept = torch.rand(x.shape, generator=replay) < 0.7
        torch.testing.assert_close(out, torch.where(kept, x / 0.7, torch.zeros_like(x)),
                                   rtol=0, atol=0)
        assert 0.5 < kept.float().mean() < 0.9
        seen.add(id(mod))

    handles = [h for m in sites for h in (m.register_forward_pre_hook(pre),
                                          m.register_forward_hook(post))]
    x = _t(_rng(21, (2, 64, 64, 3)))
    one = model(x, generator=torch.Generator().manual_seed(5))
    assert seen == {id(m) for m in sites}
    again = model(x, generator=torch.Generator().manual_seed(5))
    other = model(x, generator=torch.Generator().manual_seed(6))
    assert torch.equal(one, again) and not torch.equal(one, other)
    for h in handles:
        h.remove()
    with torch.inference_mode():  # eval is the identity at every site
        served = model.eval()(x)
        for m in sites:
            m.rate = 0.0
        assert torch.equal(served, model(x))


def _vil_cfg(*extra):
    cfg = get_default_cfg()
    cfg.merge_from_list(["MODEL.VIT.MSVIT.ARCH", ARCH, "INPUT.IMAGE_SIZE", "56",
                         "DATA.NUM_CLASSES", "10", "TPU.COMPUTE_DTYPE", "float32",
                         "MODEL.VIT.NORM_EMBED", "True", "MODEL.VIT.MSVIT.SHARE_W", "True",
                         "OPTIM.OPT", "adamw", "OPTIM.LR", "1e-3", *extra])
    return cfg


def _port_step(cfg, x, y, **model_kw):
    """One seeded step of the port's model of ``cfg``: (loss, {name: grad})."""
    model = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(2),
                        **model_kw)
    step = engine.make_train_step(model, loss.cross_entropy, optim.get_opt(cfg, model),
                                  device="cpu", seed=3)
    metrics = step(_t(x), _t(y))
    return metrics["loss"].item(), {n: p.grad.clone() for n, p in model.named_parameters()}, \
        model


def test_dropout_forced_to_ones_is_drop_zero(monkeypatch):
    """With every dropout mask forced to ones (the sites the identity, no
    draw), the step at DROP 0.1 is the step at DROP 0 bit for bit, drop
    path 0.1 in both: the sites change nothing else of the step."""
    x, y = _rng(22, (2, 56, 56, 3)), np.array([1, 7])
    base = _port_step(_vil_cfg("MODEL.VIT.DROP_PATH", "0.1"), x, y)
    monkeypatch.setattr(layers, "dropout", lambda x, rate, generator, part=None: x)
    forced = _port_step(_vil_cfg("MODEL.VIT.DROP_PATH", "0.1", "MODEL.VIT.DROP", "0.1"), x, y)
    assert forced[0] == base[0]
    assert all(torch.equal(forced[1][n], g) for n, g in base[1].items())
    monkeypatch.undo()
    dropped = _port_step(_vil_cfg("MODEL.VIT.DROP_PATH", "0.1", "MODEL.VIT.DROP", "0.1"), x, y)
    assert dropped[0] != base[0]


def test_attention_dropout_still_raises():
    """attn_drop (no config of vil_tpu sets it) raises in training, naming
    its ROADMAP item. Dropout under a spatial context runs: on a group of
    one the rank's part of each mask is the whole mask, so the forward is
    the unsplit one's from the same generator state."""
    x = torch.zeros(1, 56, 56, 3)
    kw = dict(img_size=56, device="cpu", **COMMON)
    model = MsViT(ARCH, attn_drop_rate=0.1, **kw)
    with torch.inference_mode():
        model.eval()(x)
    with pytest.raises(NotImplementedError, match="attention dropout.*A18"):
        model.train()(x)
    dropped = MsViT(ARCH, drop_rate=0.1, **kw).train()
    x = _t(_rng(25, (2, 56, 56, 3)))
    split = dropped(x, torch.Generator().manual_seed(4), spatial=parallel.SpatialContext.of(None))
    whole = dropped(x, torch.Generator().manual_seed(4))
    torch.testing.assert_close(split, whole, rtol=0, atol=TOL)


# ------------------------------------------------------------------ REMAT

@pytest.mark.parametrize("remat", ["minimal", "full"])
def test_remat_step_equals_plain_step(remat):
    """The port's step under REMAT at dropout and drop path 0.1 against the
    same step without, from the same seeds: each block runs again in the
    backward and draws the same masks there (at mode 0 and at mode -1)."""
    x, y = _rng(23, (2, 56, 56, 3)), np.array([3, 4])
    rates = ("MODEL.VIT.DROP_PATH", "0.1", "MODEL.VIT.DROP", "0.1")
    plain = _port_step(_vil_cfg(*rates), x, y)
    runs = []
    model = build_model(_vil_cfg(*rates, "TPU.REMAT", remat), device="cpu",
                        generator=torch.Generator().manual_seed(2))
    assert model.remat == remat
    # a pre-hook: the recompute stops once it has what the backward needs
    # (non-reentrant checkpoint's early stop), before a forward hook would run
    model.stage1_block0_attn.register_forward_pre_hook(lambda *a: runs.append(1))
    step = engine.make_train_step(model, loss.cross_entropy,
                                  optim.get_opt(_vil_cfg(*rates), model), device="cpu", seed=3)
    got = step(_t(x), _t(y))["loss"].item()
    assert len(runs) == 2  # the forward and the recompute
    assert abs(got - plain[0]) <= 1e-6
    for name, p in model.named_parameters():
        err = (p.grad - plain[1][name]).abs().max().item()
        assert err <= 1e-6 * max(1.0, plain[1][name].abs().max().item()), (name, err)
    # mode -1 under REMAT, against the same model without it
    gen = lambda: torch.Generator().manual_seed(9)
    for m in (model, plain[2]):
        m.zero_grad()
        m.train()(_t(x), generator=gen(), mode=-1).sum().backward()
    for (name, p), q in zip(model.named_parameters(), plain[2].parameters()):
        assert (p.grad - q.grad).abs().max().item() <= 1e-6 * max(
            1.0, q.grad.abs().max().item()), name


@pytest.mark.parametrize("remat", ["minimal", "full"])
def test_remat_step_matches_vil_tpu(remat):
    """At zero rates, the port's step under each REMAT against vil_tpu's
    jitted step with the same REMAT: the loss and every gradient to 1e-5 of
    its scale (the same step without REMAT is held to vil_tpu's in
    tests/test_torch_train.py)."""
    opts = ["MODEL.VIT.MSVIT.ARCH", ARCH, "INPUT.IMAGE_SIZE", "56",
            "DATA.NUM_CLASSES", "10", "TPU.COMPUTE_DTYPE", "float32",
            "MODEL.VIT.NORM_EMBED", "True", "MODEL.VIT.MSVIT.SHARE_W", "True",
            "MODEL.VIT.DROP_PATH", "0.0", "OPTIM.OPT", "adamw", "OPTIM.LR", "1e-3",
            "TPU.REMAT", remat]
    x, y = _rng(24, (2, 56, 56, 3)), np.array([5, 6])
    cfg = get_default_cfg()
    cfg.merge_from_list(opts)
    model = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(2))
    jcfg = jax_default_cfg()
    jcfg.merge_from_list(opts)
    jmodel = jax_build_model(jcfg, use_pallas=False)
    assert jmodel.remat == remat == model.remat
    shapes = jax.eval_shape(lambda: jmodel.init({"params": jax.random.PRNGKey(0)},
                                                jnp.asarray(x)))["params"]
    params = _flax_params(model, shapes)
    tx = jax_optim.get_opt(jcfg, params, lr=1e-3)
    state = jax_engine.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                                  opt_state=tx.init(params), buffers={})
    state, metrics = jax.jit(jax_engine.make_train_step(jmodel, jax_loss.cross_entropy, tx))(
        state, jnp.asarray(x), jnp.asarray(y), jax.random.PRNGKey(0))
    adam = next(s for s in jax.tree_util.tree_leaves(
        state.opt_state, is_leaf=lambda s: isinstance(s, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState))
    ref = _torch_tree(jax.tree_util.tree_map(lambda m: m / (1 - 0.9), adam.mu))
    step = engine.make_train_step(model, loss.cross_entropy, optim.get_opt(cfg, model),
                                  device="cpu", seed=0)
    got = step(_t(x), _t(y))
    assert abs(got["loss"].item() - float(metrics["loss"])) <= TOL
    for name, p in model.named_parameters():
        _scaled(p.grad.numpy(), ref[name], f"grad {name}")


def test_build_model_drops_remat_under_mode_1(caplog):
    """build_model drops REMAT under MODEL.VIT.MSVIT.MODE 1, as vil_tpu's
    does, and says so; a model built with remat refuses the sampled modes in
    training and serves them as mode 0."""
    opts = ["MODEL.VIT.MSVIT.ARCH", ARCH, "INPUT.IMAGE_SIZE", "56", "DATA.NUM_CLASSES", "10",
            "TPU.REMAT", "full", "MODEL.VIT.MSVIT.MODE", "1"]
    jcfg = jax_default_cfg()
    jcfg.merge_from_list(opts)
    cfg = get_default_cfg()
    cfg.merge_from_list(opts)
    with caplog.at_level(logging.WARNING):
        model = build_model(cfg, device="cpu")
    assert jax_build_model(jcfg).remat == "" and model.remat == ""
    assert any("REMAT" in r.getMessage() for r in caplog.records)
    cfg.merge_from_list(["MODEL.VIT.MSVIT.MODE", "-1"])
    assert build_model(cfg, device="cpu").remat == "full"
    direct = MsViT(ARCH, img_size=56, device="cpu", remat="full", **COMMON)
    x = torch.zeros(1, 56, 56, 3)
    with pytest.raises(ValueError, match="static neighbour mode"):
        direct.train()(x, mode=3)
    with torch.inference_mode():
        assert torch.equal(direct.eval()(x, mode=3), direct(x))
    with pytest.raises(ValueError, match="remat"):
        MsViT(ARCH, img_size=56, device="cpu", remat="some", **COMMON)
