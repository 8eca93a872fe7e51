"""The port's random-shift (MODE 1..8) slice against ``vil_tpu``, on the CPU.

On the CPU the sampled-neighbour wrappers run their plain versions. They are
held to ``vil_mode_kernel.mode_forward`` / ``mode_backward`` in interpret
mode: the JAX side gets the rolled copies of K and V and its tables in tail
column order [self ‖ sampled ‖ glo], the port reads the sampled chunk in
place with front order [glo ‖ self ‖ sampled]. Then ``VilAttention`` at a
fixed mode, the whole narrow model's gradients with a fixed per-layer mode
vector (``jax.grad``, Pallas in interpret mode), and a 3-step AdamW
trajectory of random-shift training fed JAX's own mode draws. Inputs come
from ``np.random.default_rng``; everything is f32.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vil_tpu.config import get_default_cfg
from vil_tpu.models import attention as jax_attention
from vil_tpu.models import build_model as jax_build_model
from vil_tpu.models.msvit import MsViT as JaxMsViT
from vil_tpu.ops import sliding_chunk as jax_sc
from vil_tpu.ops.pallas import full_attention as jax_full_attention
from vil_tpu.ops.pallas import vil_kernel as jax_vil_kernel
from vil_tpu.ops.pallas import vil_mode_kernel as jax_mode_kernel
from vil_tpu.train import engine as jax_engine
from vil_tpu.train import loss as jax_loss
from vil_tpu.train import optim as jax_optim
from vil_tpu.train import schedulers as jax_sched

from vil_tpu_torch.models import MsViT, build_model
from vil_tpu_torch.models.attention import VilAttention
from vil_tpu_torch.ops import masks
from vil_tpu_torch.ops import sliding_chunk as sc
from vil_tpu_torch.ops.kernels import (
    KERNELS,
    mask_to_additive,
    vil_mode_attention,
    vil_mode_attention_bwd,
    vil_mode_attention_fwd,
    vil_mode_attention_reference,
)
from vil_tpu_torch.train import engine, loss, optim, schedulers
from vil_tpu_torch.utils import jax_import
from vil_tpu_torch.utils.jax_import import load_jax_params

ATOL = 1e-5
ARCH_PAD = "l1,h2,d32,n1,s1,g1,p4,f4_l2,h2,d64,n1,s1,g2,p2,f4_l3,h2,d64,n1,s0,g1,p2,f4"
COMMON = dict(attn_type="longformerhand", sharew=True, norm_embed=True)
# (nx, ny) token grids in chunks of 3×3: a padded 3×4 grid, and a cyclic 2×2
# grid on which a chunk's neighbours on either side are one chunk
GRIDS = {"3x4": (8, 11), "2x2": (5, 6)}
# (grid, nglo, bias, SW_EXACT): each runs all 8 modes, at H=3 (the JAX
# kernels' head pair plus a singleton). The JAX kernels are jitted once per
# configuration: the mode reaches them only through array operands.
CONFIGS = {"3x4-glo1-bias": ("3x4", 1, True, 0), "2x2-glo2": ("2x2", 2, False, -1),
           "3x4-glo0-bias-cyclic": ("3x4", 0, True, -1)}
_jax_mode_forward = jax.jit(jax_mode_kernel.mode_forward,
                            static_argnames=("num_heads", "interpret", "with_lse"))
_jax_mode_backward = jax.jit(jax_mode_kernel.mode_backward,
                             static_argnames=("num_heads", "interpret"))


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
    monkeypatch.setattr(jax_vil_kernel, "INTERPRET", True)
    monkeypatch.setattr(jax_full_attention, "INTERPRET", True)
    monkeypatch.setattr(jax_mode_kernel, "INTERPRET", True)


def _t(a):
    return None if a is None else torch.from_numpy(np.asarray(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


def _case(mode, config, seed=0, B=2, w=3, H=3):
    """Inputs of one case, and the mask tables in both column orders."""
    grid, nglo, with_bias, exact = CONFIGS[config]
    rng = np.random.default_rng(seed + mode)
    padx, pady, mx, my = sc.chunk_grid(*GRIDS[grid], w)
    w2, C = w * w, 8 * H
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    q, k, v, g = (f(B, mx, my, w2, C) for _ in range(4))
    kg, vg = (f(B, nglo, C) if nglo else None for _ in range(2))
    bias = f(H, w2, nglo + 2 * w2) * 0.5 if with_bias else None
    mask = mask_to_additive(masks.invalid_mask(mx, my, padx, pady, w, exact, mode),
                            mx, my, w2, nglo)
    tail_mask = jax_mode_kernel.mode_tail_mask(mx, my, padx, pady, w, exact, mode, nglo)
    # the JAX table is the port's in tail order, broadcast over the W² rows
    np.testing.assert_array_equal(np.asarray(tail_mask),
                                  np.broadcast_to(_to_tail(mask, nglo), tail_mask.shape))
    return dict(q=q, k=k, v=v, kg=kg, vg=vg, bias=bias, g=g, mask=mask, tail_mask=tail_mask,
                H=H, nglo=nglo)


def _to_tail(a, nglo):
    """Front column order [glo ‖ self ‖ sampled] → tail [self ‖ sampled ‖ glo]."""
    return None if a is None else np.concatenate([a[..., nglo:], a[..., :nglo]], axis=-1)


def _to_front(a, nglo):
    return None if a is None else np.concatenate([a[..., a.shape[-1] - nglo:],
                                                  a[..., :a.shape[-1] - nglo]], axis=-1)


def _jax_rolled(c, mode):
    """The JAX kernels' operands: q, k_self, k_sampled, v_self, v_sampled."""
    k, v = jnp.asarray(c["k"]), jnp.asarray(c["v"])
    return (jnp.asarray(c["q"]), k, jax_sc.sampled_roll(k, mode), v,
            jax_sc.sampled_roll(v, mode))


def _rel_close(ours, ref, name):
    assert (ours is None) == (ref is None), name
    if ref is not None:
        ours, ref = np.asarray(ours), np.asarray(ref)
        err = np.abs(ours - ref).max() / max(1.0, np.abs(ref).max())
        assert err <= ATOL, (name, err)


@pytest.mark.parametrize("config", list(CONFIGS))
@pytest.mark.parametrize("mode", range(1, 9))
def test_mode_forward_matches_pallas(mode, config):
    """B5's plain version: out and LSE against mode_forward in interpret
    mode."""
    c = _case(mode, config)
    ops = [_t(c[n]) for n in ("q", "k", "v", "kg", "vg", "bias", "mask")]
    out, lse = vil_mode_attention_fwd(*ops, c["H"], mode, with_lse=True)
    p_out, p_lse = _jax_mode_forward(
        *_jax_rolled(c, mode), _j(c["kg"]), _j(c["vg"]), _j(_to_tail(c["bias"], c["nglo"])),
        c["tail_mask"], num_heads=c["H"], interpret=True, with_lse=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(p_out), atol=ATOL, rtol=0)
    np.testing.assert_allclose(lse.numpy(), np.asarray(p_lse), atol=ATOL, rtol=0)


@pytest.mark.parametrize("config", list(CONFIGS))
@pytest.mark.parametrize("mode", range(1, 9))
def test_mode_backward_matches_pallas(mode, config):
    """B6's plain version against mode_backward in interpret mode from its
    own LSE: dq, dk = dks + roll⁻¹(dknb), dv likewise, dk_glo, dv_glo and
    dbias (tail → front order), each relative to max(1, max|ref|)."""
    c = _case(mode, config, seed=10)
    H, nglo = c["H"], c["nglo"]
    ops = [_t(c[n]) for n in ("q", "k", "v", "kg", "vg", "bias", "g", "mask")]
    out, lse = vil_mode_attention_fwd(*ops[:6], ops[7], H, mode, with_lse=True)
    ours = vil_mode_attention_bwd(*ops[:7], out, ops[7], lse, H, mode)
    rolled = _jax_rolled(c, mode)
    bias_tail = _j(_to_tail(c["bias"], nglo))
    _, p_lse = _jax_mode_forward(*rolled, _j(c["kg"]), _j(c["vg"]), bias_tail,
                                 c["tail_mask"], num_heads=H, interpret=True, with_lse=True)
    dq, dks, dknb, dvs, dvnb, dkg, dvg, dbias = _jax_mode_backward(
        *rolled, _j(c["kg"]), _j(c["vg"]), bias_tail, c["tail_mask"], jnp.asarray(c["g"]),
        num_heads=H, lse=p_lse, interpret=True)
    sx, sy = (int(s) for s in sc.MODE_ROLL_SHIFTS[mode])
    unroll = lambda t: jnp.roll(t, (-sx, -sy), axis=(1, 2))
    refs = (dq, dks + unroll(dknb), dvs + unroll(dvnb), dkg, dvg,
            None if dbias is None else _to_front(np.asarray(dbias), nglo))
    for name, a, b in zip(("dq", "dk", "dv", "dk_glo", "dv_glo", "dbias"), ours, refs):
        _rel_close(None if a is None else a.numpy(), b, name)


def test_mode_autograd_function_and_checks():
    """The differentiable entry point gives autograd's gradients of the plain
    version and launches nothing on the CPU; modes outside 1..8 and
    mode-0 tables raise."""
    for fn in KERNELS:
        fn.launches = 0
    c = _case(6, "3x4-glo1-bias", seed=20)  # every operand is a leaf
    mask = _t(c["mask"])
    for attend in (vil_mode_attention, vil_mode_attention_reference):
        leaves = [_t(c[n]).clone().requires_grad_() for n in ("q", "k", "v", "kg", "vg", "bias")]
        attend(*leaves, mask, 3, 6).backward(_t(c["g"]))
        if attend is vil_mode_attention:
            ours = [t.grad for t in leaves]
    for a, b in zip(ours, leaves):
        torch.testing.assert_close(a, b.grad, atol=1e-6, rtol=1e-6)
    assert [fn.launches for fn in KERNELS] == [0] * len(KERNELS)
    ops = [_t(c[n]) for n in ("q", "k", "v", "kg", "vg", "bias")]
    for bad_mode in (0, 9, -1, -2, 2.0):
        with pytest.raises(ValueError):
            vil_mode_attention_fwd(*ops, mask, 3, bad_mode)
    full = _t(np.zeros((3, 4, 1, 1 + 9 * 9), np.float32))  # a mode-0 table: 9 chunks
    with pytest.raises(ValueError):
        vil_mode_attention_fwd(*ops[:5], None, full, 3, 6)


def test_mode_backward_takes_the_forward_out():
    """B6's wrapper, as B2's, takes the forward's out (its bf16 kernels form
    δ = rowsum(g ∘ out)): it raises without it and on an out that does not
    match q, and a well-formed call passes."""
    c = _case(3, "2x2-glo2", seed=21)
    H = c["H"]
    q, k, v, kg, vg, bias, g, mask = (_t(c[n]) for n in ("q", "k", "v", "kg", "vg", "bias", "g",
                                                          "mask"))
    out, lse = vil_mode_attention_fwd(q, k, v, kg, vg, bias, mask, H, 3, with_lse=True)
    for bad in (None, out[..., :8], out.double(),
                out.transpose(1, 2).contiguous().transpose(1, 2)):
        with pytest.raises(ValueError):
            vil_mode_attention_bwd(q, k, v, kg, vg, bias, g, bad, mask, lse, H, 3)
    grads = vil_mode_attention_bwd(q, k, v, kg, vg, bias, g, out, mask, lse, H, 3)
    assert grads[0].shape == q.shape and torch.isfinite(grads[0]).all()


@pytest.mark.parametrize("mode,nglo,exact", [(1, 1, 0), (5, 0, -1)])
def test_vil_attention_at_a_fixed_mode_matches_flax(interpret, mode, nglo, exact):
    nx, ny, w, C, H, B = 8, 11, 3, 24, 3, 2  # pads to a 3×4 grid of 3×3 chunks
    rng = np.random.default_rng(30 + mode)
    x_glo = rng.standard_normal((B, nglo, C)).astype(np.float32) if nglo else None
    x_img = sc.chunkify(_t(rng.standard_normal((B, nx * ny, C)).astype(np.float32)),
                        nx, ny, w).numpy()
    flax_mod = jax_attention.VilAttention(dim=C, num_heads=H, w=w, nglo=nglo, sharew=True,
                                          exact=exact, use_pallas=True)
    x_jax = (_j(x_glo), jnp.asarray(x_img))
    params = jax.tree_util.tree_map(np.asarray, flax_mod.init(
        {"params": jax.random.PRNGKey(0)}, x_jax, nx, ny, True)["params"])
    ref_glo, ref_img = flax_mod.apply({"params": params}, x_jax, nx, ny, True, mode)
    ours = load_jax_params(VilAttention(dim=C, num_heads=H, w=w, nglo=nglo, exact=exact),
                           params)
    with torch.inference_mode():
        out_glo, out_img = ours((_t(x_glo), _t(x_img)), nx, ny, mode)
    np.testing.assert_allclose(out_img.numpy(), np.asarray(ref_img), atol=ATOL, rtol=ATOL)
    if nglo:
        np.testing.assert_allclose(out_glo.numpy(), np.asarray(ref_glo), atol=ATOL, rtol=ATOL)
    else:
        assert out_glo is None and ref_glo is None
    with pytest.raises(ValueError, match="SW_EXACT 1"):
        VilAttention(dim=C, num_heads=H, w=w, nglo=nglo, exact=1)(
            (_t(x_glo), _t(x_img)), nx, ny, mode)


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


def test_msvit_gradients_with_per_layer_modes_match_jax_grad(interpret):
    """Every parameter gradient of the narrow padded 56² model at the mode
    vector [6, 3, 8] (stage 1's 4×4 grid, stage 2's cyclic 2×2 grid with two
    global tokens, and a dense block whose mode is drawn and ignored), held
    to jax.grad through the Pallas mode kernels."""
    modes = [6, 3, 8]
    kw = dict(arch=ARCH_PAD, img_size=56, num_classes=10, **COMMON)
    rng = np.random.default_rng(40)
    x = rng.standard_normal((2, 56, 56, 3)).astype(np.float32)
    labels = np.array([3, 7])
    ours = MsViT(device="cpu", generator=torch.Generator().manual_seed(0), **kw).train()
    assert ours.depth == len(modes)
    jax_model = JaxMsViT(use_pallas=True, **kw)
    params = _flax_params(ours, jax_model, x)

    def jax_loss_fn(p):
        logits = jax_model.apply({"params": p}, jnp.asarray(x), deterministic=False,
                                 mode=jnp.array(modes))
        return jax_loss.cross_entropy(logits, jnp.asarray(labels))

    ref_loss, ref_grads = jax.jit(jax.value_and_grad(jax_loss_fn))(params)
    out = loss.cross_entropy(ours(_t(x), mode=modes), _t(labels))
    out.backward()
    np.testing.assert_allclose(out.item(), float(ref_loss), atol=2e-4, rtol=1e-3)
    ref = _torch_tree(ref_grads)
    for name, p in ours.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), ref[name], atol=2e-4, rtol=1e-3,
                                   err_msg=name)
    with pytest.raises(ValueError, match="per-layer modes"):
        ours(_t(x), mode=modes[:2])
    with torch.inference_mode():  # eval runs every block at mode 0
        torch.testing.assert_close(ours.eval()(_t(x), mode=modes), ours(_t(x)), atol=0, rtol=0)


def test_random_shift_trajectory_matches_jax_train_step():
    """Three AdamW steps of random-shift training (MODE 1, one mode per
    layer) against make_train_step(random_shift=True) on the XLA tier, with
    the decay terms of test_torch_train.py's trajectory (WD 0.5, WD0 0.1).
    Adam's eps is 1e-5: at 1e-8 a gradient element of order 1e-8 (there are
    some here) gets an update of order LR from g / (|g| + eps), and the ~5e-9
    by which f32 sums in the two frameworks' orders differ moves it by a
    tenth of LR. The port is fed JAX's own draws: sample_vil_modes of the
    second key of split(fold_in(PRNGKey(i), i), 3)."""
    cfg = get_default_cfg()
    cfg.merge_from_list([
        "MODEL.VIT.MSVIT.ARCH", ARCH_PAD, "INPUT.IMAGE_SIZE", "56", "DATA.NUM_CLASSES", "10",
        "TPU.COMPUTE_DTYPE", "float32", "MODEL.VIT.DROP_PATH", "0.0",
        "MODEL.VIT.NORM_EMBED", "True", "MODEL.VIT.MSVIT.SHARE_W", "True",
        "MODEL.VIT.MSVIT.MODE", "1", "OPTIM.OPT", "adamw", "OPTIM.LR", "1e-3",
        "OPTIM.WD", "0.5", "OPTIM.WD0", "0.1", "OPTIM.ADAM.EPS", "1e-5",
        "LOSS.LABEL_SMOOTHING", "0.1",
        "SOLVER.LR_POLICY", "cosine",
        "SOLVER.WARMUP_EPOCHS", "1.0", "SOLVER.STEPS_PER_EPOCH", "2", "SOLVER.MAX_ITER", "10",
        "SOLVER.WARMUP_FACTOR", "0.1", "SOLVER.MIN_LR", "1e-6",
    ])
    rng = np.random.default_rng(50)
    images = rng.standard_normal((3, 2, 56, 56, 3)).astype(np.float32)
    labels = rng.integers(0, 10, (3, 2))
    jax_model = jax_build_model(cfg, use_pallas=False)
    ours = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    params = _flax_params(ours, jax_model, images[0])
    initial = {n: p.detach().clone() for n, p in ours.named_parameters()}
    tx = jax_optim.get_opt(cfg, params, lr=jax_sched.get_lr_schedule(cfg))
    state = jax_engine.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                                  opt_state=tx.init(params), buffers={})
    jax_step = jax.jit(jax_engine.make_train_step(
        jax_model, jax_loss.get_criterion(cfg), tx, random_shift=True))
    ref_losses, draws = [], []
    for i in range(3):
        rng_mode = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(i), i), 3)[1]
        draws.append([int(m) for m in jax_engine.sample_vil_modes(rng_mode, ours.depth)])
        state, metrics = jax_step(state, jnp.asarray(images[i]), jnp.asarray(labels[i]),
                                  jax.random.PRNGKey(i))
        ref_losses.append(float(metrics["loss"]))
    assert len({tuple(d) for d in draws}) > 1  # the layers' modes change between steps

    step = engine.make_train_step(ours, loss.get_criterion(cfg), optim.get_opt(cfg, ours),
                                  schedulers.get_lr_schedule(cfg), device="cpu",
                                  random_shift=True, mode_generator=torch.Generator())
    gen = torch.Generator().manual_seed(0)
    results = [step(_t(images[i]), _t(labels[i]), gen, modes=draws[i]) for i in range(3)]
    assert [r["modes"] for r in results] == draws
    np.testing.assert_allclose([r["loss"].item() for r in results], ref_losses,
                               atol=2e-4, rtol=1e-3)
    ref = _torch_tree(state.params)
    for name, p in ours.named_parameters():
        ref_update = ref[name] - initial[name].numpy()
        update = (p.detach() - initial[name]).numpy()
        if name.endswith("qkv.bias"):  # the key bias's exact gradient is 0
            c = len(update) // 3
            np.testing.assert_allclose(update[c:2 * c], ref_update[c:2 * c], atol=2e-4, rtol=0)
            update = np.delete(update, np.s_[c:2 * c])
            ref_update = np.delete(ref_update, np.s_[c:2 * c])
        scale = np.abs(ref_update).max(initial=0.0)
        assert scale > 0 or not p.numel(), name
        assert np.abs(update - ref_update).max(initial=0.0) <= 1e-3 * scale, name


def test_sample_vil_modes_draws():
    """Ints in [1, 8], every mode drawn, one sequence per seed, one shared
    int at depth 0; a step without per-layer modes passes one mode."""
    gen = torch.Generator().manual_seed(0)
    draws = [engine.sample_vil_modes(gen, 12) for _ in range(50)]
    assert all(len(d) == 12 and all(isinstance(m, int) for m in d) for d in draws)
    flat = np.array(draws).ravel()
    assert flat.min() == 1 and flat.max() == 8 and len(set(flat.tolist())) == 8
    assert abs(flat.mean() - 4.5) < 0.2
    same = [engine.sample_vil_modes(torch.Generator().manual_seed(7), 12) for _ in range(2)]
    assert same[0] == same[1]
    shared = engine.sample_vil_modes(torch.Generator().manual_seed(7))
    assert isinstance(shared, int) and 1 <= shared <= 8

    model = MsViT(ARCH_PAD, img_size=56, num_classes=5, device="cpu",
                  generator=torch.Generator().manual_seed(0), **COMMON)
    seen = []
    forward = model.forward
    model.forward = lambda x, generator=None, mode=0: seen.append(mode) or forward(
        x, generator, mode)
    x, y = torch.from_numpy(np.random.default_rng(60).standard_normal(
        (2, 56, 56, 3)).astype(np.float32)), torch.tensor([1, 2])
    for per_layer in (True, False):
        step = engine.make_train_step(model, loss.cross_entropy, torch.optim.SGD(
            model.parameters(), lr=0.0), device="cpu", random_shift=True,
            per_layer_modes=per_layer, mode_generator=torch.Generator().manual_seed(1))
        metrics = step(x, y, torch.Generator())
        assert metrics["modes"] == seen[-1]
    assert len(seen[0]) == model.depth and isinstance(seen[1], int)
    assert seen[0] == engine.sample_vil_modes(torch.Generator().manual_seed(1), model.depth)
    plain = engine.make_train_step(model, loss.cross_entropy, torch.optim.SGD(
        model.parameters(), lr=0.0), device="cpu")
    assert "modes" not in plain(x, y, torch.Generator()) and seen[-1] == 0
    with pytest.raises(ValueError, match="mode_generator"):
        engine.make_train_step(model, loss.cross_entropy, torch.optim.SGD(
            model.parameters(), lr=0.0), device="cpu", random_shift=True)


def test_random_shift_recipe():
    """vil_small_cfg(1) is the recipe with MODE 1 and nothing else changed;
    recipe.train_step(random_shift=True) draws one mode per block from a CPU
    generator seeded 0."""
    from types import SimpleNamespace

    from vil_tpu_torch.train import recipe

    def leaves(tree, prefix=""):
        for key, value in vars(tree).items():
            if isinstance(value, SimpleNamespace):
                yield from leaves(value, f"{prefix}{key}.")
            else:
                yield prefix + key, value

    base, shift = dict(leaves(recipe.vil_small_cfg())), dict(leaves(recipe.vil_small_cfg(1)))
    assert {k for k in base if base[k] != shift[k]} == {"MODEL.VIT.MSVIT.MODE"}
    assert shift["MODEL.VIT.MSVIT.MODE"] == 1 and shift["TPU.MODE_PER_LAYER"] is True
    assert get_default_cfg().TPU.MODE_PER_LAYER is True
    model = MsViT(ARCH_PAD, img_size=56, num_classes=1000, device="cpu",
                  generator=torch.Generator().manual_seed(0), **COMMON)
    step = recipe.train_step(model, "cpu", random_shift=True)
    x = torch.from_numpy(np.random.default_rng(70).standard_normal(
        (2, 56, 56, 3)).astype(np.float32))
    metrics = step(x, torch.tensor([1, 2]), torch.Generator())
    assert metrics["modes"] == engine.sample_vil_modes(torch.Generator().manual_seed(0),
                                                       model.depth)
    assert torch.isfinite(metrics["loss"])
