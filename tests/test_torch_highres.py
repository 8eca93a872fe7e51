"""The port at high resolution against ``vil_tpu``, on the CPU, at small sizes.

The shapes of ViL-Medium-Deep 384², ViL-Small 1024² and the ``_384`` zoo
entries that no other CPU test reaches: the windows W 6, 8 and 12 (36, 64 and
144 query rows a chunk) on padded grids, a narrow MsViT with the ``_384``
window patterns, and a reference ``.pth`` imported across a change of image
size and window (the 384² fine-tune's load). On the CPU each wrapper runs its
kernel's plain version, held here to ``vil_tpu``'s Pallas kernels in
interpret mode in f32 at atol 1e-5 (1e-5 of the largest magnitude for the
sampled-neighbour gradients, 5e-5 for the fused block's, as the files of those
kernels hold them); whole models, against the JAX model's XLA tier, at the
repo's parity tolerance, atol 2e-4 / rtol 1e-3; the import at 1e-6. Also: the f32 shapes whose CUDA-core bodies
would ask a block for more shared memory than an H100 has raise, and the
recipe's general builder at ViL-Small 224² is the recipe.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vil_tpu.config import get_default_cfg as jax_default_cfg
from vil_tpu.models import build_model as jax_build_model
from vil_tpu.models.msvit import MsViT as JaxMsViT
from vil_tpu.ops import sliding_chunk as jax_sc
from vil_tpu.ops.pallas import full_attention as jax_full_attention
from vil_tpu.ops.pallas import vil_backward as jax_vil_backward
from vil_tpu.ops.pallas import vil_block as jax_vil_block
from vil_tpu.ops.pallas import vil_kernel as jax_vil_kernel
from vil_tpu.ops.pallas import vil_mode_kernel as jax_mode_kernel
from vil_tpu.train import loss as jax_loss
from vil_tpu.utils import torch_import as jax_torch_import

from vil_tpu_torch.config import get_default_cfg
from vil_tpu_torch.models import MsViT, build_model, parse_arch
from vil_tpu_torch.ops import masks
from vil_tpu_torch.ops import sliding_chunk as sc
from vil_tpu_torch.ops.kernels import (
    mask_to_additive,
    vil_attention_bwd,
    vil_attention_fwd,
    vil_attention_halo_fwd,
    vil_block,
    vil_block_fwd,
    vil_mode_attention_bwd,
    vil_mode_attention_fwd,
)
from vil_tpu_torch.ops.kernels.vil_attention import check_f32_shared_memory
from vil_tpu_torch.train import loss, recipe
from vil_tpu_torch.utils import jax_import, torch_import

ATOL = 1e-5


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
    for mod in (jax_vil_kernel, jax_vil_backward, jax_full_attention, jax_mode_kernel):
        monkeypatch.setattr(mod, "INTERPRET", True)


def _t(a):
    return None if a is None else torch.from_numpy(np.asarray(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


def _close(ours, ref, name, atol=ATOL):
    assert (ours is None) == (ref is None), name
    if ref is not None:
        np.testing.assert_allclose(np.asarray(ours), np.asarray(ref), atol=atol, rtol=atol,
                                   err_msg=name)


def _chunk_inputs(seed, nx, ny, w, H, nglo, with_bias, mode=0, B=1, M=8):
    """q, k, v, g (B, mx, my, W², C), the global rows, a bias in front order
    and the additive mask of a padded (nx, ny) grid in W×W chunks, at the
    3×3 neighbourhood (mode 0) or [self ‖ sampled] (modes 1..8); q, k, v and
    the global rows at the model's scale (q·k of unit variance, q pre-scaled
    by M^-½ as the model passes it), as chip_smoke.py draws them."""
    rng = np.random.default_rng(seed)
    padx, pady, mx, my = sc.chunk_grid(nx, ny, w)
    w2, C = w * w, H * M
    f = lambda *s, scale=1.0: (rng.standard_normal(s) * scale).astype(np.float32)
    q, k, v = (f(B, mx, my, w2, C, scale=M ** -0.25) for _ in range(3))
    g = f(B, mx, my, w2, C)
    kg, vg = (f(B, nglo, C, scale=M ** -0.25) if nglo else None for _ in range(2))
    bias = f(H, w2, nglo + (9 if mode == 0 else 2) * w2) * 0.5 if with_bias else None
    mask = mask_to_additive(masks.invalid_mask(mx, my, padx, pady, w, 0, mode), mx, my, w2, nglo)
    return dict(q=q, k=k, v=v, kg=kg, vg=vg, bias=bias, g=g, mask=mask, padx=padx, pady=pady)


# (token grid, W, nglo, bias): each window of the _384 zoo entries on a padded
# 3×3 chunk grid, with and without a global row; W 12's 144 rows are three
# 64-row slices on the card, the last holding 16, and its chunks 1297 columns
# at nglo 1
WINDOW_CASES = [((14, 13), 6, 1, True), ((17, 20), 8, 0, True), ((26, 30), 12, 0, False),
                ((26, 30), 12, 1, True)]


@pytest.mark.parametrize("grid,w,nglo,with_bias", WINDOW_CASES)
def test_sliding_chunk_at_the_384_windows_matches_pallas(interpret, grid, w, nglo, with_bias):
    """B1 and B2's plain versions (out, LSE; dq, dk, dv, dk_glo, dv_glo,
    dbias) against _pallas_forward_mh and vil_attention_backward from its
    LSE, in interpret mode."""
    c = _chunk_inputs(10 * w + nglo, *grid, w, 2, nglo, with_bias)
    ops = [c[n] for n in ("q", "k", "v", "kg", "vg", "bias")]
    out, lse = vil_attention_fwd(*map(_t, ops), _t(c["mask"]), 2, with_lse=True)
    p_out, p_lse = jax_vil_kernel._pallas_forward_mh(*map(_j, ops), c["mask"], 2,
                                                     interpret=True, with_lse=True)
    _close(out.numpy(), p_out, "out")
    _close(lse.numpy(), p_lse, "lse")
    ours = vil_attention_bwd(*map(_t, ops), _t(c["g"]), out, _t(c["mask"]), lse, 2)
    ref = jax_vil_backward.vil_attention_backward(*map(_j, ops), jnp.asarray(c["g"]),
                                                  c["mask"], 2, lse=p_lse, interpret=True)
    for name, a, b in zip(("dq", "dk", "dv", "dk_glo", "dv_glo", "dbias"), ours, ref):
        _close(None if a is None else a.numpy(), b, name)


@pytest.mark.parametrize("mode", [2, 7])
def test_sampled_neighbour_at_w12_matches_pallas(interpret, mode):
    """B5 and B6's plain versions at W 12 on a padded 3×3 grid with a global
    row and a bias: out and LSE against mode_forward, the gradients against
    mode_backward from its LSE (the JAX kernels take the rolled copies and
    tail column order [self ‖ sampled ‖ glo], the port front order)."""
    c = _chunk_inputs(mode, 26, 30, 12, 2, 1, True, mode)
    _, _, mx, my = sc.chunk_grid(26, 30, 12)
    tail = lambda a: None if a is None else np.concatenate([a[..., 1:], a[..., :1]], axis=-1)
    front = lambda a: np.concatenate([a[..., -1:], a[..., :-1]], axis=-1)
    tail_mask = jax_mode_kernel.mode_tail_mask(mx, my, c["padx"], c["pady"], 12, 0, mode, 1)
    k, v = jnp.asarray(c["k"]), jnp.asarray(c["v"])
    rolled = (jnp.asarray(c["q"]), k, jax_sc.sampled_roll(k, mode), v, jax_sc.sampled_roll(v, mode))
    ops = [c[n] for n in ("q", "k", "v", "kg", "vg", "bias")]
    out, lse = vil_mode_attention_fwd(*map(_t, ops), _t(c["mask"]), 2, mode, with_lse=True)
    p_out, p_lse = jax_mode_kernel.mode_forward(*rolled, _j(c["kg"]), _j(c["vg"]),
                                                _j(tail(c["bias"])), tail_mask, num_heads=2,
                                                interpret=True, with_lse=True)
    _close(out.numpy(), p_out, "out")
    _close(lse.numpy(), p_lse, "lse")
    ours = vil_mode_attention_bwd(*map(_t, ops), _t(c["g"]), out, _t(c["mask"]), lse, 2, mode)
    dq, dks, dknb, dvs, dvnb, dkg, dvg, db = jax_mode_kernel.mode_backward(
        *rolled, _j(c["kg"]), _j(c["vg"]), _j(tail(c["bias"])), tail_mask, jnp.asarray(c["g"]),
        num_heads=2, lse=p_lse, interpret=True)
    # the sampled copies' gradients roll back onto the chunks they were read from
    sx, sy = (int(s) for s in sc.MODE_ROLL_SHIFTS[mode])
    unroll = lambda t: jnp.roll(t, (-sx, -sy), axis=(1, 2))
    refs = (dq, dks + unroll(dknb), dvs + unroll(dvnb), dkg, dvg, front(np.asarray(db)))
    for name, a, b in zip(("dq", "dk", "dv", "dk_glo", "dv_glo", "dbias"), ours, refs):
        b = np.asarray(b)
        assert np.abs(a.numpy() - b).max() <= ATOL * max(1.0, np.abs(b).max()), name


BLOCK_ORDER = ("wq", "bq", "wk", "bk", "wv", "bv", "wo", "bo", "kg", "vg", "bias")


def test_fused_block_at_w12_matches_pallas(interpret, monkeypatch):
    """B9's plain versions at W 12 (the port fuses every sliding-chunk block
    under the fused switch, vil_tpu only those that fit its VMEM) on a padded
    2×3 grid with a global row and a bias: (y, k, v, lse) against
    _pallas_block_forward, the gradients of VilBlockFunction against
    make_fused_vil_block's VJP, both in interpret mode."""
    monkeypatch.setattr(jax_vil_block, "INTERPRET", True)
    H, C, w, B = 2, 16, 12, 1
    padx, pady, mx, my = sc.chunk_grid(20, 30, w)
    rng = np.random.default_rng(12)
    f = lambda *s: (rng.standard_normal(s) * 0.2).astype(np.float32)
    x = f(B, mx, my, w * w, C)
    args = dict(wq=f(C, C), bq=f(1, C), wk=f(C, C), bk=f(1, C), wv=f(C, C), bv=f(1, C),
                wo=f(C, C), bo=f(1, C), kg=f(B, 1, C), vg=f(B, 1, C), bias=f(H, w * w, 1 + 9 * w * w))
    rest = [args[k] for k in BLOCK_ORDER]
    mask = mask_to_additive(masks.invalid_mask(mx, my, padx, pady, w, 0, 0), mx, my, w * w, 1)
    port = [_t(a.reshape(-1) if a.ndim == 2 and a.shape[0] == 1 else a) for a in rest]
    ref = jax.jit(lambda *a: jax_vil_block._pallas_block_forward(
        *a, mask, H, with_lse=True, interpret=True))(jnp.asarray(x), *map(_j, rest))
    ours = vil_block_fwd(_t(x), *port, _t(mask), H, with_lse=True)
    for name, a, b in zip(("y", "k", "v", "lse"), ours, ref):
        _close(a.numpy(), b, name)
    loss_fn = lambda y, k, v, lib: lib.sum(lib.tanh(y)) + lib.sum(k * 0.1) + lib.sum(v * 0.05)
    fused = jax_vil_block.make_fused_vil_block(mask, H)
    ref_grads = jax.jit(jax.grad(lambda *a: loss_fn(*fused(*a), jnp), argnums=tuple(range(12))))(
        jnp.asarray(x), *map(_j, rest))
    leaves = [a.clone().requires_grad_() for a in [_t(x)] + port]
    loss_fn(*vil_block(*leaves, _t(mask), H), torch).backward()
    for i, (leaf, ref_g) in enumerate(zip(leaves, ref_grads)):
        ref_g = np.asarray(ref_g).reshape(leaf.shape)
        scale = np.abs(ref_g).max() + 1e-6
        np.testing.assert_allclose(leaf.grad.numpy() / scale, ref_g / scale, atol=5e-5,
                                   err_msg=f"argnum {i}")


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
        return jnp.array(arr, copy=True)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _torch_tree(tree) -> dict:
    """A flax-shaped tree under the port's names and layouts."""
    return {name: arr for name, arr in (jax_import._to_torch_leaf(n, np.asarray(a))
                                        for n, a in jax_import._flatten(tree))}


@pytest.mark.parametrize("f1,f2", [(6, 8), (8, 12)], ids=["base_deep_384", "medium_wide_384"])
def test_msvit_with_the_384_windows_matches_jax(interpret, f1, f2):
    """A narrow 112² MsViT with the window pattern of a ``_384`` zoo entry
    (stage 1 f6 on 5×5 chunks pad 2, or f8 on 4×4 pad 4; stage 2 f8 on 2×2
    pad 2, or f12 on 2×2 pad 10; then a dense stage), 2 heads: the logits and
    every parameter gradient of one cross-entropy step against jax.grad of
    the JAX model on its XLA tier (the tests above hold each kernel's plain
    version to the Pallas kernels at these windows)."""
    kw = dict(arch=f"l1,h2,d32,n1,s1,g1,p4,f{f1}_l2,h2,d64,n1,s1,g1,p2,f{f2}_"
                   "l3,h2,d64,n1,s0,g1,p2,f7",
              img_size=112, num_classes=10, attn_type="longformerhand", sharew=True,
              norm_embed=True)
    rng = np.random.default_rng(f2)
    x = rng.standard_normal((2, 112, 112, 3)).astype(np.float32)
    labels = np.array([3, 7])
    ours = MsViT(device="cpu", generator=torch.Generator().manual_seed(0), **kw).train()
    jax_model = JaxMsViT(use_pallas=False, **kw)
    params = _flax_params(ours, jax_model, x)

    def jax_loss_fn(p):
        logits = jax_model.apply({"params": p}, jnp.asarray(x), deterministic=False)
        return jax_loss.cross_entropy(logits, jnp.asarray(labels)), logits

    (ref_loss, ref_logits), ref_grads = jax.jit(
        jax.value_and_grad(jax_loss_fn, has_aux=True))(params)
    logits = ours(_t(x))
    out = loss.cross_entropy(logits, _t(labels))
    out.backward()
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(ref_logits), atol=2e-4,
                               rtol=1e-3)
    np.testing.assert_allclose(out.item(), float(ref_loss), atol=2e-4, rtol=1e-3)
    ref = _torch_tree(ref_grads)
    for name, p in ours.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), ref[name], atol=2e-4, rtol=1e-3,
                                   err_msg=name)


# a reference model at 32 px with windows 2 (stage 1 with relative position
# bias, a (4·2-1)² table; stage 2 with x/y position embeddings; a dense stage
# with relative position bias over its 2×2 grid), and the model it fine-tunes
# into: 64 px, windows 3 and 4 (tables of 11² and 7² rows, embeddings of 8)
FINETUNE_SRC = ("l1,h1,d16,n1,s1,g1,p4,f2,a0_l2,h2,d32,n1,s1,g1,p2,f2_"
                "l3,h2,d32,n1,s0,g1,p2,f2,a0")
FINETUNE_DST = FINETUNE_SRC.replace("p4,f2", "p4,f3").replace("p2,f2_", "p2,f4_")


def test_pth_import_across_image_size_and_window_matches_vil_tpu(tmp_path):
    """The 384² fine-tune's load at a small size: a reference-named .pth
    (``module.`` prefixes, the ``net`` key) of random weights of the 32-px
    model with windows 2, through ``vil_tpu``'s own key mapping, imported
    into the 64-px model with windows 3 and 4: the port's importer against
    ``vil_tpu``'s ``load_into_model`` followed by ``load_jax_params``. The
    relative-position tables resize along both axes (7² → 11² rows in the
    sliding-chunk stage, 3² → 7² in the dense one), the position embeddings
    grow 4 → 8; every tensor is imported."""
    def cfg(getter, arch, size):
        c = getter()
        c.merge_from_list(["MODEL.VIT.MSVIT.ARCH", arch, "INPUT.IMAGE_SIZE", str(size),
                           "DATA.NUM_CLASSES", "10", "TPU.COMPUTE_DTYPE", "float32"])
        return c

    def shapes(model, size):
        x = jnp.zeros((1, size, size, 3))
        return jax.eval_shape(lambda: model.init({"params": jax.random.PRNGKey(0)}, x))

    src = shapes(jax_build_model(cfg(jax_default_cfg, FINETUNE_SRC, 32), use_pallas=False), 32)
    rng = np.random.default_rng(15)
    state = {}
    for path, sds in jax.tree_util.tree_flatten_with_path(src["params"])[0]:
        name = ".".join(str(k.key) for k in path)
        arr = rng.standard_normal(sds.shape).astype(np.float32)
        state["module." + jax_torch_import._flax_path_to_torch_key(path)] = torch.from_numpy(
            np.ascontiguousarray(jax_import._to_torch_leaf(name, arr)[1]))
    torch.save({"net": state, "epoch": 300}, tmp_path / "ref.pth")

    dst = cfg(get_default_cfg, FINETUNE_DST, 64)
    tiny = lambda seed=0: build_model(dst, device="cpu",
                                      generator=torch.Generator().manual_seed(seed))
    ours = torch_import.load_into_model(str(tmp_path / "ref.pth"), tiny())
    jax_model = jax_build_model(cfg(jax_default_cfg, FINETUNE_DST, 64), use_pallas=False)
    start = _flax_params(tiny(), jax_model, np.zeros((1, 64, 64, 3), np.float32))
    theirs = jax_import.load_jax_params(
        tiny(seed=5), jax_torch_import.load_into_model(str(tmp_path / "ref.pth"), start))
    resized = [n for n, p in ours.named_parameters()
               if tuple(p.shape) != tuple(state["module." + torch_import.reference_key(n)].shape)]
    assert sorted(resized) == [
        "stage1_block0_attn.attn.local_relative_position_bias_table",
        "stage2_patch_embed.x_pos_embed", "stage2_patch_embed.y_pos_embed",
        "stage3_block0_attn.attn.local_relative_position_bias_table"]
    fresh = tiny().state_dict()
    changed = 0
    for (name, a), b in zip(ours.state_dict().items(), theirs.state_dict().values()):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-6, err_msg=name)
        changed += a.numel() > 0 and not torch.equal(a, fresh[name])
    assert changed == sum(t.numel() > 0 for t in state.values())


def test_f32_shapes_past_the_shared_memory_raise():
    """The f32 CUDA-core bodies keep a chunk's rows in shared memory: W²(4M +
    3) floats forward, W²(6M + 4) in the backward's pass 2. W 12 at head dim
    128 (296,640 bytes forward) and W 9 at 128 in the backward (250,128) ask
    for more than the 232,448 an H100 block may use: each wrapper raises
    ValueError naming the shape before any launch, on every device; W 12 at
    64 (ViL-Medium-Wide 384²'s stage 2: 223,488 in pass 2), W 9 at 128
    forward and every bf16 shape pass."""
    with pytest.raises(ValueError, match="forward at W² 144 rows and head dim 128"):
        check_f32_shared_memory(144, 128, backward=False)
    with pytest.raises(ValueError, match="backward pass 2 at W² 81 rows and head dim 128"):
        check_f32_shared_memory(81, 128, backward=True)
    check_f32_shared_memory(144, 64, backward=True)
    check_f32_shared_memory(81, 128, backward=False)

    def operands(w, M, dtype, mode=0):
        c = _chunk_inputs(1, w, w, w, 1, 1, False, mode, M=M)
        ops = [_t(c[n]).to(dtype) for n in ("q", "k", "v", "kg", "vg")]
        return ops, _t(c["mask"]), _t(c["g"]).to(dtype)

    ops, mask, _ = operands(12, 128, torch.float32)
    with pytest.raises(ValueError, match="W² 144 rows and head dim 128"):
        vil_attention_fwd(*ops, None, mask, 1)
    k_ext = [torch.cat([t[:, -1:], t, t[:, :1]], dim=1) for t in ops[1:3]]
    with pytest.raises(ValueError, match="W² 144 rows and head dim 128"):
        vil_attention_halo_fwd(ops[0], *k_ext, *ops[3:], None, mask, 1)
    weights = [torch.zeros(128, 128) if i % 2 == 0 else None for i in range(8)]
    weights[7] = torch.zeros(128)
    with pytest.raises(ValueError, match="W² 144 rows and head dim 128"):
        vil_block_fwd(ops[0], *weights, *ops[3:], None, mask, 1)
    ops, mask, _ = operands(12, 128, torch.float32, mode=3)
    with pytest.raises(ValueError, match="W² 144 rows and head dim 128"):
        vil_mode_attention_fwd(*ops, None, mask, 1, 3)
    ops, mask, g = operands(9, 128, torch.float32)
    out, lse = vil_attention_fwd(*ops, None, mask, 1, with_lse=True)  # the forward fits
    with pytest.raises(ValueError, match="backward pass 2 at W² 81 rows and head dim 128"):
        vil_attention_bwd(*ops, None, g, out, mask, lse, 1)
    ops, mask, _ = operands(12, 128, torch.bfloat16)  # the tensor-core kernels take it
    assert vil_attention_fwd(*ops, None, mask, 1).shape == ops[0].shape


def test_the_general_builder_at_vil_small_224_is_the_recipe():
    """recipe.vil_cfg at ViL-Small 224² and batch 64 is vil_small_cfg() key
    for key; at another model, size and batch only MODEL.VIT.MSVIT.ARCH,
    INPUT.IMAGE_SIZE, DATALOADER.BSZ and the steps an epoch differ, and
    recipe.vil builds that model at that size."""
    def leaves(node, prefix=""):
        for key, value in vars(node).items():
            if hasattr(value, "__dict__"):
                yield from leaves(value, f"{prefix}{key}.")
            else:
                yield f"{prefix}{key}", value

    assert dict(leaves(recipe.vil_cfg("vil_small", 224))) == dict(leaves(recipe.vil_small_cfg()))
    base, big = dict(leaves(recipe.vil_small_cfg())), dict(leaves(recipe.vil_cfg(
        "vil_medium_deep", 384, batch=16)))
    assert {k for k in base if base[k] != big[k]} == {
        "MODEL.VIT.MSVIT.ARCH", "INPUT.IMAGE_SIZE", "DATALOADER.BSZ", "SOLVER.STEPS_PER_EPOCH",
        "SOLVER.MAX_ITER"}
    assert big["MODEL.VIT.MSVIT.ARCH"] == recipe.ARCH_ZOO["vil_medium_deep"]
    assert big["SOLVER.STEPS_PER_EPOCH"] == recipe.IMAGENET_TRAIN_IMAGES // 16
    model = recipe.vil("vil_tiny", 384, torch.float32, device="cpu")
    assert model.img_size == 384 and model.grid_sizes() == [(96, 96), (48, 48), (24, 24), (12, 12)]
    assert model.layer_cfgs == parse_arch(recipe.ARCH_ZOO["vil_tiny"])
