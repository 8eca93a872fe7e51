"""The port's modules and whole MsViT against ``vil_tpu`` on the CPU, in f32.

Every case draws its inputs from ``np.random.default_rng``, initialises the
flax module, copies its parameters into the port with
``vil_tpu_torch.utils.jax_import.load_jax_params`` and compares outputs. The
JAX side runs its Pallas kernels in interpret mode where it would reach them,
as the JAX package's own tests do. Tolerance: the repo's parity tolerance,
atol 2e-4 / rtol 1e-3, for whole models; 1e-5 for single modules.
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

from vil_tpu.models import attention as jax_attention
from vil_tpu.models import layers as jax_layers
from vil_tpu.models.msvit import MsViT as JaxMsViT
from vil_tpu.ops.pallas import full_attention as jax_full_attention
from vil_tpu.ops.pallas import vil_kernel as jax_vil_kernel

from vil_tpu_torch.models import MsViT, build_model
from vil_tpu_torch.models.attention import FullAttention, VilAttention
from vil_tpu_torch.models.layers import Mlp, PatchEmbed
from vil_tpu_torch.ops import sliding_chunk as sc
from vil_tpu_torch.ops.kernels import KERNELS
from vil_tpu_torch.utils.jax_import import load_jax_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# narrow 4-stage model at 224² with the W=7 windows of the zoo: stage grids
# 56² (8×8 chunks), 28² (4×4), then dense stages at N = 197 and 49
ARCH_224 = ("l1,h2,d32,n1,s1,g1,p4,f7_l2,h2,d32,n2,s1,g1,p2,f7_"
            "l3,h2,d64,n2,s0,g1,p2,f7_l4,h2,d64,n1,s0,g0,p2,f7")
# small 3-stage model whose 14×14 stage-1 grid pads to 4×4 chunks of 4×4
ARCH_PAD = "l1,h2,d32,n1,s1,g1,p4,f4_l2,h2,d64,n1,s1,g2,p2,f4_l3,h2,d64,n1,s0,g1,p2,f4"


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


def _rng_array(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _init(module, *args, jit=False, **kw):
    init = jax.jit(module.init) if jit else module.init
    variables = init({"params": jax.random.PRNGKey(0)}, *args, **kw)
    return jax.tree_util.tree_map(np.asarray, variables["params"])


def _t(a):
    return torch.from_numpy(np.asarray(a))


@functools.lru_cache(maxsize=None)
def _msvit_params(arch, img, batch, num_classes):
    """The flax MsViT's initial parameters, drawn once per shape: they
    depend on neither use_pallas nor SW_EXACT. Jitted: an eager init of the
    whole model dispatches op by op."""
    model = JaxMsViT(arch=arch, img_size=img, num_classes=num_classes,
                     attn_type="longformerhand", sharew=True, norm_embed=True)
    return _init(model, jnp.zeros((batch, img, img, 3)), jit=True)


def _run_msvit_pair(arch, img, batch=2, num_classes=10, **kw):
    common = dict(arch=arch, img_size=img, num_classes=num_classes,
                  attn_type="longformerhand", sharew=True, norm_embed=True, **kw)
    x = _rng_array(1, (batch, img, img, 3))
    params = _msvit_params(arch, img, batch, num_classes)
    ours = load_jax_params(MsViT(device="cpu", **common), params).eval()
    ref = JaxMsViT(use_pallas=True, **common).apply({"params": params}, jnp.asarray(x))
    with torch.inference_mode():
        out = ours(_t(x)).numpy()
    return np.asarray(ref), out


def test_msvit_224_matches_jax(interpret):
    ref, out = _run_msvit_pair(ARCH_224, 224)
    assert out.shape == (2, 10) and np.isfinite(out).all()
    np.testing.assert_allclose(out, ref, atol=2e-4, rtol=1e-3)


@pytest.mark.parametrize("sw_exact", [0, 1, -1])
def test_msvit_padded_grid_matches_jax(interpret, sw_exact):
    """A chunk grid with zero padding: masked local keys in every SW_EXACT
    semantics, and masked pad keys in the global branch."""
    ref, out = _run_msvit_pair(ARCH_PAD, 56, sw_exact=sw_exact)
    np.testing.assert_allclose(out, ref, atol=2e-4, rtol=1e-3)


def test_build_model_matches_jax_build_model(interpret):
    from vil_tpu.config import get_default_cfg
    from vil_tpu.models import build_model as jax_build_model

    cfg = get_default_cfg()
    cfg.merge_from_list([
        "MODEL.VIT.MSVIT.ARCH", ARCH_PAD, "INPUT.IMAGE_SIZE", "56",
        "DATA.NUM_CLASSES", "7", "TPU.COMPUTE_DTYPE", "float32",
    ])
    ours = build_model(cfg, device="cpu").eval()
    assert ours.head.out_features == 7 and ours.head.weight.dtype == torch.float32
    jax_model = jax_build_model(cfg, use_pallas=True)
    x = _rng_array(2, (2, 56, 56, 3))
    params = _init(jax_build_model(cfg, use_pallas=False), jnp.asarray(x), jit=True)
    load_jax_params(ours, params)
    ref = jax_model.apply({"params": params}, jnp.asarray(x))
    with torch.inference_mode():
        out = ours(_t(x)).numpy()
    np.testing.assert_allclose(out, np.asarray(ref), atol=2e-4, rtol=1e-3)
    cfg.merge_from_list(["TPU.COMPUTE_DTYPE", "bfloat16"])
    bf16 = build_model(cfg, device="cpu")
    # bf16 compute over f32 parameters, as the JAX package keeps them
    assert bf16.dtype == torch.bfloat16 and bf16.head.weight.dtype == torch.float32
    assert build_model(cfg, device="cpu", param_dtype=torch.bfloat16
                       ).head.weight.dtype == torch.bfloat16


def test_build_model_reads_use_pallas_and_param_dtype():
    """TPU.USE_PALLAS and TPU.PARAM_DTYPE are read as vil_tpu's build_model
    reads them: with USE_PALLAS False and FUSED_LN True both build the plain
    LayerNorm and no kernel, and PARAM_DTYPE bfloat16 keeps bf16 parameters;
    an explicit use_kernels= or param_dtype= wins over the tree."""
    from vil_tpu.config import get_default_cfg
    from vil_tpu.models import build_model as jax_build_model

    from vil_tpu_torch.models.layers import FusedLayerNorm

    cfg = get_default_cfg()
    cfg.merge_from_list([
        "MODEL.VIT.MSVIT.ARCH", ARCH_PAD, "INPUT.IMAGE_SIZE", "56", "DATA.NUM_CLASSES", "7",
        "TPU.USE_PALLAS", "False", "TPU.FUSED_LN", "True", "TPU.PARAM_DTYPE", "bfloat16",
    ])

    def kinds(model):
        fused = sum(isinstance(m, FusedLayerNorm) for m in model.modules())
        kernels = {m.use_kernels for m in model.modules() if isinstance(m, (VilAttention,
                                                                            FullAttention))}
        dtypes = {p.dtype for p in model.parameters()}
        return fused, kernels, dtypes

    jax_model = jax_build_model(cfg)
    assert not jax_model.use_pallas and not jax_model.fused_ln
    assert jax_model.param_dtype == jnp.bfloat16
    assert kinds(build_model(cfg, device="cpu")) == (0, {False}, {torch.bfloat16})
    # explicit arguments win over the tree, with FUSED_LN following the kernels
    fused, kernels, dtypes = kinds(build_model(cfg, device="cpu", use_kernels=True,
                                               param_dtype=torch.float32))
    assert fused > 0 and kernels == {True} and dtypes == {torch.float32}
    assert jax_build_model(cfg, use_pallas=True).fused_ln
    cfg.merge_from_list(["TPU.USE_PALLAS", "True", "TPU.PARAM_DTYPE", "float32"])
    fused, kernels, dtypes = kinds(build_model(cfg, device="cpu"))
    assert fused > 0 and kernels == {True} and dtypes == {torch.float32}
    assert kinds(build_model(cfg, device="cpu", use_kernels=False))[:2] == (0, {False})


@pytest.mark.parametrize("nglo,norm_embed,ape", [(1, True, True), (0, False, True),
                                                 (2, True, False)])
@pytest.mark.parametrize("uint8", [False, True])
def test_patch_embed_matches_flax(nglo, norm_embed, ape, uint8):
    kw = dict(patch_size=4, nx=5, ny=6, embed_dim=16, nglo=nglo,
              norm_embed=norm_embed, ape=ape)
    rng = np.random.default_rng(3)
    if uint8:
        x = rng.integers(0, 256, (2, 20, 24, 3), dtype=np.uint8)
    else:
        x = rng.standard_normal((2, 20, 24, 3)).astype(np.float32)
    flax_mod = jax_layers.PatchEmbed(**kw)
    params = _init(flax_mod, jnp.asarray(x), True)
    ref = flax_mod.apply({"params": params}, jnp.asarray(x), True)
    ours = load_jax_params(PatchEmbed(in_chans=3, **kw), params)
    with torch.inference_mode():
        out = ours(_t(x)).numpy()
    np.testing.assert_allclose(out, np.asarray(ref), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mlp_matches_flax(dtype):
    """Exact (erf) GELU in f32, tanh-approximate GELU in bf16, as the flax Mlp
    picks them. The bf16 run is held to flax's tanh form in f32 at a bf16
    tolerance."""
    x = _rng_array(4, (2, 3, 5, 24))
    bf16 = dtype == torch.bfloat16
    flax_mod = jax_layers.Mlp(hidden_features=40, gelu_approx=bf16)
    params = _init(flax_mod, jnp.asarray(x), True)
    ref = flax_mod.apply({"params": params}, jnp.asarray(x), True)
    ours = load_jax_params(Mlp(24, 40, dtype=dtype), params)
    with torch.inference_mode():
        out = ours(_t(x).to(dtype)).float().numpy()
    tol = 3e-2 if bf16 else 1e-5
    np.testing.assert_allclose(out, np.asarray(ref), atol=tol, rtol=tol)


@pytest.mark.parametrize("nglo,H,exact", [(1, 2, 0), (0, 1, 0), (2, 2, -1), (1, 2, 1)])
def test_vil_attention_matches_flax(interpret, nglo, H, exact):
    nx, ny, w, C, B = 7, 8, 3, 16, 2  # pads to a 3×3 grid of 3×3 chunks
    x_glo = _rng_array(5, (B, nglo, C)) if nglo else None
    x_img = sc.chunkify(_t(_rng_array(6, (B, nx * ny, C))), nx, ny, w).numpy()
    flax_mod = jax_attention.VilAttention(dim=C, num_heads=H, w=w, nglo=nglo,
                                          sharew=True, exact=exact, use_pallas=True)
    x_jax = (None if x_glo is None else jnp.asarray(x_glo), jnp.asarray(x_img))
    params = _init(flax_mod, x_jax, nx, ny, True)
    ref_glo, ref_img = flax_mod.apply({"params": params}, x_jax, nx, ny, True)
    ours = load_jax_params(
        VilAttention(dim=C, num_heads=H, w=w, nglo=nglo, exact=exact), params)
    with torch.inference_mode():
        out_glo, out_img = ours((None if x_glo is None else _t(x_glo), _t(x_img)), nx, ny)
    np.testing.assert_allclose(out_img.numpy(), np.asarray(ref_img), atol=1e-5, rtol=1e-5)
    if nglo:
        np.testing.assert_allclose(out_glo.numpy(), np.asarray(ref_glo), atol=1e-5, rtol=1e-5)
    else:
        assert out_glo is None and ref_glo is None


@pytest.mark.parametrize("H,N", [(2, 17), (4, 50)])
def test_full_attention_matches_flax(interpret, H, N):
    C = 32
    x = _rng_array(7, (2, N, C))
    flax_mod = jax_attention.FullAttention(dim=C, num_heads=H, use_pallas=True)
    params = _init(flax_mod, jnp.asarray(x), 4, 4, True)
    ref = flax_mod.apply({"params": params}, jnp.asarray(x), 4, 4, True)
    ours = load_jax_params(FullAttention(dim=C, num_heads=H), params)
    with torch.inference_mode():
        out = ours(_t(x), 4, 4).numpy()
    np.testing.assert_allclose(out, np.asarray(ref), atol=1e-5, rtol=1e-5)


def test_plain_path_matches_kernel_wrappers_and_counters_stay_zero():
    """use_kernels=False calls the plain versions directly; on the CPU the
    wrappers run the same plain versions and launch nothing."""
    for fn in KERNELS:
        fn.launches = 0
    gen = lambda: torch.Generator().manual_seed(0)
    x = torch.from_numpy(_rng_array(8, (2, 56, 56, 3)))
    outs = []
    for use_kernels in (True, False):
        model = MsViT(ARCH_PAD, img_size=56, num_classes=5, sharew=True, device="cpu",
                      use_kernels=use_kernels, generator=gen()).eval()
        with torch.inference_mode():
            outs.append(model(x))
    torch.testing.assert_close(outs[0], outs[1], atol=0, rtol=0)
    assert [fn.launches for fn in KERNELS] == [0] * len(KERNELS)


def test_init_weights_is_seeded():
    a = MsViT(ARCH_PAD, img_size=56, num_classes=5, sharew=True, device="cpu",
              generator=torch.Generator().manual_seed(3))
    b = MsViT(ARCH_PAD, img_size=56, num_classes=5, sharew=True, device="cpu",
              generator=torch.Generator().manual_seed(3), dtype=torch.bfloat16,
              param_dtype=torch.bfloat16)
    for (name, pa), (_, pb) in zip(a.named_parameters(), b.named_parameters()):
        torch.testing.assert_close(pa.to(torch.bfloat16), pb, atol=0, rtol=0, msg=name)
    w = a.stage1_block0_attn.attn.query.weight
    assert abs(w.std().item() - 0.02 * 0.88) < 0.004 and w.abs().max() <= 0.04
    assert (a.stage1_block0_attn.norm.weight == 1).all()
    assert (a.stage1_block0_attn.attn.query.bias == 0).all()


def test_bf16_forward_is_finite():
    model = MsViT(ARCH_PAD, img_size=56, num_classes=5, sharew=True, device="cpu",
                  dtype=torch.bfloat16, generator=torch.Generator().manual_seed(0)).eval()
    x = torch.from_numpy(np.random.default_rng(9).integers(0, 256, (2, 56, 56, 3),
                                                          dtype=np.uint8))
    with torch.inference_mode():
        out = model(x)
    assert out.dtype == torch.bfloat16 and out.shape == (2, 5)
    assert torch.isfinite(out).all()


def test_unported_features_raise():
    cpu = dict(img_size=56, device="cpu")
    # SW_EXACT 1 has no sampled-neighbour (MODE 1..8) tables, as in vil_tpu
    exact1 = MsViT(ARCH_PAD, sharew=True, sw_exact=1, mode=1, **cpu).train()
    with pytest.raises(ValueError, match="SW_EXACT 1"):
        exact1(torch.zeros(1, 56, 56, 3), mode=3)
    # mode -1 (the self chunk alone) runs (tests/test_torch_model_options.py),
    # under spatial parallelism too, as modes 1..8 do
    # (tests/test_torch_spatial_mode.py); the fused block there raises (A12)
    from vil_tpu_torch.parallel import SpatialContext

    x = torch.from_numpy(np.random.default_rng(10).standard_normal((1, 56, 56, 3))
                         .astype(np.float32))
    shallow = MsViT(ARCH_PAD, sharew=True, **cpu).train()
    torch.testing.assert_close(shallow(x, mode=-1, spatial=SpatialContext.of(None)),
                               shallow(x, mode=-1), atol=1e-5, rtol=1e-5)
    with pytest.raises(NotImplementedError, match="no halo form.*A12"):
        MsViT(ARCH_PAD, sharew=True, fused_block=True, **cpu).train()(
            x, mode=-1, spatial=SpatialContext.of(None))
    # dropout runs in training (tests/test_torch_model_options.py); attention
    # dropout, which no config of vil_tpu sets, raises instead of running as
    # eval (stochastic depth is ported: test_torch_train.py)
    model = MsViT(ARCH_PAD, num_classes=5, sharew=True, attn_drop_rate=0.1, **cpu)
    x = torch.zeros(1, 56, 56, 3)
    with torch.inference_mode():
        model.eval()(x)
        with pytest.raises(NotImplementedError, match="attention dropout"):
            model.train()(x)
        assert torch.isfinite(MsViT(ARCH_PAD, num_classes=5, sharew=True, drop_rate=0.1,
                                    **cpu).train()(x, torch.Generator())).all()
    with pytest.raises(ValueError, match="Fix input size"):
        model.eval()(torch.zeros(1, 60, 60, 3))


def test_load_jax_params_is_strict():
    x = jnp.zeros((1, 20, 24, 3))
    kw = dict(patch_size=4, nx=5, ny=6, embed_dim=16)
    params = _init(jax_layers.PatchEmbed(**kw), x, True)
    with pytest.raises(KeyError, match="unused"):
        load_jax_params(PatchEmbed(in_chans=3, **kw), {**params, "extra": np.zeros(3)})
    short = {k: v for k, v in params.items() if k != "cls_token"}
    with pytest.raises(KeyError, match="cls_token"):
        load_jax_params(PatchEmbed(in_chans=3, **kw), short)


def test_port_imports_no_jax():
    code = ("import sys; import vil_tpu_torch, vil_tpu_torch.models, "
            "vil_tpu_torch.ops.kernels, vil_tpu_torch.ops.kernels.layer_norm, "
            "vil_tpu_torch.ops.kernels.vil_block, vil_tpu_torch.utils.jax_import, "
            "vil_tpu_torch.train.engine, vil_tpu_torch.train.recipe, "
            "vil_tpu_torch.data.mixup, vil_tpu_torch.tools.profile_step, "
            "vil_tpu_torch.parallel, vil_tpu_torch.ops.kernels.vil_attention_halo, "
            "vil_tpu_torch.tools.layout_probe, vil_tpu_torch.tools.sass_census, "
            "vil_tpu_torch.config, vil_tpu_torch.data.loader, vil_tpu_torch.data.rand_augment, "
            "vil_tpu_torch.data.tsv, vil_tpu_torch.utils.checkpoint, "
            "vil_tpu_torch.utils.torch_import, vil_tpu_torch.utils.profiling, "
            "vil_tpu_torch.train.trainer, vil_tpu_torch.run_experiment, "
            "vil_tpu_torch.models.attention_efficient, vil_tpu_torch.train.redraw, "
            "vil_tpu_torch.ops.flops, vil_tpu_torch.utils.flax_msgpack, "
            "vil_tpu_torch.data.native, vil_tpu_torch.data.grain_loader, "
            "vil_tpu_torch.tools.data_bench; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'vil_tpu', 'flax', 'optax', 'orbax', 'msgpack', 'grain')); print(bad); "
            "sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
