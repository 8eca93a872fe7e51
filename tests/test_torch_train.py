"""The port's training slice against ``vil_tpu`` on the CPU, in f32.

Inputs come from ``np.random.default_rng``; the port's seeded parameters
are copied into the flax tree (the inverse of ``load_jax_params``), so the
JAX models need no initialisation. Whole-model gradients are held to
``jax.grad`` of the JAX model with its Pallas kernels in interpret mode, and
a 3-step AdamW trajectory to ``vil_tpu.train.engine.make_train_step``, at the
repo's parity tolerance (atol 2e-4, rtol 1e-3). Losses, schedules, mixup
(with the JAX draws injected: the two frameworks' random streams differ),
the decay mask and top-k are compared piece by piece.
"""
import functools
import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vil_tpu.config import get_default_cfg
from vil_tpu.data import mixup as jax_mixup
from vil_tpu.models.msvit import MsViT as JaxMsViT
from vil_tpu.ops.pallas import full_attention as jax_full_attention
from vil_tpu.ops.pallas import vil_kernel as jax_vil_kernel
from vil_tpu.train import engine as jax_engine
from vil_tpu.train import loss as jax_loss
from vil_tpu.train import optim as jax_optim
from vil_tpu.train import schedulers as jax_sched

from vil_tpu_torch.data import mixup
from vil_tpu_torch.models import MsViT, build_model
from vil_tpu_torch.models.layers import DropPath
from vil_tpu_torch.ops.kernels import KERNELS
from vil_tpu_torch.train import engine, loss, optim, recipe, schedulers
from vil_tpu_torch.utils import jax_import

ARCH_224 = ("l1,h2,d32,n1,s1,g1,p4,f7_l2,h2,d32,n2,s1,g1,p2,f7_"
            "l3,h2,d64,n2,s0,g1,p2,f7_l4,h2,d64,n1,s0,g0,p2,f7")
ARCH_PAD = "l1,h2,d32,n1,s1,g1,p4,f4_l2,h2,d64,n1,s1,g2,p2,f4_l3,h2,d64,n1,s0,g1,p2,f4"
COMMON = dict(attn_type="longformerhand", sharew=True, norm_embed=True)


@pytest.fixture
def interpret(monkeypatch):
    """Run the JAX package's Pallas kernels in interpret mode."""
    monkeypatch.setattr(jax_vil_kernel, "INTERPRET", True)
    monkeypatch.setattr(jax_full_attention, "INTERPRET", True)


def _rng(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _torch_tree(tree) -> dict:
    """A flax-shaped tree (params, grads, masks) under the port's names and
    layouts."""
    return {name: arr for name, arr in (jax_import._to_torch_leaf(n, np.asarray(a))
                                        for n, a in jax_import._flatten(tree))}


def _param_shapes(model, x):
    """The flax parameter tree of ``model`` as shapes (no initialisation)."""
    return jax.eval_shape(lambda: model.init({"params": jax.random.PRNGKey(0)},
                                             jnp.asarray(x)))["params"]


def _flax_params(ours, shapes):
    """The port model's (seeded) parameters as a flax tree shaped like
    ``shapes``: the inverse of ``load_jax_params``."""
    params = {n: p.detach().float().numpy() for n, p in ours.named_parameters()}

    def leaf(path, sds):
        name = ".".join(str(k.key) for k in path)
        arr = params[jax_import._to_torch_leaf(name, np.zeros(sds.shape, np.float32))[0]]
        if name.endswith("kernel"):
            arr = arr.T if arr.ndim == 2 else arr.transpose(2, 3, 1, 0)
        assert arr.shape == sds.shape, name
        return jnp.asarray(arr)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def test_msvit_gradients_match_jax_grad(interpret):
    """Every parameter gradient of the narrow 224² model (sliding-chunk and
    dense stages, both backward kernels' plain versions) against jax.grad of
    the JAX model through its Pallas kernels, batch 2, drop path 0."""
    kw = dict(arch=ARCH_224, img_size=224, num_classes=10, **COMMON)
    x = _rng(1, 2, 224, 224, 3)
    labels = np.array([3, 7])
    ours = MsViT(device="cpu", generator=torch.Generator().manual_seed(0), **kw).train()
    jax_model = JaxMsViT(use_pallas=True, **kw)
    params = _flax_params(ours, _param_shapes(jax_model, x))

    def jax_loss_fn(p):
        logits = jax_model.apply({"params": p}, jnp.asarray(x), deterministic=False)
        return jax_loss.cross_entropy(logits, jnp.asarray(labels))

    ref_loss, ref_grads = jax.jit(jax.value_and_grad(jax_loss_fn))(params)
    out = loss.cross_entropy(ours(torch.from_numpy(x)), torch.from_numpy(labels))
    out.backward()
    np.testing.assert_allclose(out.item(), float(ref_loss), atol=2e-4, rtol=1e-3)
    ref = _torch_tree(ref_grads)
    grads = {n: p.grad for n, p in ours.named_parameters()}
    assert set(grads) == set(ref)
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), ref[name], atol=2e-4, rtol=1e-3, err_msg=name)


def _train_cfg():
    cfg = get_default_cfg()
    cfg.merge_from_list([
        "MODEL.VIT.MSVIT.ARCH", ARCH_PAD, "INPUT.IMAGE_SIZE", "56",
        "DATA.NUM_CLASSES", "10", "TPU.COMPUTE_DTYPE", "float32",
        "MODEL.VIT.DROP_PATH", "0.0", "MODEL.VIT.NORM_EMBED", "True",
        "MODEL.VIT.MSVIT.SHARE_W", "True",
        "OPTIM.OPT", "adamw", "OPTIM.LR", "1e-3", "OPTIM.WD", "0.05",
        "LOSS.LABEL_SMOOTHING", "0.1",
        "SOLVER.LR_POLICY", "cosine", "SOLVER.WARMUP_EPOCHS", "1.0",
        "SOLVER.STEPS_PER_EPOCH", "2", "SOLVER.MAX_ITER", "10",
        "SOLVER.WARMUP_FACTOR", "0.1", "SOLVER.MIN_LR", "1e-6",
    ])
    return cfg


def test_adamw_trajectory_matches_jax_train_step():
    """Three steps of AdamW with the decay mask and a warmup-cosine schedule
    (warmup over steps 0-1, cosine from step 2), label-smoothed CE, through
    the XLA tier on the JAX side: the losses, and each parameter's update
    (final minus initial) to within 1e-3 of the largest of JAX's. WD 0.5 and
    WD0 0.1 make both decay terms a visible share of the update: a wrong
    group, or decoupled in place of coupled, moves it by far more."""
    from vil_tpu.models import build_model as jax_build_model

    cfg = _train_cfg()
    cfg.merge_from_list(["OPTIM.WD", "0.5", "OPTIM.WD0", "0.1"])
    images = _rng(2, 3, 2, 56, 56, 3)
    labels = np.random.default_rng(3).integers(0, 10, (3, 2))
    jax_model = jax_build_model(cfg, use_pallas=False)
    ours = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    params = _flax_params(ours, _param_shapes(jax_model, images[0]))
    initial = {n: p.detach().clone() for n, p in ours.named_parameters()}
    tx = jax_optim.get_opt(cfg, params, lr=jax_sched.get_lr_schedule(cfg))
    state = jax_engine.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                                  opt_state=tx.init(params), buffers={})
    jax_step = jax.jit(jax_engine.make_train_step(
        jax_model, jax_loss.get_criterion(cfg), tx))
    ref_losses = []
    for i in range(3):
        state, metrics = jax_step(state, jnp.asarray(images[i]), jnp.asarray(labels[i]),
                                  jax.random.PRNGKey(i))
        ref_losses.append(float(metrics["loss"]))

    step = engine.make_train_step(ours, loss.get_criterion(cfg), optim.get_opt(cfg, ours),
                                  schedulers.get_lr_schedule(cfg), device="cpu")
    gen = torch.Generator().manual_seed(0)
    losses = [step(torch.from_numpy(images[i]), torch.from_numpy(labels[i]), gen)["loss"].item()
              for i in range(3)]
    np.testing.assert_allclose(losses, ref_losses, atol=2e-4, rtol=1e-3)
    ref = _torch_tree(state.params)
    for name, p in ours.named_parameters():
        ref_update = ref[name] - initial[name].numpy()
        update = (p.detach() - initial[name]).numpy()
        if name.endswith("qkv.bias"):
            # the key bias's exact gradient is 0 (a shift common to a query's
            # scores leaves its softmax alone): Adam turns rounding noise into
            # its update, held at the absolute tolerance
            c = len(update) // 3
            np.testing.assert_allclose(update[c:2 * c], ref_update[c:2 * c], atol=2e-4, rtol=0)
            update, ref_update = np.delete(update, np.s_[c:2 * c]), np.delete(ref_update,
                                                                               np.s_[c:2 * c])
        scale = np.abs(ref_update).max(initial=0.0)
        assert scale > 0 or not p.numel(), name
        assert np.abs(update - ref_update).max(initial=0.0) <= 1e-3 * scale, name


def test_recipe_cfg_is_configs_msvit_yaml():
    """Every key of the port's recipe tree holds the value of the JAX
    package's defaults merged with configs/msvit.yaml, except the batch (64)
    and the two keys the JAX trainer sets from its loader."""
    ref = get_default_cfg()
    ref.merge_from_file(os.path.join(os.path.dirname(__file__), "..", "configs", "msvit.yaml"))
    steps = 1281167 // 64  # ImageNet-1k's training set, last partial batch dropped
    cut = {"DATALOADER.BSZ": 64, "SOLVER.STEPS_PER_EPOCH": steps, "SOLVER.MAX_ITER": steps * 300}

    def leaves(tree, prefix=""):
        for key, value in vars(tree).items():
            if isinstance(value, SimpleNamespace):
                yield from leaves(value, f"{prefix}{key}.")
            else:
                yield prefix + key, value

    for key, value in leaves(recipe.vil_small_cfg()):
        want = cut[key] if key in cut else functools.reduce(getattr, key.split("."), ref)
        if isinstance(want, (list, tuple)):
            value, want = list(value), list(want)
        assert value == want and type(value) is type(want), key
    assert ref.DATALOADER.BSZ == 256


def test_decay_mask_matches_jax():
    """The port's mask on its names selects exactly what the JAX mask selects
    on the flax paths, under load_jax_params's name map."""
    cfg = _train_cfg()
    from vil_tpu.models import build_model as jax_build_model

    shapes = _param_shapes(jax_build_model(cfg, use_pallas=False), _rng(4, 1, 56, 56, 3))
    ref = {jax_import._to_torch_leaf(".".join(str(k.key) for k in path),
                                     np.zeros(sds.shape))[0]: bool(m)
           for (path, sds), m in zip(jax.tree_util.tree_flatten_with_path(shapes)[0],
                                     jax.tree_util.tree_leaves(jax_optim.decay_mask(shapes)))}
    ours = optim.decay_mask(build_model(cfg, device="cpu"))
    assert ours == ref
    assert not ours["head.bias"] and ours["head.weight"]
    assert not ours["stage1_patch_embed.norm_embed.weight"]
    assert not ours["stage2_block0_attn.norm.bias"] and not ours["norm.weight"]
    assert ours["stage2_block0_attn.attn.query.weight"]


@pytest.mark.parametrize("wd0", [0.0, 0.01])
def test_optimizer_groups(wd0):
    cfg = _train_cfg()
    cfg.merge_from_list(["OPTIM.WD0", str(wd0)])
    model = build_model(cfg, device="cpu")
    opt = optim.get_opt(cfg, model)
    decay, no_decay = opt.param_groups
    assert decay["weight_decay"] == 0.05 and no_decay["weight_decay"] == wd0
    assert not no_decay["decoupled_weight_decay"] and decay["decoupled_weight_decay"]
    assert len(decay["params"]) + len(no_decay["params"]) == len(list(model.parameters()))
    for name in ("sgd", "adam", "qhm", "lamb"):
        cfg.merge_from_list(["OPTIM.OPT", name])
        assert len(optim.get_opt(cfg, model).param_groups) == 2
    cfg.merge_from_list(["OPTIM.OPT", "nadam"])
    with pytest.raises(ValueError, match="not supported"):
        optim.get_opt(cfg, model)


def _loss_cases():
    rng = np.random.default_rng(5)
    logits = (rng.standard_normal((6, 9)) * 2).astype(np.float32)
    labels = rng.integers(0, 9, 6)
    soft = rng.random((6, 9)).astype(np.float32)
    soft /= soft.sum(-1, keepdims=True)
    multi = (rng.random((6, 9)) < 0.3).astype(np.float32)
    multi[0] = 0  # a row without positives
    return logits, labels, soft, multi


@pytest.mark.parametrize("name,target", [
    ("cross_entropy", "labels"), ("label_smoothing_cross_entropy", "labels"),
    ("soft_target_cross_entropy", "soft"), ("focal_loss", "multi"),
    ("multi_softmax_cross_entropy", "multi"), ("multilabel_soft_margin", "multi"),
    ("bce", "multi"), ("mse", "soft"), ("cross_entropy_per_sample", "labels"),
    ("label_smoothing_per_sample", "labels"),
])
def test_losses_match_jax(name, target):
    logits, labels, soft, multi = _loss_cases()
    t = {"labels": labels, "soft": soft, "multi": multi}[target]
    ref = getattr(jax_loss, name)(jnp.asarray(logits), jnp.asarray(t))
    ours = getattr(loss, name)(torch.from_numpy(logits), torch.from_numpy(t))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-6, rtol=1e-6)
    if name == "multi_softmax_cross_entropy":
        ref = jax_loss.multi_softmax_cross_entropy(jnp.asarray(logits), jnp.asarray(t), 0.1)
        ours = loss.multi_softmax_cross_entropy(torch.from_numpy(logits),
                                                torch.from_numpy(t), 0.1)
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("opts", [
    ["AUG.MIXUP_PROB", "1.0", "LOSS.LABEL_SMOOTHING", "0.1"],
    ["LOSS.LABEL_SMOOTHING", "0.1"],
    [],
    ["LOSS.LOSS", "sigmoid"],
    ["LOSS.LOSS", "bce"],
    ["LOSS.LOSS", "mse"],
])
def test_criterion_dispatch_matches_jax(opts):
    cfg = get_default_cfg()
    cfg.merge_from_list(opts)
    logits, labels, soft, multi = _loss_cases()
    t = labels if cfg.LOSS.LOSS == "xentropy" else multi
    for train in (True, False):
        tt = soft if (train and cfg.AUG.MIXUP_PROB > 0) else t
        ref = jax_loss.get_criterion(cfg, train)(jnp.asarray(logits), jnp.asarray(tt))
        ours = loss.get_criterion(cfg, train)(torch.from_numpy(logits), torch.from_numpy(tt))
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-6, rtol=1e-6)
    ref_ps, ours_ps = jax_loss.get_per_sample_criterion(cfg), loss.get_per_sample_criterion(cfg)
    ref = ref_ps(jnp.asarray(logits), jnp.asarray(t))
    ours = ours_ps(torch.from_numpy(logits), torch.from_numpy(t))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-6, rtol=1e-6)


def _jax_draws(seed, h, w, a_mix, a_cut, prob, switch):
    """The draws ``vil_tpu.data.mixup.make_mixup_fn`` makes from PRNGKey(seed)."""
    r_apply, r_switch, r_lam_m, r_lam_c, r_box = jax.random.split(jax.random.PRNGKey(seed), 5)
    apply = bool(jax.random.uniform(r_apply) < prob)
    use_cutmix = a_cut > 0 and (a_mix <= 0 or bool(jax.random.uniform(r_switch) < switch))
    lam = float(jax.random.beta(r_lam_m, a_mix, a_mix))
    lam_cut = jax.random.beta(r_lam_c, a_cut, a_cut)
    box = jax_mixup._rand_bbox(r_box, h, w, lam_cut)
    return mixup.MixupDraws(torch.tensor(apply), torch.tensor(use_cutmix),
                            torch.tensor(lam, dtype=torch.float32),
                            tuple(torch.tensor(int(b), dtype=torch.int32) for b in box))


@pytest.mark.parametrize("prob", [1.0, 0.5])
def test_apply_mixup_matches_jax_with_injected_draws(prob):
    """Both branches (mixup and cutmix) and, at prob 0.5, the batch left
    alone: images and soft targets equal make_mixup_fn's."""
    h, w, n_cls = 12, 10, 7
    images = _rng(6, 4, h, w, 3)
    labels = np.array([0, 3, 6, 2])
    fn = jax_mixup.make_mixup_fn(0.8, 1.0, prob, 0.5, 0.1, n_cls)
    seen = set()
    for seed in range(40):
        draws = _jax_draws(seed, h, w, 0.8, 1.0, prob, 0.5)
        ref_x, ref_y = fn(jax.random.PRNGKey(seed), jnp.asarray(images), jnp.asarray(labels))
        x, y = mixup.apply_mixup(torch.from_numpy(images), torch.from_numpy(labels), draws,
                                 n_cls, 0.1)
        np.testing.assert_allclose(x.numpy(), np.asarray(ref_x), atol=1e-6, rtol=1e-6)
        np.testing.assert_allclose(y.numpy(), np.asarray(ref_y), atol=1e-6, rtol=1e-6)
        seen.add((bool(draws.apply), bool(draws.use_cutmix)))
    want = {(True, True), (True, False)} | ({(False, True), (False, False)} if prob < 1 else set())
    assert want <= seen


def test_sample_mixup_draws():
    """λ ~ Beta(0.8, 0.8) (mean 1/2, variance 1/(4(2α+1))), Beta(1, 1) for
    the cut; boxes inside the image; one seed gives one sequence."""
    gen = torch.Generator().manual_seed(0)
    lams, cuts, areas = [], [], []
    for _ in range(2000):
        d = mixup.sample_mixup(gen, 32, 24)
        lams.append(float(d.lam))
        cuts.append(bool(d.use_cutmix))
        y0, x0, y1, x1 = (int(t) for t in d.box)
        assert 0 <= y0 <= y1 <= 32 and 0 <= x0 <= x1 <= 24
        areas.append((y1 - y0) * (x1 - x0) / (32 * 24))
        assert bool(d.apply)
    lams = np.array(lams)
    assert abs(lams.mean() - 0.5) < 0.03 and abs(lams.var() - 1 / 10.4) < 0.01
    assert 0 <= lams.min() and lams.max() <= 1
    assert abs(np.mean(cuts) - 0.5) < 0.05
    assert 0 < np.mean(areas) < 0.6
    a = mixup.sample_mixup(torch.Generator().manual_seed(7), 8, 8)
    b = mixup.sample_mixup(torch.Generator().manual_seed(7), 8, 8)
    assert float(a.lam) == float(b.lam) and [int(t) for t in a.box] == [int(t) for t in b.box]


def test_mixup_from_cfg():
    cfg = get_default_cfg()
    assert mixup.mixup_from_cfg(cfg) is None
    cfg.merge_from_list(["AUG.MIXUP_PROB", "1.0", "AUG.MIXUP", "0.8", "AUG.MIXCUT", "1.0",
                         "DATA.NUM_CLASSES", "5"])
    x, y = mixup.mixup_from_cfg(cfg)(torch.Generator().manual_seed(0), torch.rand(4, 8, 8, 3),
                                     torch.tensor([0, 1, 2, 3]))
    assert x.shape == (4, 8, 8, 3) and y.shape == (4, 5)
    torch.testing.assert_close(y.sum(-1), torch.ones(4))


@pytest.mark.parametrize("name,kw", [
    ("warmup_multistep", dict(milestones=(5, 12), gamma=0.1, warmup_factor=0.2,
                              warmup_iters=4)),
    ("warmup_multistep", dict(milestones=(3,), gamma=0.5, warmup_method="constant",
                              warmup_iters=6)),
    ("warmup_cosine", dict(max_iter=20, min_lr=1e-5, warmup_factor=0.002, warmup_iters=5)),
    ("warmup_linear", dict(max_iter=20, min_lr=1e-5, warmup_factor=0.1, warmup_iters=5)),
])
def test_schedules_match_jax(name, kw):
    ref = getattr(jax_sched, name)(5e-4, **kw)
    ours = getattr(schedulers, name)(5e-4, **kw)
    np.testing.assert_allclose([ours(s) for s in range(20)],
                               [float(ref(s)) for s in range(20)], rtol=1e-6, atol=1e-12)


@pytest.mark.parametrize("policy,epoch_based", [("cosine", False), ("multistep", True),
                                                ("linear", False), ("none", False)])
def test_get_lr_schedule_matches_jax(policy, epoch_based):
    cfg = get_default_cfg()
    cfg.merge_from_list(["SOLVER.LR_POLICY", policy, "SOLVER.STEPS_PER_EPOCH", "3",
                         "SOLVER.MAX_ITER", "20", "SOLVER.EPOCH_BASED_SCHEDULE",
                         str(epoch_based), "OPTIM.EPOCHS", "6", "OPTIM.DROP_FREQ", "2",
                         "SOLVER.WARMUP_EPOCHS", "1.0"])
    ref, ours = jax_sched.get_lr_schedule(cfg), schedulers.get_lr_schedule(cfg)
    if policy == "none":
        assert ref is None and ours is None
        return
    np.testing.assert_allclose([ours(s) for s in range(20)],
                               [float(ref(s)) for s in range(20)], rtol=1e-6, atol=1e-12)


@pytest.mark.parametrize("with_map", [False, True])
def test_topk_correct_matches_jax(with_map):
    rng = np.random.default_rng(8)
    logits = rng.standard_normal((16, 12)).astype(np.float32)
    targets = rng.integers(0, 12, 16)
    valid = overlap = None
    if with_map:
        target_map = {t: [int(c) for c in rng.choice(12, 2, replace=False)] for t in range(12)}
        valid, overlap = engine.build_target_map_arrays(target_map, 12, 12)
        ref_valid, ref_overlap = jax_engine.build_target_map_arrays(target_map, 12, 12)
        assert (valid == ref_valid).all() and (overlap == ref_overlap).all()
    ref = jax_engine.topk_correct(jnp.asarray(logits), jnp.asarray(targets), (1, 5), valid,
                                  overlap)
    ours = engine.topk_correct(torch.from_numpy(logits), torch.from_numpy(targets), (1, 5),
                               valid, overlap)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


def test_eval_step_masks_padding():
    model = MsViT(ARCH_PAD, img_size=56, num_classes=5, device="cpu",
                  generator=torch.Generator().manual_seed(0), **COMMON)
    x = torch.from_numpy(_rng(9, 4, 56, 56, 3))
    y = torch.tensor([1, 2, 3, 4])
    step = engine.make_eval_step(model, loss.cross_entropy,
                                 per_sample_criterion=loss.cross_entropy_per_sample)
    full = step(x[:2], y[:2], torch.ones(2))
    padded = step(x, y, torch.tensor([1.0, 1.0, 0.0, 0.0]))
    torch.testing.assert_close(padded["loss"], full["loss"], atol=1e-6, rtol=1e-6)
    assert padded["count"].item() == 2
    assert padded["top5_sum"].item() == full["top5_sum"].item()


def test_drop_path_keep_rate_scale_and_one_draw_per_sample():
    dp = DropPath(0.25).train()
    gen = torch.Generator().manual_seed(0)
    out = dp(torch.ones(40000, 3), gen)
    kept = out[:, 0] != 0
    assert abs(kept.float().mean().item() - 0.75) < 0.015
    assert torch.equal(out[kept], torch.full_like(out[kept], 1 / 0.75))
    assert (out[~kept] == 0).all()
    # the chunked pair: one draw covers x_glo and x_img of a sample
    x_glo, x_img = torch.ones(64, 1, 8), torch.ones(64, 2, 2, 4, 8)
    y_glo, y_img = dp((x_glo, x_img), torch.Generator().manual_seed(1))
    assert torch.equal(y_glo[:, 0, 0] != 0, y_img[:, 0, 0, 0, 0] != 0)
    assert 0 < (y_img != 0).all(dim=(1, 2, 3, 4)).sum() < 64
    assert (y_img.flatten(1) != 0).all(1).eq((y_img.flatten(1) != 0).any(1)).all()
    same = dp((x_glo, x_img), torch.Generator().manual_seed(1))
    assert torch.equal(same[1], y_img)
    none_glo = dp((None, x_img), torch.Generator().manual_seed(1))
    assert none_glo[0] is None and torch.equal(none_glo[1], y_img)
    assert dp.eval()(x_img) is x_img and DropPath(0.0).train()(x_img) is x_img


def test_drop_path_rate_spreads_over_depth():
    model = MsViT(ARCH_PAD, img_size=56, num_classes=5, drop_path_rate=0.1, device="cpu",
                  **COMMON)
    rates = [model.stage1_block0_attn.droppath.rate, model.stage2_block0_mlp.droppath.rate,
             model.stage3_block0_attn.droppath.rate]
    np.testing.assert_allclose(rates, [0.0, 0.05, 0.1])
    x = torch.from_numpy(_rng(10, 2, 56, 56, 3))
    a = model.train()(x, torch.Generator().manual_seed(3))
    b = model(x, torch.Generator().manual_seed(3))
    torch.testing.assert_close(a, b, atol=0, rtol=0)


def test_f32_parameters_under_bf16_compute_serve_as_bf16_parameters():
    """Parameters kept in f32 and cast at use give the logits of the same
    parameters stored in bf16; the residual stream is in the compute type."""
    x = torch.from_numpy(np.random.default_rng(11).integers(0, 256, (2, 56, 56, 3),
                                                           dtype=np.uint8))
    outs = []
    for param_dtype in (torch.float32, torch.bfloat16):
        model = MsViT(ARCH_PAD, img_size=56, num_classes=5, dtype=torch.bfloat16,
                      param_dtype=param_dtype, device="cpu",
                      generator=torch.Generator().manual_seed(0), **COMMON).eval()
        assert next(model.parameters()).dtype == param_dtype
        with torch.inference_mode():
            outs.append(model(x))
    assert outs[0].dtype == torch.bfloat16
    torch.testing.assert_close(outs[0], outs[1], atol=0, rtol=0)


def test_train_step_on_bf16_compute_keeps_f32_parameters():
    model = MsViT(ARCH_PAD, img_size=56, num_classes=5, dtype=torch.bfloat16,
                  drop_path_rate=0.1, device="cpu",
                  generator=torch.Generator().manual_seed(0), **COMMON)
    opt = torch.optim.AdamW(optim.param_groups(model, 0.05, 0.0, decoupled=True), lr=1e-3)
    step = engine.make_train_step(model, loss.soft_target_cross_entropy, opt,
                                  schedulers.warmup_cosine(1e-3, 10, 0.0, 0.1, 2),
                                  mixup.make_mixup_fn(num_classes=5), device="cpu")
    before = model.head.weight.detach().clone()
    gen = torch.Generator().manual_seed(0)
    x = torch.from_numpy(_rng(12, 4, 56, 56, 3))
    for _ in range(2):
        metrics = step(x, torch.tensor([0, 1, 2, 3]), gen)
        assert torch.isfinite(metrics["loss"]) and "top1" not in metrics
    assert model.head.weight.dtype == torch.float32
    assert not torch.equal(model.head.weight, before)
    assert opt.param_groups[0]["lr"] == pytest.approx(
        schedulers.warmup_cosine(1e-3, 10, 0.0, 0.1, 2)(1))
    plain = engine.make_train_step(model, loss.cross_entropy, opt, device="cpu")
    metrics = plain(x, torch.tensor([0, 1, 2, 3]), gen)
    assert set(metrics) == {"loss", "top1", "top5"}
    assert [fn.launches for fn in KERNELS] == [0] * len(KERNELS)


def test_entry_points_need_a_card_unless_given_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MsViT(ARCH_PAD, img_size=56, **COMMON)
    cfg = _train_cfg()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model(cfg)
    model = build_model(cfg, device="cpu")
    assert next(model.parameters()).device.type == "cpu"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        engine.make_train_step(model, loss.cross_entropy, optim.get_opt(cfg, model))
