"""The port's backward kernel modules against the JAX package's, on the CPU.

On the CPU each wrapper runs its kernel's plain PyTorch version: the
forwards' log-sum-exp, and the backwards by autograd through the plain
forward in f32. They are compared here with ``vil_tpu``'s Pallas kernels in
interpret mode (``_pallas_forward_mh``/``_pallas_forward`` with the LSE,
``vil_attention_backward``/``_pallas_backward`` from it) and with
``jax.vjp`` of the XLA references, in f32 at atol 1e-5. The CUDA kernels run
only on a card: ``test_torch_gpu.py`` and ``chip_smoke.py`` compare them with
these plain versions there.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vil_tpu.ops.pallas import full_attention as jax_full_attention
from vil_tpu.ops.pallas import vil_backward as jax_vil_backward
from vil_tpu.ops.pallas import vil_kernel as jax_vil_kernel

from vil_tpu_torch.ops import masks
from vil_tpu_torch.ops import sliding_chunk as sc
from vil_tpu_torch.ops.kernels import (
    KERNELS,
    full_attention,
    full_attention_bwd,
    full_attention_fwd,
    full_attention_reference,
    mask_to_additive,
    vil_attention,
    vil_attention_bwd,
    vil_attention_fwd,
    vil_attention_reference,
)
from vil_tpu_torch.ops.kernels.vil_attention import _glo_heads, _heads
from vil_tpu_torch.ops.kernels.vil_attention_halo import (
    halo_neighborhood,
    vil_attention_halo_bwd,
    vil_attention_halo_fwd,
)

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


def _vil_inputs(seed, B, nx, ny, w, C, H, nglo, exact, with_bias):
    rng = np.random.default_rng(seed)
    padx, pady, mx, my = sc.chunk_grid(nx, ny, w)
    w2 = w * w
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    q, k, v, g = (f(B, mx, my, w2, C) for _ in range(4))
    kg = f(B, nglo, C) if nglo else None
    vg = f(B, nglo, C) if nglo else None
    bias = f(H, w2, nglo + 9 * w2) * 0.5 if with_bias else None
    mask = mask_to_additive(masks.invalid_mask(mx, my, padx, pady, w, exact, 0),
                            mx, my, w2, nglo)
    return q, k, v, kg, vg, bias, g, mask


def _t(a):
    return None if a is None else torch.from_numpy(np.asarray(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


def _close(ours, ref, name=""):
    assert (ours is None) == (ref is None), name
    if ref is not None:
        np.testing.assert_allclose(np.asarray(ours), np.asarray(ref), atol=ATOL, rtol=ATOL,
                                   err_msg=name)


def _xla_vil_vjp(q, k, v, kg, vg, bias, g, mask, H):
    """jax.vjp of the XLA reference, (dq, dk, dv, dk_glo, dv_glo, dbias),
    jitted: one compile of the whole backward, where op-by-op dispatch takes
    several times as long (the mask is a constant of the trace)."""
    operands = tuple(map(_j, (q, k, v, kg, vg, bias)))
    present = [a for a in operands if a is not None]

    def fn(*args):
        it = iter(args)
        full = [None if a is None else next(it) for a in operands]
        return jax_vil_kernel._xla_reference_mh(*full, mask, H)

    @jax.jit
    def grads_of(upstream, *args):
        return jax.vjp(fn, *args)[1](upstream)

    grads = iter(grads_of(jnp.asarray(g), *present))
    return tuple(None if a is None else next(grads) for a in operands)


def _pallas_vil(jargs, g, mask, H):
    """``vil_tpu``'s Pallas forward with the LSE and its backward from that
    LSE, in interpret mode, each jitted with the mask as a constant: (out,
    lse, (dq, dk, dv, dk_glo, dv_glo, dbias))."""
    out, lse = jax.jit(lambda *a: jax_vil_kernel._pallas_forward_mh(
        *a, mask, H, interpret=True, with_lse=True))(*jargs)
    grads = jax.jit(lambda *a: jax_vil_backward.vil_attention_backward(
        *a, mask, H, lse=lse, interpret=True))(*jargs, jnp.asarray(g))
    return out, lse, grads


@pytest.mark.parametrize("exact", [0, -1, 1])
@pytest.mark.parametrize("H", [1, 3])
@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("nglo", [0, 1])
def test_vil_backward_matches_pallas_and_xla(nglo, with_bias, H, exact):
    """Padded 3×3 grid of 3×3 chunks: masked keys in all three semantics.
    The lse of the plain forward matches the Pallas forward's, and the plain
    backward the Pallas backward from that lse and the XLA vjp."""
    q, k, v, kg, vg, bias, g, mask = _vil_inputs(0, 2, 7, 8, 3, 8 * H, H, nglo, exact,
                                                 with_bias)
    out, lse = vil_attention_fwd(*map(_t, (q, k, v, kg, vg, bias, mask)), H, with_lse=True)
    p_out, p_lse, pallas = _pallas_vil(tuple(map(_j, (q, k, v, kg, vg, bias))), g, mask, H)
    _close(out.numpy(), p_out, "out")
    _close(lse.numpy(), p_lse, "lse")
    ours = vil_attention_bwd(*map(_t, (q, k, v, kg, vg, bias, g)), out, _t(mask), lse, H)
    xla = _xla_vil_vjp(q, k, v, kg, vg, bias, g, mask, H)
    for name, a, b, c in zip(("dq", "dk", "dv", "dk_glo", "dv_glo", "dbias"),
                             ours, pallas, xla):
        _close(None if a is None else a.numpy(), b, name + " vs pallas")
        _close(None if a is None else a.numpy(), c, name + " vs xla")


def test_vil_backward_cyclic_small_grid():
    """mx = my = 2: a key chunk is several neighbours of one query chunk and
    each occurrence adds; nglo 0 with SW_EXACT 1 leaves pad rows fully
    masked, whose gradient is that of a uniform average, not NaN."""
    q, k, v, kg, vg, bias, g, mask = _vil_inputs(1, 2, 13, 14, 7, 16, 2, 0, 1, True)
    out, lse = vil_attention_fwd(*map(_t, (q, k, v, kg, vg, bias, mask)), 2, with_lse=True)
    ours = vil_attention_bwd(*map(_t, (q, k, v, kg, vg, bias, g)), out, _t(mask), lse, 2)
    xla = _xla_vil_vjp(q, k, v, kg, vg, bias, g, mask, 2)
    for name, a, b in zip(("dq", "dk", "dv", "dk_glo", "dv_glo", "dbias"), ours, xla):
        assert a is None or torch.isfinite(a).all(), name
        _close(None if a is None else a.numpy(), b, name)


def _delta_from_out(g, out, H):
    """δ = rowsum(g ∘ out) per head, (B, H, mx, my, W²): the form the bf16
    backward kernels of B2 and B7b take in their prologue."""
    B, mx, my, w2, C = g.shape
    return (g.float() * out.float()).reshape(B, mx, my, w2, H, C // H).sum(-1).permute(
        0, 4, 1, 2, 3)


def _plain_delta(q, k, v, kg, vg, bias, g, mask, H, neighbours):
    """rowsum(P ∘ dP) of the plain version, (B, H, mx, my, W²): P the softmax
    of its scores over the [glo ‖ neighbourhood] keys, dP = g · [V_glo ‖
    V_nbh]ᵀ, ``neighbours`` its concatenation of a K or V operand."""
    B, mx, my, w2, _ = q.shape
    keys, values = neighbours(_heads(k, H)), neighbours(_heads(v, H))
    if kg is not None:
        glo = lambda t: _glo_heads(t, H)[:, None, None].expand(-1, mx, my, -1, -1)
        keys, values = torch.cat([glo(kg), keys], dim=3), torch.cat([glo(vg), values], dim=3)
    scores = _heads(q, H) @ keys.transpose(-1, -2) + mask[None]
    if bias is not None:
        scores = scores + bias.repeat(B, 1, 1)[:, None, None]
    dp = _heads(g, H) @ values.transpose(-1, -2)
    return (torch.softmax(scores, dim=-1) * dp).sum(-1).reshape(B, H, mx, my, w2)


@pytest.mark.parametrize("nglo,with_bias", [(0, False), (1, True), (2, False)])
@pytest.mark.parametrize("nbh", ["full", "halo"])
def test_delta_from_out_matches_rowsum_of_p_dp(nbh, nglo, with_bias):
    """The bf16 backward kernels of B2 and B7b take δ = rowsum(g ∘ out) for
    rowsum(P ∘ dP): at f32 the two agree within 1e-6 for the full and the
    halo neighbourhoods (a halo shard: the middle chunk row of three, K/V
    with the rows above and below), and with JAX's δ, rowsum(g ∘ out) of its
    XLA reference, within this file's ATOL (the two forwards sum in another
    order; measured 1.8e-6 at most)."""
    H = 2
    q, k, v, kg, vg, bias, g, mask = _vil_inputs(5, 2, 7, 8, 3, 8 * H, H, nglo, 0, with_bias)
    mask_t = _t(mask)
    if nbh == "full":
        ops = q, k, v, kg, vg, bias
        out = vil_attention_fwd(*map(_t, ops), mask_t, H)
        jax_out = jax_vil_kernel._xla_reference_mh(*map(_j, ops), mask, H)
        neighbours = lambda t: sc.neighborhood(t, 0)
    else:
        # K/V rows 0..2 are the halo-extended rows of query row 1
        ops = np.ascontiguousarray(q[:, 1:2]), k, v, kg, vg, bias
        g, mask_t = np.ascontiguousarray(g[:, 1:2]), mask_t[1:2]
        out = vil_attention_halo_fwd(*map(_t, ops), mask_t, H)
        jax_out = jax_vil_kernel._xla_reference_ext_mh(*map(_j, ops), mask[1:2], H)
        neighbours = halo_neighborhood
    ours = _delta_from_out(_t(g), out, H)
    plain = _plain_delta(*map(_t, ops), _t(g), mask_t, H, neighbours)
    jax_delta = _delta_from_out(_t(g), _t(np.array(jax_out)), H)
    np.testing.assert_allclose(ours.numpy(), plain.numpy(), atol=1e-6, rtol=1e-6)
    _close(ours.numpy(), jax_delta.numpy(), "delta vs JAX's")


@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("H,N,M", [
    pytest.param(1, 9, 8, id="1-9"), pytest.param(3, 20, 8, id="3-20"),
    pytest.param(2, 70, 8, id="2-70"),
    # ragged against the kernels' 64-row tiles, at the head dims of ViL
    pytest.param(2, 1, 32, id="2-1-M32"), pytest.param(1, 65, 64, id="1-65-M64"),
    pytest.param(2, 197, 32, id="2-197-M32"), pytest.param(1, 197, 64, id="1-197-M64"),
])
def test_full_backward_matches_pallas_and_xla(with_bias, H, N, M):
    """The backward wrapper, given the forward's out and lse, against the
    Pallas backward from the Pallas LSE and the vjp of the XLA reference."""
    rng = np.random.default_rng(2)
    C = M * H
    q, k, v, g = (rng.standard_normal((2, N, C)).astype(np.float32) for _ in range(4))
    if M > 8:  # the cases at ViL's head dims take q pre-scaled, as the model passes it
        q *= M ** -0.5
    bias = (rng.standard_normal((H, N, N)) * 0.5).astype(np.float32) if with_bias else None
    out, lse = full_attention_fwd(*map(_t, (q, k, v, bias)), H, with_lse=True)
    jargs = tuple(map(_j, (q, k, v, bias)))
    p_out, p_lse = jax_full_attention._pallas_forward(*jargs, H, interpret=True,
                                                      with_lse=True)
    _close(out.numpy(), p_out, "out")
    _close(lse.numpy(), p_lse, "lse")
    ours = full_attention_bwd(*map(_t, (q, k, v, bias, g)), out, lse, H)
    pallas = jax_full_attention._pallas_backward(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(g), p_lse, _j(bias), H,
        interpret=True)
    present = [a for a in jargs if a is not None]

    @jax.jit  # one compile of the whole backward, as _xla_vil_vjp
    def xla_vjp(upstream, *a):
        return jax.vjp(lambda *b: jax_full_attention._xla_reference(
            *b, *([None] if bias is None else []), H), *a)[1](upstream)

    xla = xla_vjp(jnp.asarray(g), *present)
    for i, name in enumerate(("dq", "dk", "dv", "dbias")):
        if name == "dbias" and bias is None:
            assert ours[3] is None
            continue
        _close(ours[i].numpy(), pallas[i], name + " vs pallas")
        _close(ours[i].numpy(), xla[i], name + " vs xla")


def test_autograd_functions_match_autograd_of_plain_versions():
    """The differentiable entry points (the autograd Functions, which run
    the backward wrappers) give the gradients of autograd through the plain
    versions, and launch nothing on the CPU."""
    for fn in KERNELS:
        fn.launches = 0
    q, k, v, kg, vg, bias, g, mask = _vil_inputs(3, 2, 7, 8, 3, 16, 2, 1, 0, True)
    mask_t = _t(mask)
    for attend in (vil_attention, vil_attention_reference):
        leaves = [_t(a).clone().requires_grad_() for a in (q, k, v, kg, vg, bias)]
        attend(*leaves, mask_t, 2).backward(_t(g))
        if attend is vil_attention:
            ours = [t.grad for t in leaves]
    for a, b in zip(ours, leaves):
        torch.testing.assert_close(a, b.grad, atol=1e-6, rtol=1e-6)
    x = [torch.randn(2, 11, 16, requires_grad=True) for _ in range(3)]
    gx = torch.randn(2, 11, 16)
    full_attention(*x, None, 2).backward(gx)
    ours = [t.grad.clone() for t in x]
    for t in x:
        t.grad = None
    full_attention_reference(*x, None, 2).backward(gx)
    for a, t in zip(ours, x):
        torch.testing.assert_close(a, t.grad, atol=1e-6, rtol=1e-6)
    assert [fn.launches for fn in KERNELS] == [0] * len(KERNELS)


def test_backward_wrappers_reject_what_the_kernels_do_not_take():
    q, k, v, kg, vg, bias, g, mask = map(_t, _vil_inputs(4, 1, 6, 6, 3, 16, 2, 1, 0, True))
    out, lse = vil_attention_fwd(q, k, v, kg, vg, bias, mask, 2, with_lse=True)
    bad = [
        (g[..., :8], out, lse),               # g of another shape
        (g.double(), out, lse),               # g of another dtype
        (g, out, lse[:, :1]),                 # lse of another shape
        (g, out, lse.double()),               # lse not f32
        (g.transpose(1, 2), out, lse),        # g not contiguous
        (g, out[..., :8], lse),               # out of another shape
        (g, out.double(), lse),               # out of another dtype
        (g, out.transpose(1, 2).contiguous().transpose(1, 2), lse),  # out not contiguous
        (g, None, lse),                       # no out
    ]
    for g_bad, out_bad, lse_bad in bad:
        with pytest.raises(ValueError):
            vil_attention_bwd(q, k, v, kg, vg, bias, g_bad, out_bad, mask, lse_bad, 2)
    vil_attention_bwd(q, k, v, kg, vg, bias, g, out, mask, lse, 2)  # well formed, passes
    k_ext, v_ext = (torch.cat([t[:, -1:], t, t[:, :1]], 1) for t in (k, v))
    with pytest.raises(ValueError):  # the halo backward takes out too
        vil_attention_halo_bwd(q, k_ext, v_ext, kg, vg, bias, g, None, mask, lse, 2)
    vil_attention_halo_bwd(q, k_ext, v_ext, kg, vg, bias, g, out, mask, lse, 2)
    x = torch.zeros(2, 5, 16)
    out, lse = full_attention_fwd(x, x, x, None, 2, with_lse=True)
    bad = [
        (x, out, lse[:, :, :4]),              # lse of another shape
        (x[:, :4], out, lse),                 # g of another shape
        (x, out[:, :4], lse),                 # out of another shape
        (x, out.double(), lse),               # out of another dtype
        (x, out.transpose(0, 1).contiguous().transpose(0, 1), lse),  # out not contiguous
    ]
    for g_bad, out_bad, lse_bad in bad:
        with pytest.raises(ValueError):
            full_attention_bwd(x, x, x, None, g_bad, out_bad, lse_bad, 2)
    full_attention_bwd(x, x, x, None, x, out, lse, 2)  # the same, well formed, passes
