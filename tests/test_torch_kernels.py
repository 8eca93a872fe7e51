"""The port's kernel modules against the JAX package's kernels, on the CPU.

On the CPU each wrapper runs its kernel's plain PyTorch version, which is
what is compared here with ``vil_tpu``'s Pallas kernel in interpret mode and
with its XLA reference, in f32 at atol 1e-5. The CUDA kernels themselves run
only on a card: ``test_torch_gpu.py`` compares them with the plain versions
there.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vil_tpu.ops import masks as jax_masks
from vil_tpu.ops.pallas import full_attention as jax_full_attention
from vil_tpu.ops.pallas import vil_kernel as jax_vil_kernel

from vil_tpu_torch.ops import masks
from vil_tpu_torch.ops import sliding_chunk as sc
from vil_tpu_torch.ops.kernels import (
    KERNELS,
    full_attention_fwd,
    full_attention_reference,
    mask_to_additive,
    vil_attention_fwd,
    vil_attention_reference,
)


def _vil_inputs(seed, B, nx, ny, w, C, H, nglo, exact, with_bias):
    rng = np.random.default_rng(seed)
    padx, pady, mx, my = sc.chunk_grid(nx, ny, w)
    w2 = w * w
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    q, k, v = f(B, mx, my, w2, C), f(B, mx, my, w2, C), f(B, mx, my, w2, C)
    kg = f(B, nglo, C) if nglo else None
    vg = f(B, nglo, C) if nglo else None
    bias = f(H, w2, nglo + 9 * w2) * 0.5 if with_bias else None
    mask_bool = masks.invalid_mask(mx, my, padx, pady, w, exact, 0)
    mask = mask_to_additive(mask_bool, mx, my, w2, nglo)
    return q, k, v, kg, vg, bias, mask


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


@pytest.mark.parametrize("exact", [0, -1, 1])
@pytest.mark.parametrize("H", [1, 3])
@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("nglo", [0, 1])
def test_vil_attention_matches_pallas_and_xla(nglo, with_bias, H, exact):
    """Padded 3×3 grid of 3×3 chunks: masked keys in all three semantics."""
    q, k, v, kg, vg, bias, mask = _vil_inputs(
        0, 2, 7, 8, 3, 8 * H, H, nglo, exact, with_bias)
    with torch.inference_mode():
        ours = vil_attention_fwd(*map(_t, (q, k, v, kg, vg, bias, mask)), H).numpy()
    jargs = tuple(map(_j, (q, k, v, kg, vg, bias)))
    pallas = jax_vil_kernel._pallas_forward_mh(*jargs, mask, H, interpret=True)
    xla = jax_vil_kernel._xla_reference_mh(*jargs, mask, H)
    np.testing.assert_allclose(ours, np.asarray(pallas), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(ours, np.asarray(xla), atol=1e-5, rtol=1e-5)


def test_vil_attention_cyclic_small_grid():
    """mx = my = 2: neighbour chunks coincide and are each counted again, as
    the 3×3 cyclic neighbourhood has them (no chunk is skipped)."""
    q, k, v, kg, vg, bias, mask = _vil_inputs(1, 1, 4, 4, 2, 16, 2, 1, -1, True)
    with torch.inference_mode():
        ours = vil_attention_reference(*map(_t, (q, k, v, kg, vg, bias, mask)), 2)
    xla = jax_vil_kernel._xla_reference_mh(*map(_j, (q, k, v, kg, vg, bias)), mask, 2)
    np.testing.assert_allclose(ours.numpy(), np.asarray(xla), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("nglo", [0, 2])
def test_mask_to_additive_matches_jax(nglo):
    for exact in (0, -1, 1):
        mask_bool = jax_masks.invalid_mask(3, 4, 1, 2, 3, exact, 0)
        ours = mask_to_additive(mask_bool, 3, 4, 9, nglo)
        ref = jax_vil_kernel.mask_to_additive(mask_bool, 3, 4, 9, nglo)
        assert ours.dtype == ref.dtype and np.array_equal(ours, ref)


@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("H,N", [(1, 9), (3, 20), (2, 70)])
def test_full_attention_matches_pallas_and_xla(with_bias, H, N):
    rng = np.random.default_rng(2)
    C = 8 * H
    q, k, v = (rng.standard_normal((2, N, C)).astype(np.float32) for _ in range(3))
    bias = (rng.standard_normal((H, N, N)) * 0.5).astype(np.float32) if with_bias else None
    with torch.inference_mode():
        ours = full_attention_fwd(*map(_t, (q, k, v, bias)), H).numpy()
    jargs = tuple(map(_j, (q, k, v, bias)))
    pallas = jax_full_attention._pallas_forward(*jargs, H, interpret=True)
    xla = jax_full_attention._xla_reference(*jargs, H)
    np.testing.assert_allclose(ours, np.asarray(pallas), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(ours, np.asarray(xla), atol=1e-5, rtol=1e-5)


def test_wrappers_run_plain_versions_on_cpu_without_launching():
    for fn in KERNELS:
        fn.launches = 0
    q, k, v, kg, vg, bias, mask = map(_t, _vil_inputs(3, 1, 6, 6, 3, 16, 2, 1, 0, True))
    torch.testing.assert_close(vil_attention_fwd(q, k, v, kg, vg, bias, mask, 2),
                               vil_attention_reference(q, k, v, kg, vg, bias, mask, 2),
                               atol=0, rtol=0)
    x = torch.randn(2, 11, 16)
    torch.testing.assert_close(full_attention_fwd(x, x, x, None, 2),
                               full_attention_reference(x, x, x, None, 2), atol=0, rtol=0)
    # bf16 in, bf16 out: computed in f32 and rounded once
    xb = x.to(torch.bfloat16)
    out = full_attention_fwd(xb, xb, xb, None, 2)
    assert out.dtype == torch.bfloat16
    torch.testing.assert_close(out, full_attention_reference(xb.float(), xb.float(),
                                                             xb.float(), None, 2
                                                             ).to(torch.bfloat16))
    assert [fn.launches for fn in KERNELS] == [0, 0]


def test_wrappers_reject_what_the_kernels_do_not_take():
    q, k, v, kg, vg, bias, mask = map(_t, _vil_inputs(4, 1, 6, 6, 3, 16, 2, 1, 0, True))
    bad_cases = [
        (ValueError, (q, k, v, kg, vg, bias, mask, 3)),  # C not a multiple of H
        (ValueError, (q, k, v, kg, None, bias, mask, 2)),  # one global operand
        (TypeError, (q.double(), k.double(), v.double(), None, None, None, mask, 2)),
        (TypeError, (q.half(), k.half(), v.half(), None, None, None, mask, 2)),
        (ValueError, (q, k, v, kg, vg, bias.double(), mask, 2)),
        (ValueError, (q, k, v, kg, vg, bias, mask[..., 1:], 2)),  # columns
        (ValueError, (q, k, v, None, None, None, mask, 2)),  # nglo vs mask
        (ValueError, (q.transpose(1, 2), k, v, kg, vg, bias, mask, 2)),
        (ValueError, (q[..., :8], k[..., :8], v[..., :8], None, None, None,
                      mask[..., 1:], 1)),  # not contiguous
    ]
    for exc, args in bad_cases:
        with pytest.raises(exc):
            vil_attention_fwd(*args)
    x = torch.zeros(2, 5, 16)
    with pytest.raises(ValueError):
        full_attention_fwd(x, x, x[:, :4], None, 2)
    with pytest.raises(ValueError):
        full_attention_fwd(x, x, x, torch.zeros(2, 5, 4), 2)
    with pytest.raises(ValueError):
        full_attention_fwd(x, x, x, None, 5)
    with pytest.raises(TypeError):
        full_attention_fwd(x.half(), x.half(), x.half(), None, 2)
