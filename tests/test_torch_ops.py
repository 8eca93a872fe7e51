"""The port's copied tables and sliding-chunk tier against ``vil_tpu``.

``vil_tpu_torch.ops.masks`` and ``vil_tpu_torch.models.arch`` are copies of
the JAX package's pure-numpy modules: their tables must be bitwise equal.
The sliding-chunk primitives (modes 0, -1 and the sampled-neighbour modes
1..8) must match ``vil_tpu.ops.sliding_chunk`` in f32 at atol 1e-6, on
inputs scaled so that the outputs are of order 1 (f32 rounds a sum of order
10 by ~1e-6 already).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vil_tpu.models import arch as jax_arch
from vil_tpu.ops import masks as jax_masks
from vil_tpu.ops import sliding_chunk as jax_sc

from vil_tpu_torch.models import arch
from vil_tpu_torch.ops import masks
from vil_tpu_torch.ops import sliding_chunk as sc

GRIDS = [(3, 3, 1, 2, 3), (2, 2, 0, 0, 4), (4, 3, 2, 1, 3), (8, 8, 0, 0, 7)]


@pytest.mark.parametrize("mx,my,padx,pady,w", GRIDS)
def test_mask_tables_bitwise_equal(mx, my, padx, pady, w):
    for exact in (0, -1, 1):
        for mode in ((0,) if exact == 1 else (0, -1, 1, 5, 8)):
            ours = masks.invalid_mask(mx, my, padx, pady, w, exact, mode)
            ref = jax_masks.invalid_mask(mx, my, padx, pady, w, exact, mode)
            assert ours.dtype == ref.dtype and np.array_equal(ours, ref)
    for exact in (0, -1):
        assert np.array_equal(masks.all_mode_masks(mx, my, padx, pady, w, exact),
                              jax_masks.all_mode_masks(mx, my, padx, pady, w, exact))
    nx, ny = mx * w - padx, my * w - pady
    assert np.array_equal(masks.chunk_valid(nx, ny, w), jax_masks.chunk_valid(nx, ny, w))
    assert masks.NEIGHBOR_OFFSETS == jax_masks.NEIGHBOR_OFFSETS
    assert masks.SELF_BLOCK == jax_masks.SELF_BLOCK


def test_arch_tables_equal():
    assert arch.ARCH_ZOO == jax_arch.ARCH_ZOO
    for name, s in arch.ARCH_ZOO.items():
        ours = [vars(c) for c in arch.parse_arch(s)]
        assert ours == [vars(c) for c in jax_arch.parse_arch(s)], name
    assert arch._DEFAULTS == jax_arch._DEFAULTS
    assert [vars(c) for c in arch.parse_arch("l1,h2_l2_l3,a0")] == [
        vars(c) for c in jax_arch.parse_arch("l1,h2_l2_l3,a0")]
    for bad in ("l1_l2", "l1,x3_l2_l3", "l2_l2_l3", "l1,_l2_l3"):
        with pytest.raises(ValueError):
            jax_arch.parse_arch(bad)
        with pytest.raises(ValueError):
            arch.parse_arch(bad)


@pytest.mark.parametrize("nx,ny,w", [(7, 8, 3), (14, 14, 7), (5, 9, 4)])
def test_chunkify_unchunkify_match_jax(nx, ny, w):
    x = np.random.default_rng(0).standard_normal((2, nx * ny, 5)).astype(np.float32)
    ours = sc.chunkify(torch.from_numpy(x), nx, ny, w)
    ref = jax_sc.chunkify(jnp.asarray(x), nx, ny, w)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-6)
    back = sc.unchunkify(ours, nx, ny, w)
    np.testing.assert_allclose(back.numpy(), np.asarray(jax_sc.unchunkify(ref, nx, ny, w)),
                               atol=1e-6)
    np.testing.assert_array_equal(back.numpy(), x)
    assert sc.chunk_grid(nx, ny, w) == jax_sc.chunk_grid(nx, ny, w)


@pytest.mark.parametrize("mode", [0, -1, 1, 2, 3, 4, 5, 6, 7, 8])
@pytest.mark.parametrize("mx,my", [(3, 4), (2, 2), (1, 3)])
def test_sliding_chunk_qk_av_match_jax(mode, mx, my):
    rng = np.random.default_rng(1)
    w2, M = 4, 6
    q, k, v = ((rng.standard_normal((3, mx, my, w2, M)) * 0.4).astype(np.float32)
               for _ in range(3))
    span = {0: 9, -1: 1}.get(mode, 2) * w2
    attn = rng.dirichlet(np.ones(span), (3, mx, my, w2)).astype(np.float32)
    tq, tk, tv, ta = map(torch.from_numpy, (q, k, v, attn))
    np.testing.assert_allclose(
        sc.sliding_chunk_qk(tq, tk, mode).numpy(),
        np.asarray(jax_sc.sliding_chunk_qk(jnp.asarray(q), jnp.asarray(k), mode)),
        atol=1e-6)
    np.testing.assert_allclose(
        sc.sliding_chunk_av(ta, tv, mode).numpy(),
        np.asarray(jax_sc.sliding_chunk_av(jnp.asarray(attn), jnp.asarray(v), mode)),
        atol=1e-6)
    np.testing.assert_array_equal(
        sc.neighborhood(tk, mode).numpy(),
        np.asarray(jax_sc.neighborhood(jnp.asarray(k), mode)))
    if mode > 0:
        np.testing.assert_array_equal(sc.sampled_roll(tk, mode).numpy(),
                                      np.asarray(jax_sc.sampled_roll(jnp.asarray(k), mode)))


def test_unported_modes_raise():
    """Modes outside -1..8 (and non-int modes) are refused; the sampled roll
    takes only 1..8."""
    t = torch.zeros(1, 2, 2, 4, 3)
    for bad in (9, -2, 1.0, True):
        with pytest.raises(ValueError):
            sc.neighborhood(t, bad)
    for bad in (0, -1, 9):
        with pytest.raises(ValueError):
            sc.sampled_roll(t, bad)
    np.testing.assert_array_equal(sc.MODE_ROLL_SHIFTS, jax_sc.MODE_ROLL_SHIFTS)
    with pytest.raises(ValueError):
        sc.chunkify(torch.zeros(1, 10, 3), 3, 4, 2)
