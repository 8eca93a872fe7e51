"""The port's CUDA kernels on a card, against their plain PyTorch versions.

Marked ``gpu``: each test skips where no CUDA card is present (the kernels
have no CPU mode). This file imports neither jax nor ``vil_tpu``, so it also
runs on a host without them, without the repo's ``conftest.py``:

    python -m pytest --noconftest tests/test_torch_gpu.py -q

Tolerances: 1e-4 for f32 inputs (sums in another order); 2e-2 for bf16
inputs, against the plain version in f32 on the same bf16 values (the kernel
rounds its output to bf16 once). Gradients are held relative to the largest
magnitude of the reference: 1e-4 in f32, 3e-2 in bf16. The bf16 tensor-core
kernels (dense B3/B4, sliding-chunk forwards B1 and B5, sliding-chunk
backwards B2/B7b and B6, the fused block's forward B9a and backward B9b) are
also held at chip_smoke.py's limits: outputs 2e-2 and LSE 2e-5 absolute,
gradients 1e-2 of max(1, max|ref|), and max|err| / max|ref| of their outputs
2e-2, with no floor.
"""
import numpy as np
import pytest
import torch

from vil_tpu_torch.models import MsViT
from vil_tpu_torch.ops import masks
from vil_tpu_torch.ops import sliding_chunk as sc
from vil_tpu_torch.ops.kernels import (
    KERNELS,
    full_attention,
    full_attention_bwd,
    full_attention_bwd_reference,
    full_attention_fwd,
    full_attention_reference,
    layer_norm_bwd,
    layer_norm_bwd_reference,
    layer_norm_fwd,
    layer_norm_reference,
    mask_to_additive,
    vil_attention_bwd,
    vil_attention_bwd_reference,
    vil_attention_fwd,
    vil_attention_halo_bwd,
    vil_attention_halo_bwd_reference,
    vil_attention_halo_fwd,
    vil_attention_halo_reference,
    vil_attention_reference,
    vil_block_bwd,
    vil_block_bwd_reference,
    vil_block_fwd,
    vil_block_fwd_reference,
    vil_block_reference,
    vil_mode_attention_bwd,
    vil_mode_attention_bwd_reference,
    vil_mode_attention_fwd,
    vil_mode_attention_reference,
)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for fn in KERNELS:
        fn.launches = 0
    return torch.device("cuda")


def _max_err(out, ref):
    return (out.float() - ref).abs().max().item()


def _rel_err(out, ref):
    """max |out - ref| / max(1, max |ref|)."""
    ref = ref.float()
    return (out.float() - ref).abs().max().item() / max(1.0, ref.abs().max().item())


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
def test_kernels_match_plain_versions(cuda, dtype, tol):
    """A padded grid, a bias, an exact mask, nglo 0..5; dense N ragged
    against the 64-row tiles, with and without bias."""
    rng = np.random.default_rng(5)
    rnd = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(cuda)
    # (W, exact, nglo, bias); W=2 with nglo 5 spreads the global keys over
    # two key tiles of W² = 4 rows
    for w, exact, nglo, with_bias in ((7, 0, 1, False), (7, 1, 0, True),
                                      (7, -1, 2, True), (2, 0, 5, True)):
        w2 = w * w
        padx, pady, mx, my = sc.chunk_grid(13, 15, w)
        acts = [rnd(2, mx, my, w2, 64) * 0.5 for _ in range(3)]
        acts += [rnd(2, nglo, 64) if nglo else None for _ in range(2)]
        bias = rnd(2, w2, nglo + 9 * w2) if with_bias else None
        mask = torch.from_numpy(mask_to_additive(
            masks.invalid_mask(mx, my, padx, pady, w, exact, 0), mx, my, w2, nglo)).to(cuda)
        acts = [None if a is None else a.to(dtype) for a in acts]
        out = vil_attention_fwd(*acts, bias, mask, 2)
        ref = vil_attention_reference(*[None if a is None else a.float() for a in acts],
                                      bias, mask, 2)
        assert out.dtype == dtype and _max_err(out, ref) <= tol
    for N, with_bias in ((49, False), (197, True), (300, False)):
        q, k, v = (torch.randn(2, N, 96, device=cuda).to(dtype) for _ in range(3))
        bias = torch.randn(3, N, N, device=cuda) if with_bias else None
        out = full_attention_fwd(q, k, v, bias, 3)
        ref = full_attention_reference(q.float(), k.float(), v.float(), bias, 3)
        assert out.dtype == dtype and _max_err(out, ref) <= tol
    assert [fn.launches for fn in KERNELS] == [4, 3] + [0] * 10


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 3e-2)])
def test_backward_kernels_match_plain_versions(cuda, dtype, tol):
    """B2 on a padded grid with bias and nglo 2, a 2×2 cyclic grid with
    SW_EXACT 1 and nglo 0, and W=2 with 5 global keys; B4 at ragged N with
    and without bias, and at N=1025. The lse comes from the forward kernel."""
    rng = np.random.default_rng(6)
    rnd = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(cuda)
    for nx, ny, w, exact, nglo, with_bias in ((13, 15, 7, 0, 2, True), (13, 14, 7, 1, 0, False),
                                              (9, 8, 2, -1, 5, True)):
        w2 = w * w
        padx, pady, mx, my = sc.chunk_grid(nx, ny, w)
        acts = [rnd(2, mx, my, w2, 64) * 0.5 for _ in range(3)]
        acts += [rnd(2, nglo, 64) if nglo else None for _ in range(2)]
        acts = [None if a is None else a.to(dtype) for a in acts]
        bias = rnd(2, w2, nglo + 9 * w2) if with_bias else None
        mask = torch.from_numpy(mask_to_additive(
            masks.invalid_mask(mx, my, padx, pady, w, exact, 0), mx, my, w2, nglo)).to(cuda)
        g = rnd(2, mx, my, w2, 64).to(dtype)
        out, lse = vil_attention_fwd(*acts, bias, mask, 2, with_lse=True)
        _, lse_ref = vil_attention_reference(*[None if a is None else a.float() for a in acts],
                                             bias, mask, 2, with_lse=True)
        assert _max_err(lse, lse_ref) <= tol
        grads = vil_attention_bwd(*acts, bias, g, out, mask, lse, 2)
        refs = vil_attention_bwd_reference(*[None if a is None else a.float() for a in acts],
                                           bias, g.float(), mask, 2)
        for name, out, ref in zip(("dq", "dk", "dv", "dkg", "dvg", "dbias"), grads, refs):
            assert (out is None) == (ref is None), name
            if ref is not None:
                assert _rel_err(out, ref) <= tol, (name, nx, w, _rel_err(out, ref))
    for N, with_bias in ((49, False), (197, True), (1025, False)):
        q, k, v, g = (torch.randn(2, N, 96, device=cuda).to(dtype) for _ in range(4))
        bias = torch.randn(3, N, N, device=cuda) if with_bias else None
        out, lse = full_attention_fwd(q, k, v, bias, 3, with_lse=True)
        _, lse_ref = full_attention_reference(q.float(), k.float(), v.float(), bias, 3,
                                              with_lse=True)
        assert _max_err(lse, lse_ref) <= tol
        grads = full_attention_bwd(q, k, v, bias, g, out, lse, 3)
        refs = full_attention_bwd_reference(q.float(), k.float(), v.float(), bias, g.float(), 3)
        for name, out, ref in zip(("dq", "dk", "dv", "dbias"), grads, refs):
            assert (out is None) == (ref is None), name
            if ref is not None:
                assert _rel_err(out, ref) <= tol, (name, N, _rel_err(out, ref))
    assert [fn.launches for fn in KERNELS] == [3, 3, 3, 3] + [0] * 8


DENSE_BF16_TOL, DENSE_LSE_TOL, DENSE_GRAD_TOL = 2e-2, 2e-5, 1e-2  # chip_smoke.py's
DENSE_SCALED_TOL = 2e-2  # chip_smoke.py's: max|err| / max|ref| of out, dq, dk, dv


def _scaled_err(out, ref):
    top = ref.float().abs().max().item()
    return _max_err(out, ref) / top if top else _max_err(out, ref)


def _dense_case(cuda, seed, B, N, M, H, with_bias):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    q, k, v = (torch.randn(B, N, H * M, generator=gen, device=cuda) * M ** -0.25
               for _ in range(3))
    g = torch.randn(B, N, H * M, generator=gen, device=cuda)
    bias = torch.randn(H, N, N, generator=gen, device=cuda) * 0.5 if with_bias else None
    return [t.to(torch.bfloat16) for t in (q, k, v, g)], bias


def _dense_errors(q, k, v, g, bias, H, images=None):
    """(out, lse, grads, scaled) errors of the bf16 kernels against the plain
    versions in f32 on the same values, over ``images`` (all by default);
    scaled is the largest max|err| / max|ref| of out, dq, dk and dv."""
    out, lse = full_attention_fwd(q, k, v, bias, H, with_lse=True)
    grads = full_attention_bwd(q, k, v, bias, g, out, lse, H)
    sel = slice(None) if images is None else images
    a32 = [t[sel].float() for t in (q, k, v)]
    ref, ref_lse = full_attention_reference(*a32, bias, H, with_lse=True)
    refs = full_attention_bwd_reference(*a32, bias, g[sel].float(), H)
    pairs = [(x[sel], r) for x, r in zip(grads[:3], refs[:3])]
    scaled = max(_scaled_err(x, r) for x, r in [(out[sel], ref), *pairs])
    if bias is not None and images is None:
        pairs.append((grads[3], refs[3]))
    return (_max_err(out[sel], ref), _max_err(lse[sel], ref_lse),
            max(_rel_err(x, r) for x, r in pairs), scaled)


@pytest.mark.parametrize("M", [8, 16, 32, 64, 128])
def test_dense_bf16_kernels_every_head_dim(cuda, M):
    """B3/B4 in bf16 on the tensor cores at every head dim, N ragged against
    the 64-row tiles, B = 3, with and without a bias: out, LSE and every
    gradient at chip_smoke.py's tolerances."""
    for N in (1, 49, 63, 64, 65, 197, 1025):
        for with_bias in (False, True):
            ops, bias = _dense_case(cuda, N * M, 3, N, M, 2, with_bias)
            e_out, e_lse, e_grad, e_scaled = _dense_errors(*ops, bias, 2)
            case = (M, N, with_bias, e_out, e_lse, e_grad, e_scaled)
            assert e_out <= DENSE_BF16_TOL and e_lse <= DENSE_LSE_TOL, case
            assert e_grad <= DENSE_GRAD_TOL and e_scaled <= DENSE_SCALED_TOL, case
    assert full_attention_fwd.launches == full_attention_bwd.launches == 14


def test_dense_bf16_kernels_do_not_read_across_images(cuda):
    """Image 1 of 3 filled with 1e4: a ragged tile that read past row N of
    image 0 into image 1's rows would show in image 0's output, LSE and
    gradients (image 2 is the last: its tiles end at the buffer)."""
    for M, N in ((64, 1), (64, 49), (32, 65), (64, 197), (128, 100)):
        (q, k, v, g), _ = _dense_case(cuda, N, 3, N, M, 2, False)
        for t in (q, k, v, g):
            t[1] = 1e4
        for image in (0, 2):
            e_out, e_lse, e_grad, e_scaled = _dense_errors(q, k, v, g, None, 2,
                                                           slice(image, image + 1))
            case = (M, N, image, e_out, e_lse, e_grad, e_scaled)
            assert e_out <= DENSE_BF16_TOL and e_lse <= DENSE_LSE_TOL, case
            assert e_grad <= DENSE_GRAD_TOL and e_scaled <= DENSE_SCALED_TOL, case


def test_dense_bf16_backward_is_deterministic(cuda):
    """Two launches of the bf16 backward on the same inputs give bitwise-equal
    dq, dk, dv and dbias (no atomics: cross-block sums in a fixed order)."""
    for N, with_bias in ((197, False), (197, True), (1025, False)):
        (q, k, v, g), bias = _dense_case(cuda, 11, 4, N, 64, 6, with_bias)
        out, lse = full_attention_fwd(q, k, v, bias, 6, with_lse=True)
        first = full_attention_bwd(q, k, v, bias, g, out, lse, 6)
        second = full_attention_bwd(q, k, v, bias, g, out, lse, 6)
        for name, a, b in zip(("dq", "dk", "dv", "dbias"), first, second):
            assert (a is None) == (b is None) and (a is None or torch.equal(a, b)), (name, N)


CHUNK_GRAD_TOL = 1e-2  # chip_smoke.py's: B2 and B7b in bf16, max|err| / max(1, max|ref|)
CHUNK_SCALED_TOL = 2e-2  # chip_smoke.py's: max|err| / max|ref| of dq, dk, dv, dk_glo, dv_glo, dbias
CHUNK_OUT_TOL, CHUNK_LSE_TOL = 2e-2, 2e-5  # chip_smoke.py's BF16_TOL and LSE_TOL
# the grids of the bf16 sliding-chunk cases, (nx, ny, w, nglo, exact,
# with_bias): padded with nglo 1, biased with SW_EXACT 1 and nglo 2, W 4 with
# SW_EXACT -1 and nglo 5, the cyclic 1×2 and 2×2 grids, W 9, whose 81 rows a
# chunk take two 64-row slices; and the high-resolution windows: W 6 (36
# rows) and W 8 (64) on padded 3×3 grids, W 12 (144 rows in three slices,
# the last holding 16) biased, and ViL-Medium-Deep 384²'s 96×96 tokens in
# 14×14 chunks of W 7, pad 2
CHUNK_GRIDS = [(19, 20, 7, 1, 0, False), (19, 20, 7, 2, 1, True), (14, 15, 4, 5, -1, False),
               (7, 14, 7, 1, 0, False), (13, 14, 7, 0, 0, True), (27, 20, 9, 1, 0, True),
               (14, 13, 6, 1, 0, False), (17, 20, 8, 0, 0, True), (26, 30, 12, 1, 0, True),
               (96, 96, 7, 1, 0, False)]


def _chunk_case(cuda, seed, B, nx, ny, w, M, H, nglo, exact, with_bias, mode=0):
    """bf16 (q, k, v, k_glo, v_glo), bias, g and the additive mask of a
    sliding-chunk grid at ``mode`` (0: the 3×3 neighbourhood, 1..8: self and
    one sampled chunk); q, k, v at the model's scale (q pre-scaled)."""
    gen = torch.Generator(device=cuda).manual_seed(seed)
    padx, pady, mx, my = sc.chunk_grid(nx, ny, w)
    w2, C = w * w, H * M
    rnd = lambda *s: torch.randn(*s, generator=gen, device=cuda)
    acts = [rnd(B, mx, my, w2, C) * M ** -0.25 for _ in range(3)]
    acts += [rnd(B, nglo, C) * M ** -0.25 if nglo else None for _ in range(2)]
    bias = rnd(H, w2, nglo + (9 if mode == 0 else 2) * w2) * 0.5 if with_bias else None
    mask = torch.from_numpy(mask_to_additive(
        masks.invalid_mask(mx, my, padx, pady, w, exact, mode), mx, my, w2, nglo)).to(cuda)
    acts = [None if a is None else a.to(torch.bfloat16) for a in acts]
    return acts, bias, rnd(B, mx, my, w2, C).to(torch.bfloat16), mask


def _chunk_errors(acts, bias, g, mask, H, images=None):
    """(rel, scaled) errors of B2 in bf16, from B1's out and LSE, against the
    plain backward in f32 on the same values, over ``images`` (all by
    default): rel the largest max|err| / max(1, max|ref|) over every
    gradient, scaled the largest max|err| / max|ref| of dq, dk, dv, dk_glo,
    dv_glo and (with a bias, over all images) dbias."""
    out, lse = vil_attention_fwd(*acts, bias, mask, H, with_lse=True)
    grads = vil_attention_bwd(*acts, bias, g, out, mask, lse, H)
    sel = slice(None) if images is None else images
    a32 = [None if a is None else a[sel].float() for a in acts]
    refs = vil_attention_bwd_reference(*a32, bias, g[sel].float(), mask, H)
    pairs = [(x[sel], r) for x, r in zip(grads[:5], refs[:5]) if r is not None]
    if bias is not None and images is None:  # dbias sums over the images
        pairs.append((grads[5], refs[5]))
    return max(_rel_err(x, r) for x, r in pairs), max(_scaled_err(x, r) for x, r in pairs)


@pytest.mark.parametrize("M", [8, 16, 32, 64, 128])
def test_sliding_chunk_bf16_backward_every_head_dim(cuda, M):
    """B2 in bf16 on the tensor cores at every head dim: a padded grid with
    nglo 1, a biased one with SW_EXACT 1 and nglo 2, W 4 with SW_EXACT -1 and
    nglo 5, the cyclic 1×2 and 2×2 grids, and W 9, whose 81 rows a chunk
    take two 64-row slices: every gradient at chip_smoke.py's tolerances."""
    for i, (nx, ny, w, nglo, exact, with_bias) in enumerate(CHUNK_GRIDS):
        acts, bias, g, mask = _chunk_case(cuda, 100 * M + i, 2, nx, ny, w, M, 2, nglo, exact,
                                          with_bias)
        rel, scaled = _chunk_errors(acts, bias, g, mask, 2)
        case = (M, nx, ny, w, nglo, exact, with_bias, rel, scaled)
        assert rel <= CHUNK_GRAD_TOL and scaled <= CHUNK_SCALED_TOL, case
    assert vil_attention_bwd.launches == len(CHUNK_GRIDS)


def test_sliding_chunk_bf16_backward_does_not_read_across_images(cuda):
    """Image 1 of 3 filled with 1e4: a staged key or query row that read
    another image's rows (or past the list into the next chunk) would show
    in images 0 and 2's gradients."""
    for M, (nx, ny, w, nglo) in ((32, (56, 56, 7, 1)), (64, (13, 14, 7, 0)),
                                 (64, (14, 15, 4, 2))):
        acts, _, g, mask = _chunk_case(cuda, M, 3, nx, ny, w, M, 3, nglo, 0, False)
        for t in (*acts, g):
            if t is not None:
                t[1] = 1e4
        for image in (0, 2):
            rel, scaled = _chunk_errors(acts, None, g, mask, 3, slice(image, image + 1))
            case = (M, nx, w, image, rel, scaled)
            assert rel <= CHUNK_GRAD_TOL and scaled <= CHUNK_SCALED_TOL, case


def test_sliding_chunk_bf16_backward_is_deterministic(cuda):
    """Two launches of B2 and of B7b in bf16 on the same inputs give
    bitwise-equal gradients (no atomics)."""
    for nx, ny, w, nglo, with_bias in ((56, 56, 7, 1, False), (19, 20, 7, 2, True),
                                       (13, 14, 7, 0, False)):
        acts, bias, g, mask = _chunk_case(cuda, 12, 2, nx, ny, w, 32, 3, nglo, 0, with_bias)
        out, lse = vil_attention_fwd(*acts, bias, mask, 3, with_lse=True)
        first = vil_attention_bwd(*acts, bias, g, out, mask, lse, 3)
        second = vil_attention_bwd(*acts, bias, g, out, mask, lse, 3)
        for name, a, b in zip(("dq", "dk", "dv", "dkg", "dvg", "dbias"), first, second):
            assert (a is None) == (b is None) and (a is None or torch.equal(a, b)), (name, nx)
        q, k, v, kg, vg = acts
        (k_ext, _), (v_ext, _) = _halo_shard(k, 1, 1), _halo_shard(v, 1, 1)  # chunk row 1
        ops = [q[:, 1:2].contiguous(), k_ext, v_ext, kg, vg, bias]
        gs = g[:, 1:2].contiguous()
        out, lse = vil_attention_halo_fwd(*ops, mask[1:2], 3, with_lse=True)
        first = vil_attention_halo_bwd(*ops, gs, out, mask[1:2], lse, 3)
        second = vil_attention_halo_bwd(*ops, gs, out, mask[1:2], lse, 3)
        for name, a, b in zip(("dq", "dk", "dv", "dkg", "dvg", "dbias"), first, second):
            assert (a is None) == (b is None) and (a is None or torch.equal(a, b)), (name, nx)


def _fwd_errors(acts, bias, mask, H, images=None):
    """(out, lse, scaled) errors of B1 in bf16 against the plain forward in
    f32 on the same values, over ``images`` (all by default); the output
    without the LSE (serving) must equal the output with it, bit for bit."""
    out, lse = vil_attention_fwd(*acts, bias, mask, H, with_lse=True)
    assert torch.equal(vil_attention_fwd(*acts, bias, mask, H), out)
    sel = slice(None) if images is None else images
    a32 = [None if a is None else a[sel].float() for a in acts]
    ref, ref_lse = vil_attention_reference(*a32, bias, mask, H, with_lse=True)
    return _max_err(out[sel], ref), _max_err(lse[sel], ref_lse), _scaled_err(out[sel], ref)


@pytest.mark.parametrize("M", [8, 16, 32, 64, 128])
def test_sliding_chunk_bf16_forward_every_head_dim(cuda, M):
    """B1 in bf16 on the tensor cores at every head dim, on every grid of
    CHUNK_GRIDS, with and without the LSE: out, LSE and the scaled error at
    chip_smoke.py's tolerances."""
    for i, (nx, ny, w, nglo, exact, with_bias) in enumerate(CHUNK_GRIDS):
        acts, bias, _, mask = _chunk_case(cuda, 200 * M + i, 2, nx, ny, w, M, 2, nglo, exact,
                                          with_bias)
        e_out, e_lse, scaled = _fwd_errors(acts, bias, mask, 2)
        case = (M, nx, ny, w, nglo, exact, with_bias, e_out, e_lse, scaled)
        assert e_out <= CHUNK_OUT_TOL and e_lse <= CHUNK_LSE_TOL, case
        assert scaled <= CHUNK_SCALED_TOL, case
    assert vil_attention_fwd.launches == 2 * len(CHUNK_GRIDS)


def test_sliding_chunk_bf16_forward_does_not_read_across_images(cuda):
    """Image 1 of 3 filled with 1e4: a staged key row that read another
    image's rows, or past the columns into the next chunk, would show in
    images 0 and 2's output and LSE."""
    for M, (nx, ny, w, nglo) in ((32, (56, 56, 7, 1)), (64, (13, 14, 7, 0)),
                                 (64, (14, 15, 4, 2)), (32, (27, 20, 9, 1))):
        acts, _, _, mask = _chunk_case(cuda, M, 3, nx, ny, w, M, 3, nglo, 0, False)
        for t in acts:
            if t is not None:
                t[1] = 1e4
        for image in (0, 2):
            e_out, e_lse, scaled = _fwd_errors(acts, None, mask, 3, slice(image, image + 1))
            case = (M, nx, w, image, e_out, e_lse, scaled)
            assert e_out <= CHUNK_OUT_TOL and e_lse <= CHUNK_LSE_TOL, case
            assert scaled <= CHUNK_SCALED_TOL, case


def _mode_errors(acts, bias, g, mask, H, mode, images=None):
    """(rel, scaled) errors of B6 in bf16, from B5's out and LSE, against the
    plain backward in f32 on the same values, over ``images`` (all by
    default), as _chunk_errors has them for B2."""
    out, lse = vil_mode_attention_fwd(*acts, bias, mask, H, mode, with_lse=True)
    grads = vil_mode_attention_bwd(*acts, bias, g, out, mask, lse, H, mode)
    sel = slice(None) if images is None else images
    a32 = [None if a is None else a[sel].float() for a in acts]
    refs = vil_mode_attention_bwd_reference(*a32, bias, g[sel].float(), mask, H, mode)
    pairs = [(x[sel], r) for x, r in zip(grads[:5], refs[:5]) if r is not None]
    if bias is not None and images is None:  # dbias sums over the images
        pairs.append((grads[5], refs[5]))
    return max(_rel_err(x, r) for x, r in pairs), max(_scaled_err(x, r) for x, r in pairs)


@pytest.mark.parametrize("M", [8, 16, 32, 64, 128])
def test_sampled_neighbour_bf16_backward_every_head_dim(cuda, M):
    """B6 in bf16 on the tensor cores at every head dim over the grids of
    CHUNK_GRIDS without SW_EXACT 1 (it has no mode tables), each at two
    modes (the cyclic 1×2 grid at modes 2 and 5, where the sampled chunk is
    the self chunk): every gradient at chip_smoke.py's tolerances."""
    cases = [(grid, mode) for i, grid in enumerate(CHUNK_GRIDS) if grid[4] != 1
             for mode in ((2, 5) if grid[:2] == (7, 14) else (1 + i % 8, 8 - i % 8))]
    for i, ((nx, ny, w, nglo, exact, with_bias), mode) in enumerate(cases):
        acts, bias, g, mask = _chunk_case(cuda, 300 * M + i, 2, nx, ny, w, M, 2, nglo, exact,
                                          with_bias, mode)
        rel, scaled = _mode_errors(acts, bias, g, mask, 2, mode)
        case = (M, nx, ny, w, nglo, exact, with_bias, mode, rel, scaled)
        assert rel <= CHUNK_GRAD_TOL and scaled <= CHUNK_SCALED_TOL, case
    assert vil_mode_attention_bwd.launches == len(cases)


@pytest.mark.parametrize("mode", range(1, 9))
def test_sampled_neighbour_bf16_backward_at_the_model_shapes(cuda, mode):
    """B6 in bf16 at each mode on ViL-Small 224²'s stage-1 (8×8 chunks,
    C 96, 3 heads) and stage-2 (4×4, C 192) grids, nglo 1, batch 4: every
    gradient, and B5's out, at chip_smoke.py's tolerances. The modes whose
    offsets are not symmetric pair each with its opposite if pass 2 walked
    the offset with the wrong sign."""
    for i, (n, C) in enumerate(((56, 96), (28, 192))):
        acts, _, g, mask = _chunk_case(cuda, 40 * mode + i, 4, n, n, 7, C // 3, 3, 1, 0, False,
                                       mode)
        out = vil_mode_attention_fwd(*acts, None, mask, 3, mode)
        ref = vil_mode_attention_reference(*[None if a is None else a.float() for a in acts],
                                           None, mask, 3, mode)
        assert _scaled_err(out, ref) <= CHUNK_SCALED_TOL, (mode, n)
        rel, scaled = _mode_errors(acts, None, g, mask, 3, mode)
        assert rel <= CHUNK_GRAD_TOL and scaled <= CHUNK_SCALED_TOL, (mode, n, rel, scaled)


def test_sampled_neighbour_bf16_backward_does_not_read_across_images(cuda):
    """Image 1 of 3 filled with 1e4, as for B2: images 0 and 2's gradients
    of B6 must not see it."""
    for M, (nx, ny, w, nglo), mode in ((32, (56, 56, 7, 1), 3), (64, (13, 14, 7, 0), 8),
                                       (64, (14, 15, 4, 2), 6)):
        acts, _, g, mask = _chunk_case(cuda, M + mode, 3, nx, ny, w, M, 3, nglo, 0, False, mode)
        for t in (*acts, g):
            if t is not None:
                t[1] = 1e4
        for image in (0, 2):
            rel, scaled = _mode_errors(acts, None, g, mask, 3, mode, slice(image, image + 1))
            case = (M, nx, w, mode, image, rel, scaled)
            assert rel <= CHUNK_GRAD_TOL and scaled <= CHUNK_SCALED_TOL, case


def test_sampled_neighbour_bf16_backward_is_deterministic(cuda):
    """Two launches of B6 in bf16 on the same inputs give bitwise-equal
    gradients (no atomics), with and without a bias."""
    for nx, ny, w, nglo, with_bias, mode in ((56, 56, 7, 1, False, 4), (19, 25, 7, 2, True, 7),
                                             (13, 14, 7, 0, False, 1)):
        acts, bias, g, mask = _chunk_case(cuda, 14, 2, nx, ny, w, 32, 3, nglo, 0, with_bias,
                                          mode)
        out, lse = vil_mode_attention_fwd(*acts, bias, mask, 3, mode, with_lse=True)
        first = vil_mode_attention_bwd(*acts, bias, g, out, mask, lse, 3, mode)
        second = vil_mode_attention_bwd(*acts, bias, g, out, mask, lse, 3, mode)
        for name, a, b in zip(("dq", "dk", "dv", "dkg", "dvg", "dbias"), first, second):
            assert (a is None) == (b is None) and (a is None or torch.equal(a, b)), (name, nx)


def _mode_fwd_errors(acts, bias, mask, H, mode, images=None):
    """(out, lse, scaled) errors of B5 in bf16 against the plain forward in
    f32 on the same values, over ``images`` (all by default), as
    _fwd_errors has them for B1; the output without the LSE must equal the
    output with it, bit for bit."""
    out, lse = vil_mode_attention_fwd(*acts, bias, mask, H, mode, with_lse=True)
    assert torch.equal(vil_mode_attention_fwd(*acts, bias, mask, H, mode), out)
    sel = slice(None) if images is None else images
    a32 = [None if a is None else a[sel].float() for a in acts]
    ref, ref_lse = vil_mode_attention_reference(*a32, bias, mask, H, mode, with_lse=True)
    return _max_err(out[sel], ref), _max_err(lse[sel], ref_lse), _scaled_err(out[sel], ref)


@pytest.mark.parametrize("M", [8, 16, 32, 64, 128])
def test_sampled_neighbour_bf16_forward_every_head_dim(cuda, M):
    """B5 in bf16 on the tensor cores at every head dim over the grids of
    CHUNK_GRIDS without SW_EXACT 1, each at two modes (the cyclic 1×2 grid
    at modes 2 and 5, where the sampled chunk is the self chunk), with and
    without the LSE: out, LSE and the scaled error at chip_smoke.py's
    tolerances."""
    cases = [(grid, mode) for i, grid in enumerate(CHUNK_GRIDS) if grid[4] != 1
             for mode in ((2, 5) if grid[:2] == (7, 14) else (1 + i % 8, 8 - i % 8))]
    for i, ((nx, ny, w, nglo, exact, with_bias), mode) in enumerate(cases):
        acts, bias, _, mask = _chunk_case(cuda, 500 * M + i, 2, nx, ny, w, M, 2, nglo, exact,
                                          with_bias, mode)
        e_out, e_lse, scaled = _mode_fwd_errors(acts, bias, mask, 2, mode)
        case = (M, nx, ny, w, nglo, exact, with_bias, mode, e_out, e_lse, scaled)
        assert e_out <= CHUNK_OUT_TOL and e_lse <= CHUNK_LSE_TOL, case
        assert scaled <= CHUNK_SCALED_TOL, case
    assert vil_mode_attention_fwd.launches == 2 * len(cases)


@pytest.mark.parametrize("mode", [1, 6])
def test_sampled_neighbour_bf16_forward_at_the_model_shapes(cuda, mode):
    """B5 in bf16 on ViL-Small 224²'s stage-1 (8×8 chunks, C 96, 3 heads)
    and stage-2 (4×4, C 192) grids, nglo 1, batch 4, at two modes whose
    offsets are both non-zero; then on a 3×3 grid at every mode, whose
    offsets a flipped sign would carry to another chunk, and on the cyclic
    1×2 grid at every mode: out, LSE and the scaled error."""
    cases = [(56, 56, 96, mode), (28, 28, 192, mode)]
    cases += [(21, 21, 96, m) for m in range(1, 9)] + [(7, 14, 96, m) for m in range(1, 9)]
    for i, (nx, ny, C, m) in enumerate(cases):
        acts, _, _, mask = _chunk_case(cuda, 60 * mode + i, 4, nx, ny, 7, C // 3, 3, 1, 0,
                                       False, m)
        e_out, e_lse, scaled = _mode_fwd_errors(acts, None, mask, 3, m)
        case = (nx, ny, C, m, e_out, e_lse, scaled)
        assert e_out <= CHUNK_OUT_TOL and e_lse <= CHUNK_LSE_TOL, case
        assert scaled <= CHUNK_SCALED_TOL, case


def test_sampled_neighbour_bf16_forward_does_not_read_across_images(cuda):
    """Image 1 of 3 filled with 1e4, as for B1: images 0 and 2's output and
    LSE of B5 must not see it."""
    for M, (nx, ny, w, nglo), mode in ((32, (56, 56, 7, 1), 3), (64, (13, 14, 7, 0), 8),
                                       (64, (14, 15, 4, 2), 6), (32, (27, 20, 9, 1), 1)):
        acts, _, _, mask = _chunk_case(cuda, M + mode, 3, nx, ny, w, M, 3, nglo, 0, False, mode)
        for t in acts:
            if t is not None:
                t[1] = 1e4
        for image in (0, 2):
            e_out, e_lse, scaled = _mode_fwd_errors(acts, None, mask, 3, mode,
                                                    slice(image, image + 1))
            case = (M, nx, w, mode, image, e_out, e_lse, scaled)
            assert e_out <= CHUNK_OUT_TOL and e_lse <= CHUNK_LSE_TOL, case
            assert scaled <= CHUNK_SCALED_TOL, case


def test_sampled_neighbour_bf16_forward_is_deterministic(cuda):
    """Two launches of B5 in bf16 on the same inputs give bitwise-equal
    outputs and LSEs, with and without a bias."""
    for nx, ny, w, nglo, with_bias, mode in ((56, 56, 7, 1, False, 4), (19, 25, 7, 2, True, 7),
                                             (13, 14, 7, 0, False, 1)):
        acts, bias, _, mask = _chunk_case(cuda, 16, 2, nx, ny, w, 32, 3, nglo, 0, with_bias,
                                          mode)
        first = vil_mode_attention_fwd(*acts, bias, mask, 3, mode, with_lse=True)
        second = vil_mode_attention_fwd(*acts, bias, mask, 3, mode, with_lse=True)
        for name, a, b in zip(("out", "lse"), first, second):
            assert torch.equal(a, b), (name, nx, mode)


BLOCK_GRADS = ("dx", "dWq", "dbq", "dWk", "dbk", "dWv", "dbv", "dWo", "dbo", "dk_glo",
               "dv_glo", "dbias")


def _block_bf16_case(cuda, seed, B, nx, ny, C, H, nglo, with_bias, bias_scale=0.02):
    """bf16 operands of the fused block (weights scale-folded as the model
    passes them, f32 biases of ``bias_scale``, bq folded too), g and the
    additive mask, on a grid of 7×7 chunks."""
    gen = torch.Generator(device=cuda).manual_seed(seed)
    rnd = lambda *s, scale=1.0: torch.randn(*s, generator=gen, device=cuda) * scale
    padx, pady, mx, my = sc.chunk_grid(nx, ny, 7)
    M = C // H
    x = rnd(B, mx, my, 49, C).to(torch.bfloat16)
    ws = [rnd(C, C, scale=C ** -0.5 * (M ** -0.5 if i == 0 else 1.0)).to(torch.bfloat16)
          for i in range(4)]
    bs = [rnd(C, scale=bias_scale * (M ** -0.5 if i == 0 else 1.0)) for i in range(4)]
    glo = [rnd(B, nglo, C).to(torch.bfloat16) if nglo else None for _ in range(2)]
    bias = rnd(H, 49, nglo + 9 * 49, scale=0.5) if with_bias else None
    mask = torch.from_numpy(mask_to_additive(
        masks.invalid_mask(mx, my, padx, pady, 7, 0, 0), mx, my, 49, nglo)).to(cuda)
    ops = [x, ws[0], bs[0], ws[1], bs[1], ws[2], bs[2], ws[3], bs[3], *glo, bias]
    return ops, rnd(B, mx, my, 49, C).to(torch.bfloat16), mask


def _block_bf16_errors(ops, g, mask, H):
    """B9b in bf16 from B9a's saved tensors against the plain backward in f32
    on the same values: {gradient: max|err| / max|ref|}, with no floor (dbk,
    whose exact value is 0, at dWk's scale), and the gradients."""
    _, k, v, lse, q, attn = vil_block_fwd(*ops, mask, H, with_lse=True, saved=True)
    grads = vil_block_bwd(*ops, g, mask, lse, H, (q, k, v, attn))
    refs = vil_block_bwd_reference(*[None if t is None else t.float() for t in ops], g.float(),
                                   mask, H)
    errs = {n: _max_err(a, r) / refs[3 if i == 4 else i].abs().max().item()
            for i, (n, a, r) in enumerate(zip(BLOCK_GRADS, grads, refs)) if r is not None}
    return errs, grads


@pytest.mark.parametrize("nx,C", [(56, 96), (28, 192)])
def test_fused_block_bf16_backward_at_the_model_shapes(cuda, nx, C):
    """B9b in bf16 (its products and attention on the tensor cores) on
    ViL-Small 224²'s stage-1 (8×8 chunks, C 96, 3 heads) and stage-2 (4×4,
    C 192) grids, nglo 1, batch 4: every gradient to chip_smoke.py's
    CHUNK_SCALED_TOL with no floor."""
    ops, g, mask = _block_bf16_case(cuda, nx, 4, nx, nx, C, 3, 1, False)
    errs, _ = _block_bf16_errors(ops, g, mask, 3)
    assert max(errs.values()) <= CHUNK_SCALED_TOL, errs


def test_fused_block_bf16_backward_biased_padded_without_globals(cuda):
    """B9b in bf16 on a biased, padded 3×3 grid with no global rows, at C 48
    (one 64-column sub-tile, 16 of it zero fill) and C 320 (two blocks along
    the output columns): every gradient, dbias too, to CHUNK_SCALED_TOL."""
    for C, H in ((48, 3), (320, 5)):
        ops, g, mask = _block_bf16_case(cuda, C, 2, 19, 20, C, H, 0, True)
        errs, _ = _block_bf16_errors(ops, g, mask, H)
        assert "dbias" in errs and max(errs.values()) <= CHUNK_SCALED_TOL, (C, errs)


def test_fused_block_bf16_backward_is_deterministic(cuda):
    """Two launches of B9b in bf16 on the same inputs give bitwise-equal
    gradients (the weight gradients' slices summed in order, no atomics)."""
    for nx, C, H, nglo, with_bias in ((56, 96, 3, 1, False), (19, 64, 2, 2, True)):
        ops, g, mask = _block_bf16_case(cuda, 3, 2, nx, nx, C, H, nglo, with_bias)
        _, k, v, lse, q, attn = vil_block_fwd(*ops, mask, H, with_lse=True, saved=True)
        first = vil_block_bwd(*ops, g, mask, lse, H, (q, k, v, attn))
        second = vil_block_bwd(*ops, g, mask, lse, H, (q, k, v, attn))
        for name, a, b in zip(BLOCK_GRADS, first, second):
            assert (a is None) == (b is None) and (a is None or torch.equal(a, b)), (name, nx)


BLOCK_FWD_OUTS = ("y", "q", "k", "v", "attn", "lse")


def _block_fwd_errors(ops, mask, H, images=None):
    """B9a in bf16 (products and attention on the tensor cores) against the
    plain forward in f32 on the same values, over ``images`` (all by
    default): ({output: max|err| / max|ref|, with no floor} of y, q, k, v,
    attn and lse, the LSE of the plain attention over the kernel's own q and
    k, absolute). The forward without the LSE (serving) must give the same
    y, k and v bit for bit."""
    y, k, v, lse, q, attn = vil_block_fwd(*ops, mask, H, with_lse=True, saved=True)
    served = vil_block_fwd(*ops, mask, H)
    assert all(torch.equal(a, b) for a, b in zip(served, (y, k, v)))
    sel = slice(None) if images is None else images
    # x, k_glo and v_glo (operands 0, 9, 10) hold one row block per image
    ops32 = [None if t is None else (t[sel] if i in (0, 9, 10) else t).float()
             for i, t in enumerate(ops)]
    refs = vil_block_fwd_reference(*ops32, mask, H, with_lse=True)
    outs = (y, q, k, v, attn, lse)
    errs = {n: _scaled_err(a[sel], r) for n, a, r in zip(BLOCK_FWD_OUTS, outs, refs)}
    own_lse = vil_attention_reference(q[sel].float(), k[sel].float(), v[sel].float(),
                                      *ops32[9:12], mask, H, with_lse=True)[1]
    return errs, _max_err(lse[sel], own_lse)


# the grids of the bf16 fused-block cases, (B, nx, ny, nglo, with_bias): a
# cyclic 2×2 grid whose 588 rows end in a ragged 64-row tile, a biased,
# padded 3×3 grid without global rows, a cyclic 3×3 grid with nglo 2 and a
# biased, padded cyclic 2×2 grid with nglo 1
BLOCK_GRIDS = [(3, 14, 14, 1, False), (2, 19, 20, 0, True), (2, 21, 21, 2, False),
               (1, 13, 14, 1, True)]


@pytest.mark.parametrize("C,H", [(48, 3), (64, 2), (96, 3), (128, 1), (192, 3), (320, 5)])
def test_fused_block_bf16_forward_every_width(cuda, C, H):
    """B9a in bf16 at C 48-320 (1-5 64-column sub-tiles of its products,
    C 320 in two blocks along the columns) and head dims 16-128, on every
    grid of BLOCK_GRIDS: y, q, k, v, attn and lse to chip_smoke.py's
    CHUNK_SCALED_TOL with no floor, the LSE over its own q and k to
    CHUNK_LSE_TOL, serving bit for bit."""
    for i, (B, nx, ny, nglo, with_bias) in enumerate(BLOCK_GRIDS):
        ops, _, mask = _block_bf16_case(cuda, 10 * C + i, B, nx, ny, C, H, nglo, with_bias)
        errs, e_lse = _block_fwd_errors(ops, mask, H)
        case = (C, H, B, nx, ny, nglo, with_bias, errs, e_lse)
        assert max(errs.values()) <= CHUNK_SCALED_TOL and e_lse <= CHUNK_LSE_TOL, case
    assert vil_block_fwd.launches == 2 * len(BLOCK_GRIDS)


@pytest.mark.parametrize("nx,C", [(56, 96), (28, 192)])
def test_fused_block_bf16_forward_at_the_model_shapes(cuda, nx, C):
    """B9a in bf16 on ViL-Small 224²'s stage-1 and stage-2 grids, nglo 1,
    batch 4, with the q, k and v biases as large as the products (a bias
    dropped or added twice moves q, k and v by their own size; at the
    model's small biases it would hide under the limit)."""
    ops, _, mask = _block_bf16_case(cuda, nx + 1, 4, nx, nx, C, 3, 1, False, bias_scale=1.0)
    errs, e_lse = _block_fwd_errors(ops, mask, 3)
    assert max(errs.values()) <= CHUNK_SCALED_TOL and e_lse <= CHUNK_LSE_TOL, (errs, e_lse)


def test_fused_block_bf16_forward_does_not_read_across_images(cuda):
    """Image 1 of 3 filled with 1e2: a staged row of x, q, k, v or attn that
    read another image's rows would show in images 0 and 2's outputs."""
    for nx, C, H, nglo in ((14, 96, 3, 1), (21, 64, 2, 0)):
        ops, _, mask = _block_bf16_case(cuda, C, 3, nx, nx, C, H, nglo, False)
        ops[0][1] = 1e2
        for image in (0, 2):
            errs, e_lse = _block_fwd_errors(ops, mask, H, slice(image, image + 1))
            case = (nx, C, image, errs, e_lse)
            assert max(errs.values()) <= CHUNK_SCALED_TOL and e_lse <= CHUNK_LSE_TOL, case


def test_fused_block_bf16_operands_off_16_bytes_raise(cuda):
    """The bf16 kernels copy rows 16 bytes at a time: x or a weight that
    starts off a 16-byte boundary raises ValueError, forward and backward."""
    ops, g, mask = _block_bf16_case(cuda, 1, 1, 14, 14, 64, 2, 1, False)
    for i in (0, 1, 7):
        off = torch.empty(ops[i].numel() + 1, dtype=ops[i].dtype, device=cuda)[1:]
        moved = list(ops)
        moved[i] = off.view(ops[i].shape).copy_(ops[i])
        with pytest.raises(ValueError, match="16-byte"):
            vil_block_fwd(*moved, mask, 2)
    assert vil_block_fwd.launches == 0


LN_STEP_SHAPES = [(200704, 96), (64, 96), (50176, 192), (64, 192), (12608, 384), (3136, 768)]


@pytest.mark.parametrize("dtype,grad_tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
def test_layer_norm_backward_at_the_step_shapes_is_deterministic(cuda, dtype, grad_tol):
    """B8b at the six row shapes of ViL-Small's fused training step and at C
    100 and 1000 (no 16-byte vectors: C % 8 != 0 in bf16) at 1 and 3000
    rows: dx, dγ and dβ against the plain version in f32 on the same values,
    relative to max(1, max|ref|), and a second launch bit for bit (the
    partials summed in a fixed order, no atomics)."""
    rng = np.random.default_rng(11)
    rnd = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(cuda)
    cases = LN_STEP_SHAPES + [(1, 100), (3000, 100), (1, 1000), (3000, 1000)]
    for rows, C in cases:
        x, dy = (rnd(rows, C) * 2 + 0.5).to(dtype), rnd(rows, C).to(dtype)
        gamma = rnd(C) * 0.2 + 1
        grads = layer_norm_bwd(x, gamma, dy)
        again = layer_norm_bwd(x, gamma, dy)
        refs = layer_norm_bwd_reference(x.float(), gamma, dy.float())
        for name, out, r, o2 in zip(("dx", "dgamma", "dbeta"), grads, refs, again):
            assert _rel_err(out, r) <= grad_tol, (name, rows, C, _rel_err(out, r))
            assert torch.equal(out, o2), (name, rows, C)
    assert layer_norm_bwd.launches == 2 * len(cases)


def test_halo_bf16_backward_folds_onto_b2(cuda):
    """B7b in bf16 on every shard of ViL-Small's stage-1 grid split over 1,
    2 and 4 ranks (8, 4 and 2 chunk rows a shard) and of a biased padded
    grid split over 3: dQ of the shards and their dK/dV folded onto the
    rows' owners against B2's on the whole grid, and each shard against the
    plain version, at B2's tolerances."""
    for nx, ny, nglo, with_bias, splits in ((56, 56, 1, False, (1, 2, 4)),
                                            (19, 20, 2, True, (3,))):
        acts, bias, g, mask = _chunk_case(cuda, 13, 2, nx, ny, 7, 32, 3, nglo, 0, with_bias)
        q, k, v, kg, vg = acts
        out, lse = vil_attention_fwd(*acts, bias, mask, 3, with_lse=True)
        whole = vil_attention_bwd(*acts, bias, g, out, mask, lse, 3)
        mx = q.shape[1]
        for D in splits:
            mxs = mx // D
            dq, dk, dv = (torch.zeros(t.shape, device=cuda) for t in (q, k, v))
            for sh in range(D):
                sl = slice(sh * mxs, (sh + 1) * mxs)
                (k_ext, rows), (v_ext, _) = _halo_shard(k, sh, mxs), _halo_shard(v, sh, mxs)
                ops = [q[:, sl].contiguous(), k_ext, v_ext, kg, vg, bias]
                gs = g[:, sl].contiguous()
                o, l = vil_attention_halo_fwd(*ops, mask[sl], 3, with_lse=True)
                grads = vil_attention_halo_bwd(*ops, gs, o, mask[sl], l, 3)
                refs = vil_attention_halo_bwd_reference(
                    *[None if t is None else t.float() for t in ops], gs.float(), mask[sl], 3)
                for name, x, r in zip(("dq", "dk_ext", "dv_ext", "dkg", "dvg", "dbias"),
                                      grads, refs):
                    if r is not None:
                        assert _rel_err(x, r) <= CHUNK_GRAD_TOL, (name, nx, D, sh)
                        assert _scaled_err(x, r) <= CHUNK_SCALED_TOL, (name, nx, D, sh)
                dq[:, sl] = grads[0].float()
                for e, row in enumerate(rows):
                    dk[:, row] += grads[1][:, e].float()
                    dv[:, row] += grads[2][:, e].float()
            for name, x, r in (("dq", dq, whole[0]), ("dk", dk, whole[1]), ("dv", dv, whole[2])):
                assert _scaled_err(x, r.float()) <= CHUNK_SCALED_TOL, (name, nx, D)


@pytest.mark.parametrize("dtype,tol,grad_tol", [(torch.float32, 1e-4, 1e-4),
                                                (torch.bfloat16, 2e-2, 3e-2)])
def test_sampled_neighbour_kernels_match_plain_versions(cuda, dtype, tol, grad_tol):
    """B5 and B6 at every mode on a padded 3×4 grid with bias and nglo 2,
    and on cyclic 1×2 (the sampled chunk is the self chunk for some modes)
    and 2×2 grids with SW_EXACT -1: out, LSE and every gradient."""
    rng = np.random.default_rng(7)
    rnd = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(cuda)
    cases = [(19, 25, 0, 2, True, m) for m in range(1, 9)]
    cases += [(7, 14, -1, 1, False, m) for m in (2, 5)] + [(13, 14, -1, 0, True, 8)]
    for nx, ny, exact, nglo, with_bias, mode in cases:
        w, w2 = 7, 49
        padx, pady, mx, my = sc.chunk_grid(nx, ny, w)
        acts = [rnd(2, mx, my, w2, 64) * 0.5 for _ in range(3)]
        acts += [rnd(2, nglo, 64) if nglo else None for _ in range(2)]
        acts = [None if a is None else a.to(dtype) for a in acts]
        a32 = [None if a is None else a.float() for a in acts]
        bias = rnd(2, w2, nglo + 2 * w2) if with_bias else None
        mask = torch.from_numpy(mask_to_additive(
            masks.invalid_mask(mx, my, padx, pady, w, exact, mode), mx, my, w2, nglo)).to(cuda)
        g = rnd(2, mx, my, w2, 64).to(dtype)
        out, lse = vil_mode_attention_fwd(*acts, bias, mask, 2, mode, with_lse=True)
        ref, lse_ref = vil_mode_attention_reference(*a32, bias, mask, 2, mode, with_lse=True)
        assert out.dtype == dtype and _max_err(out, ref) <= tol, (mx, my, mode)
        assert _max_err(lse, lse_ref) <= tol, (mx, my, mode)
        grads = vil_mode_attention_bwd(*acts, bias, g, out, mask, lse, 2, mode)
        refs = vil_mode_attention_bwd_reference(*a32, bias, g.float(), mask, 2, mode)
        for name, o, r in zip(("dq", "dk", "dv", "dkg", "dvg", "dbias"), grads, refs):
            assert (o is None) == (r is None), name
            if r is not None:
                assert _rel_err(o, r) <= grad_tol, (name, mx, my, mode, _rel_err(o, r))
    assert [fn.launches for fn in KERNELS] == [0] * 4 + [len(cases)] * 2 + [0] * 6


def test_model_runs_through_the_kernels(cuda):
    """A narrow 4-stage 224² model: 3 sliding-chunk and 3 dense launches per
    forward, and f32 logits equal to the plain path's within 1e-3."""
    arch = ("l1,h2,d64,n1,s1,g1,p4,f7_l2,h2,d64,n2,s1,g1,p2,f7_"
            "l3,h2,d128,n2,s0,g1,p2,f7_l4,h2,d128,n1,s0,g0,p2,f7")
    x = torch.randint(0, 256, (4, 224, 224, 3), dtype=torch.uint8, device=cuda)
    logits = {}
    with torch.inference_mode():
        for use_kernels in (True, False):
            model = MsViT(arch, img_size=224, num_classes=10, sharew=True,
                          norm_embed=True, device=cuda, use_kernels=use_kernels,
                          generator=torch.Generator().manual_seed(0)).eval()
            logits[use_kernels] = model(x)
    assert [fn.launches for fn in KERNELS] == [3, 3] + [0] * 10
    assert torch.isfinite(logits[True]).all()
    assert _max_err(logits[True], logits[False]) <= 1e-3
    # with a gradient to take, the autograd Function runs both kernels
    q = torch.randn(1, 9, 64, device=cuda, requires_grad=True)
    full_attention(q, q, q, None, 1).sum().backward()
    assert torch.isfinite(q.grad).all()
    assert [fn.launches for fn in KERNELS] == [3, 4, 0, 1] + [0] * 8


def test_train_step_runs_through_the_kernels(cuda):
    """One training step of a narrow 4-stage 224² model (drop path, mixup,
    AdamW) in f32: 3 launches of each kernel per step, and the loss and
    every parameter gradient equal to the plain path's from the same
    weights, images and generator seed."""
    from vil_tpu_torch.data.mixup import make_mixup_fn
    from vil_tpu_torch.train import engine, loss, optim

    arch = ("l1,h2,d64,n1,s1,g1,p4,f7_l2,h2,d64,n2,s1,g1,p2,f7_"
            "l3,h2,d128,n2,s0,g1,p2,f7_l4,h2,d128,n1,s0,g0,p2,f7")
    x = torch.randn(4, 224, 224, 3, device=cuda)
    y = torch.randint(0, 10, (4,), device=cuda)
    results = {}
    for use_kernels in (True, False):
        model = MsViT(arch, img_size=224, num_classes=10, sharew=True, norm_embed=True,
                      drop_path_rate=0.1, device=cuda, use_kernels=use_kernels,
                      generator=torch.Generator().manual_seed(0))
        opt = torch.optim.AdamW(optim.param_groups(model, 0.05, 0.0, decoupled=True))
        step = engine.make_train_step(model, loss.soft_target_cross_entropy, opt,
                                      mixup_fn=make_mixup_fn(num_classes=10), device=cuda)
        metrics = step(x, y, torch.Generator(device=cuda).manual_seed(1))
        results[use_kernels] = (metrics["loss"].item(),
                                {n: p.grad for n, p in model.named_parameters()})
    assert [fn.launches for fn in KERNELS] == [3, 3, 3, 3] + [0] * 8
    (loss_k, grads_k), (loss_p, grads_p) = results[True], results[False]
    assert abs(loss_k - loss_p) <= 1e-4
    for name, ref in grads_p.items():
        if ref.numel():
            assert _max_err(grads_k[name], ref) <= 1e-3 * ref.abs().max().item(), name


@pytest.mark.parametrize("dtype,tol,grad_tol", [(torch.float32, 1e-4, 1e-4),
                                                (torch.bfloat16, 2e-2, 2e-2)])
def test_layer_norm_kernels_match_plain_versions(cuda, dtype, tol, grad_tol):
    """B8a and B8b at ViL-Small's widths and ragged ones (C = 48 .. 1000,
    1 .. 3000 rows): y, dx, dγ and dβ against the plain versions in f32 on
    the same values; dγ and dβ relative to max(1, max|ref|)."""
    rng = np.random.default_rng(8)
    rnd = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(cuda)
    cases = [(1, 96), (7, 48), (64, 192), (3000, 384), (129, 768), (33, 1000)]
    for rows, C in cases:
        x, dy = (rnd(rows, C) * 2 + 0.5).to(dtype), rnd(rows, C).to(dtype)
        gamma, beta = rnd(C) * 0.2 + 1, rnd(C) * 0.1
        y = layer_norm_fwd(x, gamma, beta)
        ref = layer_norm_reference(x.float(), gamma, beta)
        assert y.dtype == dtype and _max_err(y, ref) <= tol, (rows, C, _max_err(y, ref))
        grads = layer_norm_bwd(x, gamma, dy)
        refs = layer_norm_bwd_reference(x.float(), gamma, dy.float())
        for name, out, r in zip(("dx", "dgamma", "dbeta"), grads, refs):
            assert _rel_err(out, r) <= grad_tol, (name, rows, C, _rel_err(out, r))
    assert [fn.launches for fn in KERNELS] == [0] * 6 + [len(cases)] * 2 + [0] * 4


@pytest.mark.parametrize("dtype,tol,grad_tol", [(torch.float32, 1e-4, 1e-4),
                                                (torch.bfloat16, 3e-2, 3e-2)])
def test_fused_block_kernels_match_plain_versions(cuda, dtype, tol, grad_tol):
    """B9a and B9b on a padded 2×3 grid with nglo 1, a cyclic 2×2 grid with
    a bias and no global rows, and a 1×2 grid with nglo 2 and no qkv bias:
    y, k, v, lse and every gradient against the plain versions in f32 on the
    same values (the weights in x's type), gradients relative to
    max(1, max|ref|)."""
    rng = np.random.default_rng(9)
    rnd = lambda *s, scale=1.0: torch.from_numpy(
        (rng.standard_normal(s) * scale).astype(np.float32)).to(cuda)
    cases = [(13, 20, 1, False, True, 96, 3), (13, 14, 0, True, True, 64, 2),
             (7, 14, 2, False, False, 128, 4)]
    for nx, ny, nglo, with_bias, qkv_bias, C, H in cases:
        w, w2 = 7, 49
        padx, pady, mx, my = sc.chunk_grid(nx, ny, w)
        x = rnd(2, mx, my, w2, C).to(dtype)
        # wq scale-folded (·M^-½), as the model passes it
        ws = [rnd(C, C, scale=C ** -0.5 * ((C // H) ** -0.5 if i == 0 else 1.0)).to(dtype)
              for i in range(4)]
        bs = [rnd(C, scale=0.1) if qkv_bias or i == 3 else None for i in range(4)]
        glo = [rnd(2, nglo, C).to(dtype) if nglo else None for _ in range(2)]
        bias = rnd(H, w2, nglo + 9 * w2, scale=0.5) if with_bias else None
        mask = torch.from_numpy(mask_to_additive(
            masks.invalid_mask(mx, my, padx, pady, w, 0, 0), mx, my, w2, nglo)).to(cuda)
        ops = [x, ws[0], bs[0], ws[1], bs[1], ws[2], bs[2], ws[3], bs[3], *glo, bias]
        ops32 = [None if t is None else t.float() for t in ops]
        y, k, v, lse, q, attn = vil_block_fwd(*ops, mask, H, with_lse=True, saved=True)
        ry, rk, rv = vil_block_reference(*ops32, mask, H)
        # the LSE of the plain attention over the kernel's own q and k
        rlse = vil_attention_reference(q.float(), k.float(), v.float(), *ops32[9:11], bias,
                                       mask, H, with_lse=True)[1]
        for name, out, ref in (("y", y, ry), ("k", k, rk), ("v", v, rv), ("lse", lse, rlse)):
            assert out.dtype == (torch.float32 if name == "lse" else dtype), name
            assert _max_err(out, ref) <= tol, (name, mx, my, _max_err(out, ref))
        g = rnd(*x.shape).to(dtype)
        grads = vil_block_bwd(*ops, g, mask, lse, H, (q, k, v, attn))
        refs = vil_block_bwd_reference(*ops32, g.float(), mask, H)
        for i, (out, ref) in enumerate(zip(grads, refs)):
            assert (out is None) == (ref is None), i
            if ref is None:
                continue
            # dbk's exact value is 0 (a shift common to a query's scores leaves
            # its softmax alone): what comes out is the rounding of a sum over
            # the rows of terms of dWk's size, so it is held at dWk's scale
            scale = refs[3] if i == 4 else ref
            err = (out.float() - ref).abs().max().item() / max(1.0, scale.abs().max().item())
            assert err <= grad_tol, (i, mx, my, err)
    assert [fn.launches for fn in KERNELS] == [0] * 8 + [len(cases)] * 2 + [0] * 2


def test_fused_configuration_runs_through_the_kernels(cuda):
    """A narrow 4-stage 224² model with the fused LayerNorm and the fused
    block: per forward 3 fused-block launches, 2 × 2 × 3 + 2 × 3 LayerNorm
    launches (chunked stages: global rows and image) and 3 dense ones, no
    sliding-chunk launch; f32 logits and a training step's loss and
    gradients equal to the classic plain path's from the same weights."""
    arch = ("l1,h2,d64,n1,s1,g1,p4,f7_l2,h2,d64,n2,s1,g1,p2,f7_"
            "l3,h2,d128,n2,s0,g1,p2,f7_l4,h2,d128,n1,s0,g0,p2,f7")
    x = torch.randn(4, 224, 224, 3, device=cuda)
    y = torch.randint(0, 10, (4,), device=cuda)
    results = {}
    for fused in (True, False):
        model = MsViT(arch, img_size=224, num_classes=10, sharew=True, norm_embed=True,
                      device=cuda, use_kernels=fused, fused_ln=fused, fused_block=fused,
                      generator=torch.Generator().manual_seed(0))
        with torch.inference_mode():
            logits = model.eval()(x)
        if fused:
            assert [fn.launches for fn in KERNELS] == [0, 3, 0, 0, 0, 0, 18, 0, 3, 0, 0, 0]
        out = torch.nn.functional.cross_entropy(model.train()(x).float(), y)
        out.backward()
        results[fused] = (logits, out.item(), {n: p.grad for n, p in model.named_parameters()})
    assert [fn.launches for fn in KERNELS] == [0, 6, 0, 3, 0, 0, 36, 18, 6, 3, 0, 0]
    (l_k, loss_k, g_k), (l_p, loss_p, g_p) = results[True], results[False]
    assert torch.isfinite(l_k).all() and _max_err(l_k, l_p.float()) <= 1e-3
    assert abs(loss_k - loss_p) <= 1e-4
    for name, ref in g_p.items():
        if ref.numel():
            assert _max_err(g_k[name], ref) <= 1e-3 * ref.abs().max().item(), name


def _halo_shard(t, s, mxs):
    """Shard s of mxs chunk rows of the whole (B, mx, ...) tensor between its
    cyclic halo rows: (B, mxs + 2, ...)."""
    mx = t.shape[1]
    rows = [(s * mxs - 1) % mx, *range(s * mxs, (s + 1) * mxs), ((s + 1) * mxs) % mx]
    return t[:, rows].contiguous(), rows


@pytest.mark.parametrize("dtype,tol,grad_tol", [(torch.float32, 1e-4, 1e-4),
                                                (torch.bfloat16, 2e-2, 3e-2)])
def test_halo_kernels_match_plain_versions(cuda, dtype, tol, grad_tol):
    """B7a and B7b on every shard of splits into 1, 2 and 4 chunk rows of an
    8-row grid (nglo 1), of a padded 4-row grid with a bias, SW_EXACT 1 and
    nglo 2, and of a cyclic 2x2 grid with nglo 0 (the column neighbours
    repeat): out, LSE and every gradient against the plain versions in f32
    on the same values. The shards' outputs together are B1's on the whole
    grid, and their dK/dV folded onto the rows' owners B2's."""
    rng = np.random.default_rng(10)
    rnd = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(cuda)
    cases = [(56, 21, 0, 1, False, mxs) for mxs in (1, 2, 4)]
    cases += [(26, 20, 1, 2, True, 2), (13, 14, 0, 0, False, 1)]
    launches = 0
    for nx, ny, exact, nglo, with_bias, mxs in cases:
        w, w2 = 7, 49
        padx, pady, mx, my = sc.chunk_grid(nx, ny, w)
        acts = [rnd(2, mx, my, w2, 64) * 0.5 for _ in range(3)]
        acts += [rnd(2, nglo, 64) if nglo else None for _ in range(2)]
        acts = [None if a is None else a.to(dtype) for a in acts]
        q, k, v, kg, vg = acts
        bias = rnd(2, w2, nglo + 9 * w2) if with_bias else None
        mask = torch.from_numpy(mask_to_additive(
            masks.invalid_mask(mx, my, padx, pady, w, exact, 0), mx, my, w2, nglo)).to(cuda)
        g = rnd(2, mx, my, w2, 64).to(dtype)
        f32 = lambda ts: [None if t is None else t.float() for t in ts]
        outs = []
        dk, dv = (torch.zeros(t.shape, device=cuda) for t in (k, v))
        for sh in range(mx // mxs):
            sl = slice(sh * mxs, (sh + 1) * mxs)
            (k_ext, rows), (v_ext, _) = _halo_shard(k, sh, mxs), _halo_shard(v, sh, mxs)
            ops = [q[:, sl].contiguous(), k_ext, v_ext, kg, vg, bias]
            out, lse = vil_attention_halo_fwd(*ops, mask[sl], 2, with_lse=True)
            ref, lse_ref = vil_attention_halo_reference(*f32(ops), mask[sl], 2, with_lse=True)
            assert out.dtype == dtype and _max_err(out, ref) <= tol, (nx, mxs, sh)
            assert _max_err(lse, lse_ref) <= tol, (nx, mxs, sh)
            gs = g[:, sl].contiguous()
            grads = vil_attention_halo_bwd(*ops, gs, out, mask[sl], lse, 2)
            refs = vil_attention_halo_bwd_reference(*f32(ops), gs.float(), mask[sl], 2)
            for name, o, r in zip(("dq", "dk_ext", "dv_ext", "dkg", "dvg", "dbias"), grads, refs):
                assert (o is None) == (r is None), name
                if r is not None:
                    assert _rel_err(o, r) <= grad_tol, (name, nx, mxs, sh, _rel_err(o, r))
            outs.append(out.float())
            for e, row in enumerate(rows):
                dk[:, row] += grads[1][:, e].float()
                dv[:, row] += grads[2][:, e].float()
            launches += 1
        whole = vil_attention_reference(*f32(acts), bias, mask, 2)
        assert _max_err(torch.cat(outs, 1), whole) <= tol
        whole_grads = vil_attention_bwd_reference(*f32(acts), bias, g.float(), mask, 2)
        assert _rel_err(dk, whole_grads[1]) <= grad_tol
        assert _rel_err(dv, whole_grads[2]) <= grad_tol
    assert [fn.launches for fn in KERNELS] == [0] * 10 + [launches] * 2


@pytest.mark.parametrize("nx,ny,w,nglo,exact,with_bias",
                         [(26, 20, 7, 0, 1, True), (14, 15, 4, 1, -1, False)],
                         ids=["SW_EXACT 1, nglo 0, biased", "SW_EXACT -1, W 4"])
def test_halo_bf16_forward_per_pixel_masks_and_ragged_tiles(cuda, nx, ny, w, nglo, exact,
                                                            with_bias):
    """B7a in bf16 (the tensor-core kernel) where the mask is read per
    element (SW_EXACT 1: one mask row per query pixel) and, at W 4 with
    SW_EXACT -1, where W² = 16 leaves the last 64-key tile ragged (145
    columns), on every shard of the grid
    split over 1 and 2 ranks: out, LSE and max|err| / max|ref| of out
    against the plain version in f32 at chip_smoke.py's limits, and the
    shards' outputs together against B1 on the whole grid. A bf16 operand
    that starts off a 16-byte boundary raises."""
    acts, bias, _, mask = _chunk_case(cuda, 17, 2, nx, ny, w, 32, 2, nglo, exact, with_bias)
    assert mask.shape[2] == (w * w if exact == 1 else 1)  # Wq
    q, k, v, kg, vg = acts
    whole = vil_attention_fwd(*acts, bias, mask, 2)
    mx = q.shape[1]
    f32 = lambda ts: [None if t is None else t.float() for t in ts]
    for D in (1, 2):
        mxs, outs = mx // D, []
        for sh in range(D):
            sl = slice(sh * mxs, (sh + 1) * mxs)
            (k_ext, _), (v_ext, _) = _halo_shard(k, sh, mxs), _halo_shard(v, sh, mxs)
            ops = [q[:, sl].contiguous(), k_ext, v_ext, kg, vg, bias]
            out, lse = vil_attention_halo_fwd(*ops, mask[sl], 2, with_lse=True)
            ref, lse_ref = vil_attention_halo_reference(*f32(ops), mask[sl], 2, with_lse=True)
            assert out.dtype == torch.bfloat16
            assert _max_err(out, ref) <= CHUNK_OUT_TOL, (D, sh)
            assert _scaled_err(out, ref) <= CHUNK_SCALED_TOL, (D, sh)
            assert _max_err(lse, lse_ref) <= CHUNK_LSE_TOL, (D, sh)
            outs.append(out)
        assert _max_err(torch.cat(outs, 1), whole.float()) <= CHUNK_OUT_TOL, D
    buf = torch.empty(q.numel() + 1, dtype=q.dtype, device=cuda)
    q_off = buf[1:].view(q.shape)  # contiguous, 2 bytes past a 16-byte boundary
    q_off.copy_(q)
    k_ext, v_ext = _halo_shard(k, 0, mx)[0], _halo_shard(v, 0, mx)[0]
    with pytest.raises(ValueError, match="16-byte"):
        vil_attention_halo_fwd(q_off, k_ext, v_ext, kg, vg, bias, mask, 2)


def test_spatial_forward_runs_through_the_halo_kernels(cuda):
    """The spatial forward of a narrow 4-stage 224² model on one rank (no
    process group): per forward 3 halo launches, 3 dense ones and no B1;
    f32 logits equal to the classic forward's within 1e-3; one backward
    through the halo pair."""
    from vil_tpu_torch import parallel

    arch = ("l1,h2,d64,n1,s1,g1,p4,f7_l2,h2,d64,n2,s1,g1,p2,f7_"
            "l3,h2,d128,n2,s0,g1,p2,f7_l4,h2,d128,n1,s0,g0,p2,f7")
    x = torch.randint(0, 256, (4, 224, 224, 3), dtype=torch.uint8, device=cuda)
    model = MsViT(arch, img_size=224, num_classes=10, sharew=True, norm_embed=True,
                  device=cuda, generator=torch.Generator().manual_seed(0)).eval()
    with torch.inference_mode():
        spatial = parallel.spatial_forward(model, x)
        assert [fn.launches for fn in KERNELS] == [0, 3] + [0] * 8 + [3, 0]
        classic = model(x)
    assert torch.isfinite(spatial).all() and _max_err(spatial, classic.float()) <= 1e-3
    q, k, v = (torch.randn(2, 4, 3, 49, 64, device=cuda, requires_grad=True) for _ in range(3))
    mask = torch.zeros(4, 3, 1, 9 * 49, device=cuda)
    parallel.spatial_local_attention_kernel(q, k, v, None, None, None, mask, 2).sum().backward()
    assert all(torch.isfinite(t.grad).all() for t in (q, k, v))
    assert [fn.launches for fn in KERNELS][10:] == [4, 1]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_layout_probe_kernel_doubles_in_place_of_any_layout(cuda, dtype):
    """P through both entry points, on the base layout and on its permuted
    view (read through the strides, no copy): exactly 2x, in the input's
    strides."""
    from vil_tpu_torch.tools import layout_probe

    for fn in layout_probe.KERNELS:
        fn.launches = 0
    x = torch.randn(4, 2, 3, 5, 8, device=cuda).to(dtype)
    y = layout_probe.consume_base(x)
    assert y.stride() == x.stride() and torch.equal(y, x * 2)
    xt = x.permute(1, 2, 3, 0, 4)
    yt = layout_probe.consume_perm(xt)
    assert yt.stride() == xt.stride() and torch.equal(yt, xt * 2)
    assert torch.equal(layout_probe.scheme_b(x), layout_probe.scheme_a(x))
    assert [fn.launches for fn in layout_probe.KERNELS] == [2, 2]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_layout_probe_kernel_head_tail_and_strided_paths(cuda, dtype):
    """P's flat path on a ragged shape (no whole number of vectors: the
    scalar tail) and on views that start 1 to 7 elements into their storage
    (the scalar head, output at the same offset mod 16), and its strided
    path on a slice and a stride-0 expand: exactly 2x on each."""
    from vil_tpu_torch.tools import layout_probe

    flat = torch.randn(3 * 2 * 2 * 7 * 5 + 8, device=cuda).to(dtype)
    for lead in range(8):
        x = flat[lead:lead + 420].view(3, 2, 2, 7, 5)
        assert layout_probe.probe_path(x.shape, x.stride()) == layout_probe.DENSE
        assert torch.equal(layout_probe.consume_base(x), x * 2), lead
        xt = x.permute(1, 2, 3, 0, 4)
        assert torch.equal(layout_probe.consume_perm(xt), xt * 2), lead
    x = torch.randn(4, 3, 5, 7, 9, device=cuda).to(dtype)
    for view in (x[:, 1:], x[..., 2:7], x[:, :1].expand(-1, 3, -1, -1, -1)):
        assert layout_probe.probe_path(view.shape, view.stride()) == layout_probe.STRIDED
        assert torch.equal(layout_probe.consume_base(view), view * 2)


# ------------------------------------------------- relative position bias (a0)

def _rpe_tables(cuda, seed, rows, H, nglo):
    """(local table, g2l, g2g) at σ 1: the bias as large as the scores."""
    gen = torch.Generator(device=cuda).manual_seed(seed)
    rnd = lambda *s: torch.randn(*s, generator=gen, device=cuda)
    return rnd(rows, H), rnd(2, H, nglo) if nglo else None, rnd(H, nglo, nglo) if nglo else None


def _grads_close(grads, refs, dtype, names):
    """Every gradient (dbias included) at chip_smoke.py's limits: 1e-4 of
    max(1, max|ref|) in f32; in bf16 1e-2 of it and 2e-2 of max|ref|."""
    for name, x, r in zip(names, grads, refs):
        if r is None:
            assert x is None, name
            continue
        if dtype == torch.float32:
            assert _rel_err(x, r) <= 1e-4, name
        else:
            assert _rel_err(x, r) <= CHUNK_GRAD_TOL and _scaled_err(x, r) <= CHUNK_SCALED_TOL, (
                name, _rel_err(x, r), _scaled_err(x, r))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N,C,H,grid,nglo", [(197, 384, 6, 14, 1), (49, 768, 12, 7, 0)])
def test_rpe_dense_kernels_with_table_biases(cuda, dtype, N, C, H, grid, nglo):
    """B3 and B4 at ViL-Small RPE's dense stages (batch 4) with the
    (H, N, N) bias the model assembles from its tables (g2g and g2l on the
    global token's row and column): out, LSE and every gradient, dbias too."""
    from vil_tpu_torch.models.attention import full_rpe_bias

    bias = full_rpe_bias(*_rpe_tables(cuda, 1, (2 * grid - 1) ** 2, H, nglo), grid, grid)
    gen = torch.Generator(device=cuda).manual_seed(2)
    q, k, v = (torch.randn(4, N, C, generator=gen, device=cuda).mul(C ** -0.25).to(dtype)
               for _ in range(3))
    g = torch.randn(4, N, C, generator=gen, device=cuda).to(dtype)
    out, lse = full_attention_fwd(q, k, v, bias, H, with_lse=True)
    ref, ref_lse = full_attention_reference(q.float(), k.float(), v.float(), bias, H,
                                            with_lse=True)
    assert _max_err(out, ref) <= (1e-4 if dtype == torch.float32 else CHUNK_OUT_TOL)
    assert _max_err(lse, ref_lse) <= CHUNK_LSE_TOL
    grads = full_attention_bwd(q, k, v, bias, g, out, lse, H)
    refs = full_attention_bwd_reference(q.float(), k.float(), v.float(), bias, g.float(), H)
    _grads_close(grads, refs, dtype, ("dq", "dk", "dv", "dbias"))
    assert grads[3].abs().max() > 0


def _rpe_chunk(cuda, dtype, nx, C, H, mode, seed):
    """Operands of ViL-Small RPE's sliding-chunk blocks at ``mode`` (batch
    4, nglo 1): (q, k, v, k_glo, v_glo), the front-order bias the model
    assembles from its tables, g and the additive mask."""
    from vil_tpu_torch.models.attention import sliding_chunk_rpe_bias

    table, g2l, _ = _rpe_tables(cuda, seed, 27 * 27, H, 1)
    bias = sliding_chunk_rpe_bias(table, g2l, 7, mode)
    acts, _, g, mask = _chunk_case(cuda, seed + 1, 4, nx, nx, 7, C // H, H, 1, 0, False, mode)
    return [None if a is None else a.to(dtype) for a in acts], bias, g.to(dtype), mask


CHUNK_NAMES = ("dq", "dk", "dv", "dk_glo", "dv_glo", "dbias")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("nx,C", [(56, 96), (28, 192)])
def test_rpe_sliding_chunk_kernels_with_table_biases(cuda, dtype, nx, C):
    """B1 and B2 at ViL-Small RPE's stages 1 and 2 with the (3, 49, 442)
    bias [g2l[1] | local] the model assembles: out, LSE, every gradient."""
    acts, bias, g, mask = _rpe_chunk(cuda, dtype, nx, C, 3, 0, 3)
    assert bias.shape == (3, 49, 442)
    out, lse = vil_attention_fwd(*acts, bias, mask, 3, with_lse=True)
    a32 = [None if a is None else a.float() for a in acts]
    ref, ref_lse = vil_attention_reference(*a32, bias, mask, 3, with_lse=True)
    assert _max_err(out, ref) <= (1e-4 if dtype == torch.float32 else CHUNK_OUT_TOL)
    assert _max_err(lse, ref_lse) <= CHUNK_LSE_TOL
    grads = vil_attention_bwd(*acts, bias, g, out, mask, lse, 3)
    _grads_close(grads, vil_attention_bwd_reference(*a32, bias, g.float(), mask, 3), dtype,
                 CHUNK_NAMES)


@pytest.mark.parametrize("mode", range(1, 9))
def test_rpe_sampled_neighbour_kernels_with_table_biases(cuda, mode):
    """B5 and B6 in bf16 and f32 at stage 2's grid with the (3, 49, 99)
    bias of ``mode`` in the kernels' front order [g2l[1] | self |
    sampled]: out, LSE and every gradient."""
    for dtype in (torch.float32, torch.bfloat16):
        acts, bias, g, mask = _rpe_chunk(cuda, dtype, 28, 192, 3, mode, 4)
        assert bias.shape == (3, 49, 99)
        out, lse = vil_mode_attention_fwd(*acts, bias, mask, 3, mode, with_lse=True)
        a32 = [None if a is None else a.float() for a in acts]
        ref, ref_lse = vil_mode_attention_reference(*a32, bias, mask, 3, mode, with_lse=True)
        assert _max_err(out, ref) <= (1e-4 if dtype == torch.float32 else CHUNK_OUT_TOL)
        assert _max_err(lse, ref_lse) <= CHUNK_LSE_TOL
        grads = vil_mode_attention_bwd(*acts, bias, g, out, mask, lse, 3, mode)
        refs = vil_mode_attention_bwd_reference(*a32, bias, g.float(), mask, 3, mode)
        _grads_close(grads, refs, dtype, CHUNK_NAMES)


@pytest.mark.parametrize("nx,C", [(56, 96), (28, 192)])
def test_rpe_fused_block_with_table_biases(cuda, nx, C):
    """B9a and B9b in bf16 at ViL-Small RPE's stages 1 and 2 (batch 4) with
    the model's (3, 49, 442) bias: y, k, v, and every gradient, dbias too,
    to CHUNK_SCALED_TOL with no floor."""
    _, bias, _, _ = _rpe_chunk(cuda, torch.float32, nx, C, 3, 0, 5)
    ops, g, mask = _block_bf16_case(cuda, 6, 4, nx, nx, C, 3, 1, False)
    ops[-1] = bias
    ops32 = [None if t is None else t.float() for t in ops]
    y, k, v = vil_block_fwd(*ops, mask, 3)
    for name, a, r in zip(("y", "k", "v"), (y, k, v), vil_block_reference(*ops32, mask, 3)):
        assert _scaled_err(a, r) <= CHUNK_SCALED_TOL, name
    errs, grads = _block_bf16_errors(ops, g, mask, 3)
    assert "dbias" in errs and max(errs.values()) <= CHUNK_SCALED_TOL, errs
    assert grads[11].abs().max() > 0


def test_rpe_halo_kernels_split_over_two_ranks(cuda):
    """B7a and B7b in bf16 on the two shards of ViL-Small RPE's stage-1
    grid with the model's bias: the shards' outputs together against B1's
    on the whole grid, their dK/dV folded onto the rows' owners and their
    dbias summed against B2's."""
    acts, bias, g, mask = _rpe_chunk(cuda, torch.bfloat16, 56, 96, 3, 0, 7)
    q, k, v, kg, vg = acts
    out, lse = vil_attention_fwd(*acts, bias, mask, 3, with_lse=True)
    whole = vil_attention_bwd(*acts, bias, g, out, mask, lse, 3)
    mxs = q.shape[1] // 2
    dq, dk, dv = (torch.zeros(t.shape, device=cuda) for t in (q, k, v))
    dbias, outs = torch.zeros_like(bias), []
    for sh in range(2):
        sl = slice(sh * mxs, (sh + 1) * mxs)
        (k_ext, rows), (v_ext, _) = _halo_shard(k, sh, mxs), _halo_shard(v, sh, mxs)
        ops = [q[:, sl].contiguous(), k_ext, v_ext, kg, vg, bias]
        o, l = vil_attention_halo_fwd(*ops, mask[sl], 3, with_lse=True)
        grads = vil_attention_halo_bwd(*ops, g[:, sl].contiguous(), o, mask[sl], l, 3)
        outs.append(o)
        dq[:, sl] = grads[0].float()
        for e, row in enumerate(rows):
            dk[:, row] += grads[1][:, e].float()
            dv[:, row] += grads[2][:, e].float()
        dbias += grads[5]
    assert _max_err(torch.cat(outs, dim=1), out.float()) <= CHUNK_OUT_TOL
    for name, x, r in (("dq", dq, whole[0]), ("dk", dk, whole[1]), ("dv", dv, whole[2]),
                       ("dbias", dbias, whole[5])):
        assert _scaled_err(x, r.float()) <= CHUNK_SCALED_TOL, name


RPE_ARCH = ("l1,h2,d64,n1,s1,g1,p4,f7,a0_l2,h2,d64,n2,s1,g1,p2,f7,a0_"
            "l3,h2,d128,n2,s0,g1,p2,f7,a0_l4,h2,d128,n1,s0,g0,p2,f7,a0")


def _rpe_model(cuda, use_kernels=True, **kw):
    model = MsViT(RPE_ARCH, img_size=224, num_classes=10, sharew=True, norm_embed=True,
                  device=cuda, use_kernels=use_kernels,
                  generator=torch.Generator().manual_seed(0), **kw)
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if "relative_position" in name:
                p.copy_(torch.randn(p.shape, generator=gen))
    return model


def test_rpe_model_serves_and_trains_through_the_kernels(cuda):
    """A narrow 224² RPE model with its tables at σ 1: the served logits
    (from precompute_rpe_cache and without it) and one f32 step's loss and
    gradients (the tables' included) equal to the plain path's; 3 and 3
    launches of each kernel per forward and step, every bias reaching its
    kernel; the tables' gradients the same bits in a second backward (the
    patch embedding's convolution need not be)."""
    from vil_tpu_torch.models import precompute_rpe_cache
    from vil_tpu_torch.train import loss

    x = torch.randn(4, 224, 224, 3, device=cuda)
    y = torch.randint(0, 10, (4,), device=cuda)
    logits, grads = {}, {}
    for use_kernels in (True, False):
        model = _rpe_model(cuda, use_kernels).eval()
        with torch.inference_mode():
            logits[use_kernels] = model(x)
            precompute_rpe_cache(model)
            assert torch.equal(model(x), logits[use_kernels])
        for _ in range(2 if use_kernels else 1):
            model.zero_grad()
            loss.cross_entropy(model.train()(x), y).backward()
            step = {n: p.grad.clone() for n, p in model.named_parameters()}
            if use_kernels in grads:  # the second backward: the tables' same bits
                for n, gr in step.items():
                    assert "relative_position" not in n or torch.equal(gr, grads[True][n]), n
            grads[use_kernels] = step
    # per forward B1 3 and B3 3: two served, two trained (B2 and B4 3 each)
    assert [fn.launches for fn in KERNELS] == [12, 12, 6, 6] + [0] * 8
    assert _max_err(logits[True], logits[False]) <= 1e-3
    for name, ref in grads[False].items():
        if ref.numel():
            assert _max_err(grads[True][name], ref) <= 1e-4 * max(1e-30, ref.abs().max().item()), name
    assert grads[True]["stage1_block0_attn.attn.local_relative_position_bias_table"].abs().max() > 0


def test_run_experiment_cli_one_epoch(cuda, tmp_path):
    """The port's CLI (``python -m vil_tpu_torch.run_experiment``) for one
    epoch of configs/msvit.yaml's recipe on a 2-class synthetic set at batch
    8 (8 steps, 8 eval batches, then the best checkpoint's eval): every
    launch per step and per eval batch, the checkpoint files, finite
    losses."""
    import math
    import os

    from vil_tpu_torch.run_experiment import main

    yaml = os.path.join(os.path.dirname(__file__), "..", "configs", "msvit.yaml")
    trainer = main(["--config-file", yaml, "--output_dir", str(tmp_path), "--seed", "0",
                    "DATA.TRAIN", "('synthetic',)", "DATA.TEST", "('synthetic',)",
                    "DATA.NUM_CLASSES", "2", "DATALOADER.BSZ", "8", "OPTIM.EPOCHS", "1",
                    "LOG_FREQ", "1"])
    steps, ev = trainer.steps_run[False], trainer.eval_batches
    assert trainer.steps_run[True] == 0 and steps == 8
    assert ev == 8 * (2 if trainer.best_evaluated else 1)
    # B1 3 a forward, B3 9; B2 3 and B4 9 a step; the rest 0
    assert [fn.launches for fn in KERNELS] == [3 * (steps + ev), 9 * (steps + ev), 3 * steps,
                                               9 * steps] + [0] * 8
    assert all(math.isfinite(r["loss"]) for r in trainer.steps_log)
    assert all(math.isfinite(e["loss"]) for e in trainer.evals)
    for f in ("checkpoint_1.ckpt", "checkpoint_1.ckpt.json", "last_checkpoint", "config.yaml"):
        assert (tmp_path / f).is_file(), f


# -- the paper's other attention families ------------------------------------------
FAMILY_ARCH = "l1,h2,d32,n1,s1,g1,p4,f{}_l2,h2,d64,n1,s1,g1,p2,f{}_l3,h2,d64,n2,s0,g1,p2,f4"
FAMILIES = {
    # name: (MsViT keywords, stage 1-2 f, sliding-chunk blocks a forward)
    "linformer": (dict(attn_type="linformer", share_kv=True), (8, 8), 0),
    "linformer-unshared": (dict(attn_type="linformer", share_kv=False), (8, 8), 0),
    "srformer": (dict(attn_type="srformer"), (4, 2), 0),
    "performer": (dict(attn_type="performer"), (8, 12), 0),
    "global": (dict(only_glo=True), (4, 4), 0),
    "unshared": (dict(sharew=False), (4, 4), 2),
}


@pytest.mark.parametrize("family", list(FAMILIES))
def test_attention_family_serves_and_trains_through_the_kernels(cuda, family):
    """A narrow 64² model of each family in f32: its dense stage through B3
    (2 launches a forward) and B4, the sliding-chunk stages of the unshared
    ViL through B1/B2; logits and one step's loss and parameter gradients
    equal to the plain path's (the performer's projections alike); then a
    bf16 forward, kernels vs plain, to 2.5e-2 of max|ref|."""
    from vil_tpu_torch.train import engine, loss

    kw, feats, chunked = FAMILIES[family]
    arch = FAMILY_ARCH.format(*feats)
    x = torch.randn(4, 64, 64, 3, device=cuda)
    y = torch.randint(0, 10, (4,), device=cuda)
    results = {}
    for use_kernels in (True, False):
        model = MsViT(arch, img_size=64, num_classes=10, norm_embed=True,
                      drop_path_rate=0.1, device=cuda, use_kernels=use_kernels,
                      generator=torch.Generator().manual_seed(0), **{"sharew": True, **kw})
        with torch.inference_mode():
            logits = model.eval()(x)
        opt = torch.optim.AdamW(model.parameters())
        step = engine.make_train_step(model, loss.cross_entropy, opt, device=cuda)
        metrics = step(x, y, torch.Generator(device=cuda).manual_seed(1))
        results[use_kernels] = (logits, metrics["loss"].item(),
                                {n: p.grad for n, p in model.named_parameters()})
    launches = {fn.__name__: fn.launches for fn in KERNELS}
    assert launches["full_attention_fwd"] == 4 and launches["full_attention_bwd"] == 2
    assert launches["vil_attention_fwd"] == 2 * chunked
    assert launches["vil_attention_bwd"] == chunked
    (lk, loss_k, gk), (lp, loss_p, gp) = results[True], results[False]
    assert torch.isfinite(lk).all() and _max_err(lk, lp.float()) <= 1e-3
    assert abs(loss_k - loss_p) <= 1e-4
    for name, ref in gp.items():
        if ref.numel():
            assert _max_err(gk[name], ref) <= 1e-4 * ref.abs().max().item(), name
    bf16 = {}
    with torch.inference_mode():
        for use_kernels in (True, False):
            model = MsViT(arch, img_size=64, num_classes=10, norm_embed=True, device=cuda,
                          use_kernels=use_kernels, dtype=torch.bfloat16,
                          generator=torch.Generator().manual_seed(0),
                          **{"sharew": True, **kw}).eval()
            bf16[use_kernels] = model(x).float()
    assert _max_err(bf16[True], bf16[False]) <= 2.5e-2 * bf16[False].abs().max().item()


@pytest.mark.parametrize("family", ["linformer", "srformer", "performer"])
def test_efficient_attention_on_the_card_matches_the_cpu(cuda, family):
    """Each efficient module in f32 on the card against itself on the CPU,
    same weights and buffer: output, input and parameter gradients to 1e-4
    of max|ref| (f32 sums in another order)."""
    from vil_tpu_torch.models import attention_efficient as eff

    make = {"linformer": lambda d: eff.LinformerAttention(64, 257, 32, 2, device=d),
            "srformer": lambda d: eff.SRAttention(64, 4, 2, device=d),
            "performer": lambda d: eff.PerformerAttention(64, 2, 40, device=d)}[family]
    torch.manual_seed(0)
    ref_mod = make("cpu")
    mod = make(cuda)
    mod.load_state_dict(ref_mod.state_dict())
    x = torch.randn(2, 257, 64)
    g = torch.randn(2, 257, 64)
    outs = {}
    for m, dev in ((mod, cuda), (ref_mod, "cpu")):
        xd = x.to(dev).requires_grad_()
        out = m(xd, 16, 16)
        out.backward(g.to(dev))
        outs[dev] = [out.detach().cpu(), xd.grad.cpu()] + [p.grad.cpu() for p in m.parameters()]
    for a, b in zip(outs[cuda], outs["cpu"]):
        assert _max_err(a, b) <= 1e-4 * b.abs().max().item()


def test_redraw_on_the_card_is_the_host_draw(cuda):
    """The performer's redraw writes the same matrix into a model on the card
    as into one on the CPU, from the same seed."""
    from vil_tpu_torch.train.redraw import redraw_projections

    arch = FAMILY_ARCH.format(8, 12)
    models = [MsViT(arch, img_size=64, num_classes=10, attn_type="performer", device=d,
                    generator=torch.Generator().manual_seed(0)) for d in (cuda, "cpu")]
    for m in models:
        assert redraw_projections(m, torch.Generator().manual_seed(5)) == 2
    for (n, a), b in zip(models[0].named_buffers(), models[1].buffers()):
        assert a.device.type == "cuda" and torch.equal(a.cpu(), b), n


# chip_smoke.py's high-resolution cases (part highres) at one image and one
# head, each kernel against its plain version at chip_smoke.py's limits:
# (nx, ny, w, head dim) of the sliding-chunk grids (nglo 1): ViL-Medium-Deep
# 384²'s 14×14 chunks pad 2, ViL-Small 1024²'s 37×37 pad 3 and 19×19 pad 5,
# the windows W 6, W 8 and W 12 of the _384 zoo entries
HIGHRES_GRIDS = [(96, 96, 7, 32), (256, 256, 7, 32), (128, 128, 7, 64), (96, 96, 6, 32),
                 (96, 96, 8, 64), (48, 48, 12, 64)]
HIGHRES_TOL = {torch.float32: (1e-4, 1e-5), torch.bfloat16: (2e-2, 1e-2)}  # out, grads


def _highres_chunk_errors(cuda, dtype, nx, ny, w, M, mode):
    """B1/B2 (mode 0) or B5/B6 (modes 1..8) on one image, one head, nglo 1,
    against the plain versions in f32 on the same values: (out, lse, grads
    rel to max(1, max|ref|), the largest max|err| / max|ref|)."""
    gen = torch.Generator(device=cuda).manual_seed(nx + w + mode)
    padx, pady, mx, my = sc.chunk_grid(nx, ny, w)
    w2 = w * w
    rnd = lambda *s: torch.randn(*s, generator=gen, device=cuda)
    acts = [(rnd(1, mx, my, w2, M) * M ** -0.25).to(dtype) for _ in range(3)]
    acts += [(rnd(1, 1, M) * M ** -0.25).to(dtype) for _ in range(2)]
    g = rnd(1, mx, my, w2, M).to(dtype)
    mask = torch.from_numpy(mask_to_additive(
        masks.invalid_mask(mx, my, padx, pady, w, 0, mode), mx, my, w2, 1)).to(cuda)
    a32 = [a.float() for a in acts]
    if mode == 0:
        out, lse = vil_attention_fwd(*acts, None, mask, 1, with_lse=True)
        ref, ref_lse = vil_attention_reference(*a32, None, mask, 1, with_lse=True)
        grads = vil_attention_bwd(*acts, None, g, out, mask, lse, 1)
        refs = vil_attention_bwd_reference(*a32, None, g.float(), mask, 1)
    else:
        out, lse = vil_mode_attention_fwd(*acts, None, mask, 1, mode, with_lse=True)
        ref, ref_lse = vil_mode_attention_reference(*a32, None, mask, 1, mode, with_lse=True)
        grads = vil_mode_attention_bwd(*acts, None, g, out, mask, lse, 1, mode)
        refs = vil_mode_attention_bwd_reference(*a32, None, g.float(), mask, 1, mode)
    pairs = [(x, r) for x, r in zip(grads, refs) if r is not None]
    return (_max_err(out, ref), _max_err(lse, ref_lse), max(_rel_err(x, r) for x, r in pairs),
            max(_scaled_err(x, r) for x, r in [(out, ref), *pairs]))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("nx,ny,w,M", HIGHRES_GRIDS)
def test_highres_sliding_chunk_kernels(cuda, dtype, nx, ny, w, M):
    """B1 and B2 at each high-resolution grid and window: out, LSE, every
    gradient (and in bf16 the scaled errors)."""
    tol, grad_tol = HIGHRES_TOL[dtype]
    e_out, e_lse, e_grad, scaled = _highres_chunk_errors(cuda, dtype, nx, ny, w, M, 0)
    case = (nx, w, M, e_out, e_lse, e_grad, scaled)
    assert e_out <= tol and e_lse <= CHUNK_LSE_TOL and e_grad <= grad_tol, case
    assert dtype == torch.float32 or scaled <= CHUNK_SCALED_TOL, case
    assert vil_attention_fwd.launches == vil_attention_bwd.launches == 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", [1, 6])
@pytest.mark.parametrize("nx,ny,w,M", [HIGHRES_GRIDS[1], HIGHRES_GRIDS[5]])
def test_highres_sampled_neighbour_kernels(cuda, dtype, nx, ny, w, M, mode):
    """B5 and B6 on ViL-Small 1024²'s 37×37 grid and at W 12, two modes."""
    tol, grad_tol = HIGHRES_TOL[dtype]
    e_out, e_lse, e_grad, scaled = _highres_chunk_errors(cuda, dtype, nx, ny, w, M, mode)
    case = (nx, w, mode, e_out, e_lse, e_grad, scaled)
    assert e_out <= tol and e_lse <= CHUNK_LSE_TOL and e_grad <= grad_tol, case
    assert dtype == torch.float32 or scaled <= CHUNK_SCALED_TOL, case


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N", [577, 4097, 1024, 144])
def test_highres_dense_kernels(cuda, dtype, N):
    """B3 and B4 at the high-resolution dense lengths (stage 3 of 384² and
    1024², stage 4 of 1024² and 384²) on one image, one head of 64."""
    gen = torch.Generator(device=cuda).manual_seed(N)
    q, k, v = ((torch.randn(1, N, 64, generator=gen, device=cuda) * 64 ** -0.25).to(dtype)
               for _ in range(3))
    g = torch.randn(1, N, 64, generator=gen, device=cuda).to(dtype)
    out, lse = full_attention_fwd(q, k, v, None, 1, with_lse=True)
    grads = full_attention_bwd(q, k, v, None, g, out, lse, 1)
    a32 = [t.float() for t in (q, k, v)]
    ref, ref_lse = full_attention_reference(*a32, None, 1, with_lse=True)
    refs = full_attention_bwd_reference(*a32, None, g.float(), 1)
    tol, grad_tol = HIGHRES_TOL[dtype]
    e_grad = max(_rel_err(x, r) for x, r in zip(grads[:3], refs[:3]))
    scaled = max(_scaled_err(x, r) for x, r in [(out, ref), *zip(grads[:3], refs[:3])])
    case = (N, _max_err(out, ref), _max_err(lse, ref_lse), e_grad, scaled)
    assert case[1] <= tol and case[2] <= DENSE_LSE_TOL and e_grad <= grad_tol, case
    assert dtype == torch.float32 or scaled <= DENSE_SCALED_TOL, case


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("w", [12, 8])
def test_highres_fused_block_kernels(cuda, dtype, w):
    """B9a and B9b at W 12 (4×4 chunks, ViL-Medium-Wide 384²'s stage 2) and
    W 8 (12×12), one image, one head of 64, nglo 1: y, k, v and every
    gradient against the plain versions (dbk at dWk's scale)."""
    gen = torch.Generator(device=cuda).manual_seed(w)
    C, nx = 64, 48 if w == 12 else 96
    padx, pady, mx, my = sc.chunk_grid(nx, nx, w)
    rnd = lambda *s, scale=1.0: torch.randn(*s, generator=gen, device=cuda) * scale
    ops = [rnd(1, mx, my, w * w, C).to(dtype)]
    for i in range(4):
        ops += [rnd(C, C, scale=C ** -0.5 * (C ** -0.5 if i == 0 else 1.0)).to(dtype),
                rnd(C, scale=0.02)]
    ops += [rnd(1, 1, C).to(dtype), rnd(1, 1, C).to(dtype), None]
    mask = torch.from_numpy(mask_to_additive(
        masks.invalid_mask(mx, my, padx, pady, w, 0, 0), mx, my, w * w, 1)).to(cuda)
    g = rnd(1, mx, my, w * w, C).to(dtype)
    y, k, v, lse, q, attn = vil_block_fwd(*ops, mask, 1, with_lse=True, saved=True)
    grads = vil_block_bwd(*ops, g, mask, lse, 1, (q, k, v, attn))
    ops32 = [None if t is None else t.float() for t in ops]
    refs = vil_block_bwd_reference(*ops32, g.float(), mask, 1)
    tol, grad_tol = HIGHRES_TOL[dtype]
    e_out = max(_max_err(a, r) for a, r in zip((y, k, v), vil_block_reference(*ops32, mask, 1)))
    e_grad = max(_max_err(a, r) / max(1.0, refs[3 if i == 4 else i].abs().max().item())
                 for i, (a, r) in enumerate(zip(grads, refs)) if r is not None)
    assert e_out <= tol and e_grad <= grad_tol, (w, e_out, e_grad)
    assert vil_block_fwd.launches == vil_block_bwd.launches == 1
