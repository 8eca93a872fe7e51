"""The port's CUDA kernels on a card, against their plain PyTorch versions.

Marked ``gpu``: each test skips where no CUDA card is present (the kernels
have no CPU mode). This file imports neither jax nor ``vil_tpu``, so it also
runs on a host without them, without the repo's ``conftest.py``:

    python -m pytest --noconftest tests/test_torch_gpu.py -q

Tolerances: 1e-4 for f32 inputs (sums in another order); 2e-2 for bf16
inputs, against the plain version in f32 on the same bf16 values (the kernel
rounds its output to bf16 once).
"""
import numpy as np
import pytest
import torch

from vil_tpu_torch.models import MsViT
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
    assert [fn.launches for fn in KERNELS] == [4, 3]


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
    assert [fn.launches for fn in KERNELS] == [3, 3]
    assert torch.isfinite(logits[True]).all()
    assert _max_err(logits[True], logits[False]) <= 1e-3
    with pytest.raises(NotImplementedError, match="no backward kernel"):
        q = torch.zeros(1, 9, 64, device=cuda, requires_grad=True)
        full_attention_fwd(q, q, q, None, 1)
