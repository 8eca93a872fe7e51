"""The layout probe's kernel P (``vil_tpu_torch.tools.layout_probe``) on the
CPU: the path its wrapper picks from the strides, the output it allocates
for the dense path, and the plain version the CPU runs (exactly 2x, as the
TPU kernel's body ``o = x * 2.0`` of ``tools/layout_probe.py``).

The kernel itself runs only on a card (``tests/test_torch_gpu.py`` and
``chip_smoke.py`` phase 3 hold it to ``x * 2`` bit for bit there).
"""
import numpy as np
import pytest
import torch

from vil_tpu_torch.tools import layout_probe
from vil_tpu_torch.tools.layout_probe import DENSE, STRIDED

DTYPES = [torch.float32, torch.bfloat16]
SHAPE = (4, 2, 3, 5, 8)  # the probe's (B, mx, my, W², C), cut down
RAGGED = (3, 2, 2, 7, 5)  # 420 elements: no whole number of 16-byte vectors


def _x(shape, dtype, seed=0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dtype)


def _misaligned(shape, dtype):
    """A contiguous view that starts one element into its storage."""
    flat = _x((int(np.prod(shape)) + 1,), dtype)
    return flat[1:].view(shape)


# each layout: (name, view of a base tensor, the path P must take)
LAYOUTS = [
    ("base", lambda x: x, DENSE),
    ("permuted view", lambda x: x.permute(1, 2, 3, 0, 4), DENSE),
    ("row slice", lambda x: x[:, :, 1:3], STRIDED),
    ("channel slice", lambda x: x[..., :5], STRIDED),
    ("stride-0 expand", lambda x: x[:, :1].expand(-1, 3, -1, -1, -1), STRIDED),
    ("first image (size-1 axis)", lambda x: x[:1], DENSE),
    ("misaligned base", lambda x: _misaligned(x.shape, x.dtype), DENSE),
]


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("name,view,path", LAYOUTS, ids=[n for n, _, _ in LAYOUTS])
def test_probe_path_follows_the_strides(name, view, path, dtype):
    """Each layout goes to its path: a view that covers one span with no gap
    and no overlap (base, permuted, an axis cut to size 1, a view offset in
    its storage) to the flat kernel, any other (a slice, an expand) through
    the strides. The dtype does not change the choice."""
    x = view(_x(SHAPE, dtype))
    assert layout_probe.probe_path(x.shape, x.stride()) == path
    assert layout_probe.probe_path(tuple(x.shape), list(x.stride())) == path


def test_probe_path_of_overlapping_and_gapped_strides():
    """Strides that overlap (two axes of one stride) or leave gaps are not
    dense, whatever their order; a single element is."""
    assert layout_probe.probe_path((2, 2, 1, 1, 1), (1, 1, 1, 1, 1)) == STRIDED
    assert layout_probe.probe_path((2, 3, 1, 1, 1), (4, 1, 1, 1, 1)) == STRIDED
    assert layout_probe.probe_path((2, 3, 1, 1, 1), (1, 2, 7, 7, 7)) == DENSE
    assert layout_probe.probe_path((1, 1, 1, 1, 1), (0, 0, 0, 0, 0)) == DENSE


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("misaligned", [False, True], ids=["aligned", "misaligned"])
def test_dense_output_shares_the_input_layout_and_alignment(dtype, misaligned):
    """The dense path's output has x's strides and starts at x's offset from
    a 16-byte boundary, so the flat kernel's vectors line up in both; the
    strided path's is a new contiguous tensor."""
    base = _misaligned(RAGGED, dtype) if misaligned else _x(RAGGED, dtype)
    for x in (base, base.permute(1, 2, 3, 0, 4)):
        y = layout_probe.output_for(x, DENSE)
        assert y.shape == x.shape and y.stride() == x.stride() and y.dtype == dtype
        assert y.data_ptr() % 16 == x.data_ptr() % 16
    assert (base.data_ptr() % 16 != 0) == misaligned
    y = layout_probe.output_for(base[:, :, 1:], STRIDED)
    assert y.is_contiguous() and y.shape == base[:, :, 1:].shape


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", [SHAPE, RAGGED], ids=["shape", "ragged"])
def test_consume_on_the_cpu_is_exactly_twice_x(shape, dtype):
    """On the CPU both entry points run the plain version: x * 2 bit for
    bit, in the base layout, the permuted view, a slice and a misaligned
    view, and no launch is counted."""
    for fn in layout_probe.KERNELS:
        fn.launches = 0
    x = _x(shape, dtype, seed=1)
    want = torch.from_numpy(x.float().numpy() * 2).to(dtype)
    assert torch.equal(layout_probe.consume_base(x), want)
    xt = x.permute(1, 2, 3, 0, 4)
    assert torch.equal(layout_probe.consume_perm(xt), want.permute(1, 2, 3, 0, 4))
    assert torch.equal(layout_probe.consume_base(x[:, :, 1:]), want[:, :, 1:])
    xm = _misaligned(shape, dtype)
    assert torch.equal(layout_probe.consume_base(xm), xm * 2)
    assert [fn.launches for fn in layout_probe.KERNELS] == [0, 0]
