"""Layout probe: does a logical transpose in front of a kernel cost a copy?

    python -m vil_tpu_torch.tools.layout_probe      # on one CUDA card

Counterpart of ``tools/layout_probe.py``, which asks whether XLA turns a
transpose in front of a Pallas call into a relabelling of the layout. Its
kernel (P: y = 2x) has two wrappers here, over ``csrc/layout_probe.cu``,
each reading and writing its operand in place:
:func:`consume_base` over the stage layout (B, mx, my, W², C) and
:func:`consume_perm` over the permuted (mx, my, W², B, C). The output keeps
the input's strides where the input is dense, as the plain version ``x * 2``
does. The wrapper picks the kernel's path from the strides
(:func:`probe_path`): flat over one span for a dense view, such as both of
the probe's layouts (one entry point, ``layout_probe_flat``), else through
the strides (an entry point per layout).

The tool runs the probe's chain, a producer GEMM → P → a consumer GEMM, in
two schemes, at the probe's shape (64, 8, 8, 49, 96) in bf16:

* A: P on the base layout;
* B: permute to (mx, my, W², B, C) (a view), P on the permuted view, permute
  back, then the consumer GEMM.

For each scheme it prints the census of copy ops (``aten::copy_``,
``aten::contiguous``, ``aten::clone``, and the card's copy kernels) that
``torch.profiler`` sees per iteration of the chain, and the time per
iteration from two chain lengths (the difference over the difference in
iterations, best of three), as the TPU probe times it.
"""
from __future__ import annotations

import functools
import time

import torch

from ..ops.kernels import build

B, MX, MY, W2, C = 64, 8, 8, 49, 96  # the TPU probe's shape
ITERS = (4, 24)  # the two chain lengths
COPY_OPS = ("aten::copy_", "aten::contiguous", "aten::clone")


def scale2_reference(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of P."""
    return x * 2


DENSE, STRIDED = "dense", "strided"  # the kernel's two paths


def probe_path(shape, strides) -> str:
    """P's path for a view of ``shape`` and ``strides`` (in elements):
    ``DENSE`` where the view covers one span of its numel elements with no
    gap and no overlap, in any order of its axes (the output then takes the
    same strides, and y = 2x runs flat over the span in memory order), else
    ``STRIDED`` (a slice, a stride-0 expand). Axes of size 1 take no part."""
    span = 1
    for stride, size in sorted((st, sz) for sz, st in zip(shape, strides) if sz != 1):
        if stride != span:
            return STRIDED
        span *= size
    return DENSE


def output_for(x: torch.Tensor, path: str) -> torch.Tensor:
    """P's output for ``x``: for the dense path x's strides, starting at the
    same offset as x from a 16-byte boundary, so that both spans share
    their vectors; else ``empty_like`` (contiguous)."""
    lead = x.data_ptr() % 16 // x.element_size()
    if path == STRIDED or not lead:  # the allocator's blocks are 16-byte aligned
        return torch.empty_like(x)
    buf = torch.empty(lead + x.numel(), dtype=x.dtype, device=x.device)
    return buf.as_strided(x.shape, x.stride(), lead)


# the path of each layout met, decided once (a few microseconds each time)
_path_of = functools.lru_cache(maxsize=256)(probe_path)
_DTYPES = (torch.float32, torch.bfloat16)


def _launch(entry: str, x: torch.Tensor) -> torch.Tensor:
    """P on x's card: the dense path by ``layout_probe_flat``, the strided
    one by ``entry``, the layout's own entry point."""
    dtype, device, n = x.dtype, x.device, x.numel()
    if x.dim() != 5 or dtype not in _DTYPES:
        raise ValueError(f"P takes a 5-D float32 or bfloat16 tensor, got {dtype} "
                         f"{tuple(x.shape)}")
    if device.type != "cuda":
        raise ValueError(f"device {device} is not supported")
    if n >= 2 ** 31:
        raise ValueError(f"P takes fewer than 2^31 elements, got {n}")
    if device.index != torch.cuda.current_device():
        with torch.cuda.device(device):
            return _launch(entry, x)
    path = _path_of(x.shape, x.stride())
    y = output_for(x, path)
    stream = build.stream(device)
    is_bf16 = int(dtype == torch.bfloat16)
    if path == DENSE:
        entry = "layout_probe_flat"
        err = getattr(build.load(), entry)(x.data_ptr(), y.data_ptr(), n, is_bf16, stream)
    else:
        err = getattr(build.load(), entry)(x.data_ptr(), y.data_ptr(), *x.shape, *x.stride(),
                                           *y.stride(), is_bf16, stream)
    build.check(err, entry)
    return y


def consume_base(y: torch.Tensor) -> torch.Tensor:
    """P over the stage layout (B, mx, my, W², C), any strides. On a CUDA
    device it launches the kernel (or raises); on the CPU it runs the plain
    version."""
    if y.device.type == "cpu":
        return scale2_reference(y)
    out = _launch("layout_probe_base", y)
    consume_base.launches += 1
    return out


consume_base.launches = 0


def consume_perm(y: torch.Tensor) -> torch.Tensor:
    """P over the permuted layout (mx, my, W², B, C), any strides: the same
    kernel with the other entry point."""
    if y.device.type == "cpu":
        return scale2_reference(y)
    out = _launch("layout_probe_perm", y)
    consume_perm.launches += 1
    return out


consume_perm.launches = 0

KERNELS = (consume_base, consume_perm)


def scheme_a(y: torch.Tensor) -> torch.Tensor:
    return consume_base(y)


def scheme_b(y: torch.Tensor) -> torch.Tensor:
    z = consume_perm(y.permute(1, 2, 3, 0, 4))
    return z.permute(3, 0, 1, 2, 4)


SCHEMES = {"A-base": scheme_a, "B-perm": scheme_b}


def chain(scheme, x: torch.Tensor, w_in: torch.Tensor, w_out: torch.Tensor,
          iters: int) -> torch.Tensor:
    """``iters`` passes of producer GEMM → ``scheme`` → consumer GEMM (the
    out-projection analogue); returns the f32 sum of the result."""
    for _ in range(iters):
        x = torch.matmul(scheme(torch.matmul(x, w_in)), w_out)
    return x.float().sum()


def inputs(device, dtype=torch.bfloat16, shape=(B, MX, MY, W2, C)):
    """(x, w_in, w_out) of the probe, drawn from seed 0 on the CPU."""
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(*shape, generator=gen)
    ws = [torch.randn(shape[-1], shape[-1], generator=gen) * shape[-1] ** -0.5
          for _ in range(2)]
    return [t.to(device=device, dtype=dtype) for t in (x, *ws)]


def census(scheme, x, w_in, w_out, iters: int) -> dict:
    """Copy ops that ``torch.profiler`` records over one chain of ``iters``
    passes: each of ``COPY_OPS`` by name, and ``kernels``, the card's
    kernels and memcpys whose name says copy."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if x.is_cuda:
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        chain(scheme, x, w_in, w_out, iters)
        if x.is_cuda:
            torch.cuda.synchronize()
    counts = dict.fromkeys(COPY_OPS + ("kernels",), 0)
    for evt in prof.events():
        if evt.name in COPY_OPS:
            counts[evt.name] += 1
        elif (evt.device_type == torch.autograd.DeviceType.CUDA
              and "copy" in evt.name.lower()):
            counts["kernels"] += 1
    return counts


def per_iteration_copies(scheme, x, w_in, w_out, iters=ITERS) -> dict:
    """The census per pass of the chain: the difference of two chain
    lengths over the difference of their passes."""
    lo, hi = (census(scheme, x, w_in, w_out, n) for n in iters)
    return {k: (hi[k] - lo[k]) / (iters[1] - iters[0]) for k in lo}


def ms_per_iteration(scheme, x, w_in, w_out, iters=ITERS) -> float:
    """Wall time of one pass on the card: the difference of two chain
    lengths, each ended by a synchronise, best of three."""

    def timed(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        chain(scheme, x, w_in, w_out, n).item()
        return time.perf_counter() - t0

    for n in iters:  # warm-up
        timed(n)
    best = float("inf")
    for _ in range(3):
        lo, hi = timed(iters[0]), timed(iters[1])
        per = (hi - lo) / (iters[1] - iters[0])
        if per > 0:
            best = min(best, per)
    return best * 1e3


def run() -> dict:
    """Both schemes on the card: {scheme: {"copies": per-pass census,
    "ms": ms per pass}}, after checking that they agree."""
    x, w_in, w_out = inputs(torch.device("cuda"))
    y = torch.matmul(x, w_in)
    if not torch.equal(scheme_a(y), scheme_b(y)):
        raise AssertionError("the two schemes of P disagree")
    return {name: {"copies": per_iteration_copies(fn, x, w_in, w_out),
                   "ms": ms_per_iteration(fn, x, w_in, w_out)}
            for name, fn in SCHEMES.items()}


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("layout_probe: needs a CUDA card")
    print(f"{torch.cuda.get_device_name(0)}; P over ({B}, {MX}, {MY}, {W2}, {C}) bf16, "
          f"chains of {ITERS[0]} and {ITERS[1]} passes")
    for name, res in run().items():
        copies = ", ".join(f"{k} {v:g}" for k, v in res["copies"].items())
        print(f"[{name}] copy ops per pass: {copies}")
        print(f"[{name}] per-iteration: {res['ms']:.3f} ms")


if __name__ == "__main__":
    main()
