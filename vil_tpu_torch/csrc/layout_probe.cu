// Layout probe kernel P for Hopper (sm_90a): y = 2 x over a 5-D tensor, each
// operand read or written in place through its strides.
//
// Replaces the TPU kernels of tools/layout_probe.py, consume_base (over the
// stage layout (B, mx, my, W², C)) and consume_perm (over its permutation
// (mx, my, W², B, C)), Pallas body `kernel`: o = x * 2. That probe asks
// whether XLA turns a logical transpose in front of a custom call into a
// relabelling of the layout, or copies. Here the kernel takes any strided
// view, so a permuted view reaches it without a copy; whether a copy shows
// up elsewhere in the probe's chain is what the tool's census reports
// (vil_tpu_torch/tools/layout_probe.py).
//
// What bounds it on an H100: bytes. One read and one write of each element
// for one multiply: ViL-Small's stage-1 layout (64, 8, 8, 49, 96) in bf16 is
// 38.5 MB each way, 23 us at 3.35 TB/s.
//
// What the design does about it. One thread per element, the linear index
// over the logical shape with the last axis innermost, so neighbouring
// threads touch neighbouring addresses whenever that axis has stride 1 (C in
// both of the probe's layouts); 32-bit index arithmetic (the wrapper refuses
// 2^31 elements or more), 64-bit offsets.
#include "attention_common.cuh"

namespace vil {

struct Layout5 {
  int d[5];
  long long xs[5], ys[5];  // strides in elements
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
layout_probe_scale(const T* __restrict__ x, T* __restrict__ y, Layout5 L, unsigned n) {
  for (unsigned idx = blockIdx.x * blockDim.x + threadIdx.x; idx < n;
       idx += gridDim.x * blockDim.x) {
    unsigned rest = idx;
    long long xo = 0, yo = 0;
#pragma unroll
    for (int a = 4; a >= 0; --a) {
      const unsigned i = rest % (unsigned)L.d[a];
      rest /= (unsigned)L.d[a];
      xo += i * L.xs[a];
      yo += i * L.ys[a];
    }
    y[yo] = from_float<T>(2.f * to_float(x[xo]));
  }
}

inline int probe(const void* x, void* y, long long d0, long long d1, long long d2, long long d3,
                 long long d4, const long long* xs, const long long* ys, int is_bf16,
                 void* stream) {
  const long long n = d0 * d1 * d2 * d3 * d4;
  if (n <= 0 || n >= (1ll << 31)) return cudaErrorInvalidValue;
  Layout5 L{{(int)d0, (int)d1, (int)d2, (int)d3, (int)d4}, {}, {}};
  for (int a = 0; a < 5; ++a) {
    L.xs[a] = xs[a];
    L.ys[a] = ys[a];
  }
  const dim3 grid((unsigned)((n + kThreads - 1) / kThreads));
  auto* s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch(layout_probe_scale<__nv_bfloat16>, grid, 0, s, (const __nv_bfloat16*)x,
                  (__nv_bfloat16*)y, L, (unsigned)n);
  return launch(layout_probe_scale<float>, grid, 0, s, (const float*)x, (float*)y, L,
                (unsigned)n);
}

}  // namespace vil

// x, y: 5-D views (any strides, in elements) of the logical shape d0..d4;
// y must not overlap x. Returns the launch's error.
// consume_base's layout: (d0..d4) = (B, mx, my, W², C).
extern "C" int layout_probe_base(const void* x, void* y, long long B, long long mx, long long my,
                                 long long w2, long long C, long long xs0, long long xs1,
                                 long long xs2, long long xs3, long long xs4, long long ys0,
                                 long long ys1, long long ys2, long long ys3, long long ys4,
                                 int is_bf16, void* stream) {
  const long long xs[5] = {xs0, xs1, xs2, xs3, xs4}, ys[5] = {ys0, ys1, ys2, ys3, ys4};
  return vil::probe(x, y, B, mx, my, w2, C, xs, ys, is_bf16, stream);
}

// consume_perm's layout: (d0..d4) = (mx, my, W², B, C).
extern "C" int layout_probe_perm(const void* x, void* y, long long mx, long long my,
                                 long long w2, long long B, long long C, long long xs0,
                                 long long xs1, long long xs2, long long xs3, long long xs4,
                                 long long ys0, long long ys1, long long ys2, long long ys3,
                                 long long ys4, int is_bf16, void* stream) {
  const long long xs[5] = {xs0, xs1, xs2, xs3, xs4}, ys[5] = {ys0, ys1, ys2, ys3, ys4};
  return vil::probe(x, y, mx, my, w2, B, C, xs, ys, is_bf16, stream);
}
