// Layout probe kernel P for Hopper (sm_90a): y = 2 x over a 5-D tensor, each
// operand read or written in place.
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
// What the design does about it. The wrapper picks one of two paths from the
// strides, on the host (layout_probe.probe_path), and one entry point for it:
//   dense    (layout_probe_flat) x and y cover one span of n elements each,
//            with equal strides (the probe's base layout, and its permuted
//            view, whose output keeps the view's strides): y = 2 x is then
//            elementwise over the span in memory order, whatever the logical
//            order. The kernel runs flat over it, 16 bytes a thread per
//            access (uint4: 8 bf16 or 4 f32), four independent accesses in
//            flight per thread, in a grid-stride loop over 8 blocks per SM; a
//            scalar head up to x's first 16-byte boundary (the wrapper gives
//            y the same offset mod 16) and a scalar tail past the last whole
//            vector. No index arithmetic per element.
//   strided  (layout_probe_base, layout_probe_perm, one per layout of the
//            TPU probe) any other view (a slice, a stride-0 expand): one warp
//            per run along the innermost axis, its 5-D offset decomposed once
//            per run, the lanes walking the run through that axis's strides.
// The host's share of a call is kept small: the dense entry takes 5
// arguments (a ctypes call converts each), and the launch is a plain <<<>>>
// with no attribute call (no dynamic shared memory).
#include <stdint.h>

#include <algorithm>

#include "attention_common.cuh"

namespace vil {

constexpr int kProbeUnroll = 4;       // uint4 accesses in flight per thread
constexpr int kProbeBlocksPerSm = 8;  // 8 x 256 threads: a full SM

struct Layout5 {
  int d[5];
  long long xs[5], ys[5];  // strides in elements
};

__device__ __forceinline__ float scale2(float x) { return 2.f * x; }
__device__ __forceinline__ __nv_bfloat16 scale2(__nv_bfloat16 x) {
  return __float2bfloat16(2.f * __bfloat162float(x));
}

// 2x of each element of a 16-byte vector, rounded as the scalar form
__device__ __forceinline__ uint4 scale2_vec(uint4 v, float) {
  float* f = reinterpret_cast<float*>(&v);
#pragma unroll
  for (int e = 0; e < 4; ++e) f[e] = scale2(f[e]);
  return v;
}
__device__ __forceinline__ uint4 scale2_vec(uint4 v, __nv_bfloat16) {
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 f = __bfloat1622float2(h[e]);
    h[e] = __floats2bfloat162_rn(2.f * f.x, 2.f * f.y);
  }
  return v;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
layout_probe_dense(const T* __restrict__ x, T* __restrict__ y, long long n) {
  constexpr int V = 16 / sizeof(T);  // elements of a uint4
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const uintptr_t xa = reinterpret_cast<uintptr_t>(x), ya = reinterpret_cast<uintptr_t>(y);
  // the scalar head: up to x's first 16-byte boundary, all of it when y's
  // offset mod 16 differs from x's (no common vector)
  const long long head =
      (xa & 15) == (ya & 15) ? min(n, (long long)(((16 - (xa & 15)) & 15) / sizeof(T))) : n;
  const long long nvec = (n - head) / V;
  for (long long e = tid; e < head; e += stride) y[e] = scale2(x[e]);
  for (long long e = head + nvec * V + tid; e < n; e += stride) y[e] = scale2(x[e]);
  const uint4* xv = reinterpret_cast<const uint4*>(x + head);
  uint4* yv = reinterpret_cast<uint4*>(y + head);
  for (long long base = tid; base < nvec; base += kProbeUnroll * stride) {
    uint4 r[kProbeUnroll];
#pragma unroll
    for (int u = 0; u < kProbeUnroll; ++u)
      if (base + u * stride < nvec) r[u] = xv[base + u * stride];
#pragma unroll
    for (int u = 0; u < kProbeUnroll; ++u)
      if (base + u * stride < nvec) yv[base + u * stride] = scale2_vec(r[u], T{});
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
layout_probe_strided(const T* __restrict__ x, T* __restrict__ y, Layout5 L, long long runs) {
  const int lane = threadIdx.x % 32;
  const long long warps = (long long)gridDim.x * blockDim.x / 32;
  for (long long r = ((long long)blockIdx.x * blockDim.x + threadIdx.x) / 32; r < runs;
       r += warps) {
    unsigned rest = (unsigned)r;  // runs < 2^31: 32-bit division
    long long xo = 0, yo = 0;
#pragma unroll
    for (int a = 3; a >= 0; --a) {
      const unsigned i = rest % (unsigned)L.d[a];
      rest /= (unsigned)L.d[a];
      xo += i * L.xs[a];
      yo += i * L.ys[a];
    }
    for (int c = lane; c < L.d[4]; c += 32) y[yo + c * L.ys[4]] = scale2(x[xo + c * L.xs[4]]);
  }
}

// blocks for `units` of work, `per_block` a block, at most a full card's
// worth of threads (a grid-stride loop covers the rest)
inline unsigned probe_grid(long long units, long long per_block) {
  int dev = 0, sms = 1;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long full = (long long)std::max(sms, 1) * kProbeBlocksPerSm;
  return (unsigned)std::min((units + per_block - 1) / per_block, full);
}

template <typename T>
cudaError_t launch_flat(const T* x, T* y, long long n, cudaStream_t stream) {
  constexpr long long per_block = (long long)kThreads * kProbeUnroll * (16 / sizeof(T));
  layout_probe_dense<T><<<probe_grid(n, per_block), kThreads, 0, stream>>>(x, y, n);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_strided(const T* x, T* y, const Layout5& L, long long n,
                           cudaStream_t stream) {
  const long long runs = n / L.d[4];  // one warp a run
  layout_probe_strided<T><<<probe_grid(runs, kThreads / 32), kThreads, 0, stream>>>(x, y, L,
                                                                                    runs);
  return cudaGetLastError();
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
  auto* s = static_cast<cudaStream_t>(stream);
  if (is_bf16) return launch_strided((const __nv_bfloat16*)x, (__nv_bfloat16*)y, L, n, s);
  return launch_strided((const float*)x, (float*)y, L, n, s);
}

}  // namespace vil

// The dense path: x and y each cover one span of n elements from their
// lowest addresses, with equal strides (any order of the axes); y = 2 x
// over the spans. Returns the launch's error.
extern "C" int layout_probe_flat(const void* x, void* y, long long n, int is_bf16,
                                 void* stream) {
  if (n <= 0 || n >= (1ll << 31)) return cudaErrorInvalidValue;
  auto* s = static_cast<cudaStream_t>(stream);
  if (is_bf16) return vil::launch_flat((const __nv_bfloat16*)x, (__nv_bfloat16*)y, n, s);
  return vil::launch_flat((const float*)x, (float*)y, n, s);
}

// The strided path. x, y: 5-D views of the logical shape d0..d4 (any
// strides, in elements); y must not overlap x. Returns the launch's error.
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
