// LayerNorm forward and backward for Hopper (sm_90a).
//
// Replaces the TPU kernels vil_tpu/ops/pallas/layer_norm.py::_ln_forward
// (Pallas body _ln_fwd_kernel) and _ln_bwd_rule (_ln_bwd_kernel). Over the
// last axis of x (rows, C), statistics in f32, γ and β in f32:
//
//   y  = (x - mean) · rsqrt(var + eps) · γ + β       rounded to x's type once
//   dx = rstd · (γ dy - mean_c(γ dy) - x̂ · mean_c(γ dy x̂)),   x̂ = (x - mean) · rstd
//   dγ = Σ_rows dy x̂,   dβ = Σ_rows dy              (f32)
//
// As in the TPU kernel, the backward recomputes the statistics from x
// instead of reading them: only (x, γ) are kept from the forward.
//
// Kernels: vil_ln_fwd (one warp per row), vil_ln_bwd_rows (one warp per
// row; each block sums dγ and dβ over its rows into one f32 partial, its
// warps added in warp order) and vil_ln_bwd_reduce (sums the partials in
// block order). No atomics: the result is the same on every run.
//
// What bounds it on an H100: bytes. A row of C values is read once (and dy
// once) and written once, with ~10 FLOPs per element: far under any ridge.
// The design keeps a row in registers (C / 32 values per lane, C ≤ 1024), so
// device memory sees each element once; the sums are warp shuffles.
#include <type_traits>

#include "attention_common.cuh"

namespace vil {

constexpr int kLnWarps = kThreads / 32;  // rows per block in flight

// The row's elements at columns lane + 32 i, as f32 (0 past C).
template <int kPer, typename T>
__device__ __forceinline__ void ln_load(float (&v)[kPer], const T* row, int C, int lane) {
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int c = lane + 32 * i;
    v[i] = c < C ? to_float(row[c]) : 0.f;
  }
}

// mean and rstd of the warp's row: mean, then the centred variance.
template <int kPer>
__device__ __forceinline__ void ln_stats(const float (&v)[kPer], int C, float eps, float& mean,
                                         float& rstd, int lane) {
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < kPer; ++i) s += v[i];
  mean = warp_sum(s) / C;
  float s2 = 0.f;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const float d = lane + 32 * i < C ? v[i] - mean : 0.f;
    s2 = fmaf(d, d, s2);
  }
  rstd = rsqrtf(warp_sum(s2) / C + eps);
}

template <typename T, int kPer>
__global__ void __launch_bounds__(kThreads)
vil_ln_fwd(const T* __restrict__ x, const float* __restrict__ gamma,
           const float* __restrict__ beta, T* __restrict__ y, int rows, int C, float eps) {
  const long row = (long)blockIdx.x * kLnWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;  // the whole warp leaves together
  float v[kPer];
  ln_load<kPer>(v, x + row * C, C, lane);
  float mean, rstd;
  ln_stats<kPer>(v, C, eps, mean, rstd, lane);
  T* yr = y + row * C;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int c = lane + 32 * i;
    if (c < C) yr[c] = from_float<T>((v[i] - mean) * rstd * gamma[c] + beta[c]);
  }
}

// Rows [blockIdx.x * rows_per_block, ...): dx of each row, and the block's
// partial of dγ (part[blockIdx.x, 0, :]) and dβ (part[blockIdx.x, 1, :]).
template <typename T, int kPer>
__global__ void __launch_bounds__(kThreads)
vil_ln_bwd_rows(const T* __restrict__ x, const float* __restrict__ gamma,
                const T* __restrict__ dy, T* __restrict__ dx, float* __restrict__ part, int rows,
                int C, float eps, int rows_per_block) {
  extern __shared__ float red[];  // 2 C: the block's dγ, dβ
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = blockIdx.x * rows_per_block, r1 = min(rows, r0 + rows_per_block);
  float dg[kPer], db[kPer], g[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int c = lane + 32 * i;
    dg[i] = db[i] = 0.f;
    g[i] = c < C ? gamma[c] : 0.f;
  }
  for (int row = r0 + warp; row < r1; row += kLnWarps) {
    float v[kPer], d[kPer];
    ln_load<kPer>(v, x + (long)row * C, C, lane);
    ln_load<kPer>(d, dy + (long)row * C, C, lane);
    float mean, rstd;
    ln_stats<kPer>(v, C, eps, mean, rstd, lane);
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const bool in = lane + 32 * i < C;
      v[i] = in ? (v[i] - mean) * rstd : 0.f;  // x̂
      const float wdy = d[i] * g[i];
      s1 += wdy;
      s2 = fmaf(wdy, v[i], s2);
      dg[i] = fmaf(d[i], v[i], dg[i]);
      db[i] += d[i];
    }
    const float c1 = warp_sum(s1) / C, c2 = warp_sum(s2) / C;
    T* dxr = dx + (long)row * C;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int c = lane + 32 * i;
      if (c < C) dxr[c] = from_float<T>(rstd * (d[i] * g[i] - c1 - v[i] * c2));
    }
  }
  for (int w = 0; w < kLnWarps; ++w) {  // warp order: deterministic
    if (warp == w) {
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const int c = lane + 32 * i;
        if (c < C) {
          red[c] = w == 0 ? dg[i] : red[c] + dg[i];
          red[C + c] = w == 0 ? db[i] : red[C + c] + db[i];
        }
      }
    }
    __syncthreads();
  }
  for (int idx = threadIdx.x; idx < 2 * C; idx += blockDim.x)
    part[(long)blockIdx.x * 2 * C + idx] = red[idx];
}

// out[i] = Σ_b part[b, i] for i < len, in block order.
__global__ void __launch_bounds__(kThreads)
vil_ln_bwd_reduce(const float* __restrict__ part, float* __restrict__ out, int blocks, int len) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= len) return;
  float sum = 0.f;
  for (int b = 0; b < blocks; ++b) sum += part[(long)b * len + i];
  out[i] = sum;
}

// f(std::integral_constant<int, kPer>{}) for the smallest compiled kPer with
// 32 kPer ≥ C; cudaErrorInvalidValue above C = 1024.
template <typename F>
cudaError_t dispatch_per_lane(int C, F&& f) {
  const int need = (C + 31) / 32;
  if (need <= 2) return f(std::integral_constant<int, 2>{});
  if (need <= 3) return f(std::integral_constant<int, 3>{});
  if (need <= 4) return f(std::integral_constant<int, 4>{});
  if (need <= 6) return f(std::integral_constant<int, 6>{});
  if (need <= 8) return f(std::integral_constant<int, 8>{});
  if (need <= 12) return f(std::integral_constant<int, 12>{});
  if (need <= 16) return f(std::integral_constant<int, 16>{});
  if (need <= 24) return f(std::integral_constant<int, 24>{});
  if (need <= 32) return f(std::integral_constant<int, 32>{});
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t launch_ln_fwd(const void* x, const float* gamma, const float* beta, void* y,
                          int rows, int C, float eps, cudaStream_t stream) {
  return dispatch_per_lane(C, [&](auto per) {
    constexpr int kPer = decltype(per)::value;
    return launch(vil_ln_fwd<T, kPer>, dim3((rows + kLnWarps - 1) / kLnWarps), 0, stream,
                  (const T*)x, gamma, beta, (T*)y, rows, C, eps);
  });
}

template <typename T>
cudaError_t launch_ln_bwd(const void* x, const float* gamma, const void* dy, void* dx,
                          float* part, float* out, int rows, int C, float eps, int blocks,
                          int rows_per_block, cudaStream_t stream) {
  cudaError_t err = dispatch_per_lane(C, [&](auto per) {
    constexpr int kPer = decltype(per)::value;
    return launch(vil_ln_bwd_rows<T, kPer>, dim3(blocks), sizeof(float) * 2 * C, stream,
                  (const T*)x, gamma, (const T*)dy, (T*)dx, part, rows, C, eps, rows_per_block);
  });
  if (err != cudaSuccess) return err;
  return launch(vil_ln_bwd_reduce, dim3((2 * C + kThreads - 1) / kThreads), 0, stream,
                (const float*)part, out, blocks, 2 * C);
}

}  // namespace vil

// x, y (rows, C) contiguous; gamma, beta (C) f32. Returns the launch's error.
extern "C" int layer_norm_fwd(const void* x, const void* gamma, const void* beta, void* y,
                              int rows, int C, float eps, int is_bf16, void* stream) {
  auto* s = static_cast<cudaStream_t>(stream);
  auto* g = static_cast<const float*>(gamma);
  auto* b = static_cast<const float*>(beta);
  if (is_bf16) return vil::launch_ln_fwd<__nv_bfloat16>(x, g, b, y, rows, C, eps, s);
  return vil::launch_ln_fwd<float>(x, g, b, y, rows, C, eps, s);
}

// x, dy, dx (rows, C) contiguous; gamma (C) f32; part (blocks, 2, C) f32
// scratch; out (2, C) f32: dγ, then dβ. Block b takes rows
// [b rows_per_block, (b + 1) rows_per_block). Returns the first launch error.
extern "C" int layer_norm_bwd(const void* x, const void* gamma, const void* dy, void* dx,
                              void* part, void* out, int rows, int C, float eps, int blocks,
                              int rows_per_block, int is_bf16, void* stream) {
  auto* s = static_cast<cudaStream_t>(stream);
  auto* g = static_cast<const float*>(gamma);
  auto* p = static_cast<float*>(part);
  auto* o = static_cast<float*>(out);
  if (is_bf16)
    return vil::launch_ln_bwd<__nv_bfloat16>(x, g, dy, dx, p, o, rows, C, eps, blocks,
                                             rows_per_block, s);
  return vil::launch_ln_bwd<float>(x, g, dy, dx, p, o, rows, C, eps, blocks, rows_per_block, s);
}
