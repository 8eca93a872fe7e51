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
// Kernels: vil_ln_fwd (one warp per row), vil_ln_bwd_rows (dx, and one f32
// partial of dγ and dβ per block) and vil_ln_bwd_reduce (the partials
// summed). No atomics: the result is the same on every run.
//
// What bounds it on an H100: bytes. A row of C values is read once (and dy
// once) and written once, with ~10 FLOPs per element: far under any ridge.
// The forward keeps a row in one warp's registers (C / 32 values per lane,
// C ≤ 1024), so device memory sees each element once; the sums are warp
// shuffles.
//
// What the backward's design does about it (B8b, the fused training step's
// 30 launches at C = 96-768; rows up to 200704):
//   - Loads and stores of 16 bytes a thread (8 bf16) when C % 8 == 0 in
//     bf16 and the rows start on 16-byte boundaries: a row over L lanes, each
//     lane V vectors of 8 values, so a warp holds 32 / L rows. A row of
//     3 · 2^k vectors (ViL's C = 96, 192, 384, 768) takes V = 3 and L = C /
//     24 lanes (4 at C = 96: 8 rows a warp), no lane idle; other widths the
//     power of two L ≥ C / 8, at most 32, and V = 1-4. The per-row sums are
//     butterflies over the row's L lanes. The rows come through a ring in
//     shared memory, by cp.async, kLnStages - 1 iterations ahead (8 stages
//     at one vector a lane, 4 beyond; at ViL's widths 96 KB a block, 144 KB
//     of loads in flight an SM), without a register held for them. Otherwise (f32, the parity checks'
//     type, C % 8 != 0 or a row off 16 bytes) one value a lane, a row over
//     the warp, loaded straight into registers.
//   - dγ and dβ: each block sums its rows' contributions in its lanes'
//     registers, adds the warp's row groups by butterflies and the warps by
//     a tree in shared memory, and writes one partial. The wrapper sizes the
//     grid to 2 blocks an SM (264 partials; at most 128 registers a thread,
//     and at most 99 KB of shared memory a block at ViL's widths), each over
//     one span of rows, so every block is resident at once and the partials
//     are few.
//   - vil_ln_bwd_reduce sums the partials over columns and partials in
//     parallel: a block per 32 columns, its 32 warps each over every 32nd
//     partial, then the warps' sums in warp order.
//   Every sum runs in an order fixed by the indices alone.
#include <stdint.h>

#include <type_traits>

#include "attention_common.cuh"
#include "tensor_core.cuh"

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

// VEC consecutive values of a row at p, as f32: 16 bytes at once for 8 bf16.
template <int VEC, typename T>
__device__ __forceinline__ void ln_load_vec(float (&v)[VEC], const T* p) {
  if constexpr (VEC == 8) {
    static_assert(std::is_same_v<T, __nv_bfloat16>, "16-byte vectors hold 8 bf16");
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = __bfloat1622float2(h[e]);
      v[2 * e] = f.x;
      v[2 * e + 1] = f.y;
    }
  } else {
#pragma unroll
    for (int e = 0; e < VEC; ++e) v[e] = to_float(p[e]);
  }
}

template <int VEC, typename T>
__device__ __forceinline__ void ln_store_vec(T* p, const float (&v)[VEC]) {
  if constexpr (VEC == 8) {
    uint4 u;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int e = 0; e < 4; ++e) h[e] = __floats2bfloat162_rn(v[2 * e], v[2 * e + 1]);
    *reinterpret_cast<uint4*>(p) = u;
  } else {
#pragma unroll
    for (int e = 0; e < VEC; ++e) p[e] = from_float<T>(v[e]);
  }
}

// Σ of x over the L lanes of a row (a butterfly: every lane gets the same
// bits). Every lane of the warp calls it.
template <int L>
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = L / 2; o > 0; o /= 2) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Stages of a warp's ring of rows (the 16-byte path): 8 while a row group's
// rows are short (one vector a lane), 4 beyond.
template <int V>
constexpr int kLnStages = V == 1 ? 8 : 4;

// Dynamic shared memory of vil_ln_bwd_rows: γ (C f32), then on the 16-byte
// path every warp's ring of kLnStages stages of its G rows of x and dy in T,
// which the warps' tree of dγ, dβ ((kLnWarps / 2) 2C f32) reuses at the end.
template <typename T, int VEC, int L, int V>
constexpr size_t ln_bwd_smem_bytes(int C) {
  const size_t tree = sizeof(float) * (kLnWarps / 2) * 2 * C;
  const size_t ring = VEC == 8 ? sizeof(T) * kLnWarps * kLnStages<V> * (32 / L) * 2 * C : 0;
  return sizeof(float) * C + (ring > tree ? ring : tree);
}

// Rows [blockIdx.x * rows_per_block, ...) of the block: dx of each row, and
// the block's partial of dγ (part[blockIdx.x, 0, :]) and dβ (part[blockIdx.x,
// 1, :]). A row lies over L lanes (a row group), lane s of it holding the
// VEC values from column VEC (s + L i), i < V; at iteration t warp w takes
// the G rows from r0 + (t kLnWarps + w) G. On the 16-byte path each lane
// copies its own vectors of the rows kLnStages - 1 iterations ahead into its
// warp's ring by cp.async (zero-filled past the rows) and reads back only
// what it copied itself, so no barrier orders the ring. Shared memory:
// ln_bwd_smem_bytes. At most 128 registers a thread, so that two blocks fit
// an SM (the wrapper's grid).
template <typename T, int VEC, int L, int V>
__global__ void __launch_bounds__(kThreads, 2)
vil_ln_bwd_rows(const T* __restrict__ x, const float* __restrict__ gamma,
                const T* __restrict__ dy, T* __restrict__ dx, float* __restrict__ part, int rows,
                int C, float eps, int rows_per_block) {
  constexpr int G = 32 / L;              // row groups of a warp
  constexpr int kGroups = kLnWarps * G;  // of the block
  constexpr int S = kLnStages<V>;
  extern __shared__ __align__(16) unsigned char ln_smem[];
  float* g_s = reinterpret_cast<float*>(ln_smem);
  float* red = g_s + C;  // the tree, over the ring once the rows are done
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int sub = lane % L, group = lane / L;
  const int r0 = blockIdx.x * rows_per_block, r1 = min(rows, r0 + rows_per_block);
  const int iters = (r1 - r0 + kGroups - 1) / kGroups;  // the same for every warp
  // this lane's row of iteration t, and its stage in the ring
  auto row_of = [&](int t) { return r0 + (t * kLnWarps + warp) * G + group; };
  T* ring = reinterpret_cast<T*>(red) + (long)warp * S * G * 2 * C;
  auto stage_of = [&](int t) { return ring + ((t % S) * G + group) * 2 * C; };
  auto copy_rows = [&](int t) {  // this lane's vectors of x and dy at iteration t
    const int row = row_of(t);
    T* dst = stage_of(t);
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const int col = VEC * (sub + L * i);
      if (col >= C) continue;
      const bool ok = row < r1;
      const long at = ok ? (long)row * C + col : 0;
      cp_async16(smem_u32(dst + col), x + at, ok ? 16 : 0);
      cp_async16(smem_u32(dst + C + col), dy + at, ok ? 16 : 0);
    }
  };
  for (int c = threadIdx.x; c < C; c += blockDim.x) g_s[c] = gamma[c];
  if constexpr (VEC == 8) {
#pragma unroll
    for (int t = 0; t < S - 1; ++t) {
      if (t < iters) copy_rows(t);
      cp_async_commit();
    }
  }
  __syncthreads();  // γ
  bool in[V];
  float dg[V][VEC], db[V][VEC];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    in[i] = VEC * (sub + L * i) < C;
#pragma unroll
    for (int e = 0; e < VEC; ++e) dg[i][e] = db[i][e] = 0.f;
  }
  for (int t = 0; t < iters; ++t) {
    const int row = row_of(t);
    float xv[V][VEC], dv[V][VEC];
    if constexpr (VEC == 8) {
      cp_async_wait<S - 2>();  // iteration t's copies of this lane have landed
      const T* src = stage_of(t);
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const int col = VEC * (sub + L * i);
        if (in[i]) {
          ln_load_vec<VEC>(xv[i], src + col);
          ln_load_vec<VEC>(dv[i], src + C + col);
        } else {
#pragma unroll
          for (int e = 0; e < VEC; ++e) xv[i][e] = dv[i][e] = 0.f;
        }
      }
      if (t + S - 1 < iters) copy_rows(t + S - 1);  // into the stage read at t - 1
      cp_async_commit();
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const int col = VEC * (sub + L * i);
        if (row < r1 && in[i]) {
          ln_load_vec<VEC>(xv[i], x + (long)row * C + col);
          ln_load_vec<VEC>(dv[i], dy + (long)row * C + col);
        } else {
#pragma unroll
          for (int e = 0; e < VEC; ++e) xv[i][e] = dv[i][e] = 0.f;
        }
      }
    }
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < V; ++i)
#pragma unroll
      for (int e = 0; e < VEC; ++e) s += xv[i][e];
    const float mean = row_sum<L>(s) / C;
    float s2 = 0.f;
#pragma unroll
    for (int i = 0; i < V; ++i)
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float d = in[i] ? xv[i][e] - mean : 0.f;
        s2 = fmaf(d, d, s2);
      }
    const float rstd = rsqrtf(row_sum<L>(s2) / C + eps);
    float s1 = 0.f, s3 = 0.f;
#pragma unroll
    for (int i = 0; i < V; ++i)
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float xh = in[i] ? (xv[i][e] - mean) * rstd : 0.f;  // x̂
        const float d = dv[i][e];
        const float wdy = in[i] ? d * g_s[VEC * (sub + L * i) + e] : 0.f;
        xv[i][e] = xh;
        dv[i][e] = wdy;
        s1 += wdy;
        s3 = fmaf(wdy, xh, s3);
        dg[i][e] = fmaf(d, xh, dg[i][e]);  // d is 0 past the rows
        db[i][e] += d;
      }
    const float c1 = row_sum<L>(s1) / C, c2 = row_sum<L>(s3) / C;
    if (row < r1) {
#pragma unroll
      for (int i = 0; i < V; ++i) {
        if (!in[i]) continue;
        float o[VEC];
#pragma unroll
        for (int e = 0; e < VEC; ++e) o[e] = rstd * (dv[i][e] - c1 - xv[i][e] * c2);
        ln_store_vec<VEC>(dx + (long)row * C + VEC * (sub + L * i), o);
      }
    }
  }
  if constexpr (VEC == 8) cp_async_wait<0>();  // the empty groups
  __syncthreads();  // every warp is done with its ring: the tree reuses it
  // the warp's row groups, then the warps by a tree: each sum in a fixed order
#pragma unroll
  for (int o = L; o < 32; o *= 2)
#pragma unroll
    for (int i = 0; i < V; ++i)
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        dg[i][e] += __shfl_xor_sync(0xffffffffu, dg[i][e], o);
        db[i][e] += __shfl_xor_sync(0xffffffffu, db[i][e], o);
      }
  const bool owner = lane < L;  // the warp's first row group holds its sums
#pragma unroll
  for (int half = kLnWarps / 2; half > 0; half /= 2) {
    if (owner && warp >= half && warp < 2 * half) {
      float* slot = red + (warp - half) * 2 * C;
#pragma unroll
      for (int i = 0; i < V; ++i)
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          if (in[i]) {
            const int col = VEC * (sub + L * i) + e;
            slot[col] = dg[i][e];
            slot[C + col] = db[i][e];
          }
    }
    __syncthreads();
    if (owner && warp < half) {
      const float* slot = red + warp * 2 * C;
#pragma unroll
      for (int i = 0; i < V; ++i)
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          if (in[i]) {
            const int col = VEC * (sub + L * i) + e;
            dg[i][e] += slot[col];
            db[i][e] += slot[C + col];
          }
    }
    __syncthreads();
  }
  if (owner && warp == 0) {
    float* out = part + (long)blockIdx.x * 2 * C;
#pragma unroll
    for (int i = 0; i < V; ++i)
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        if (in[i]) {
          const int col = VEC * (sub + L * i) + e;
          out[col] = dg[i][e];
          out[C + col] = db[i][e];
        }
  }
}

constexpr int kLnReduceWarps = 32;  // threads of vil_ln_bwd_reduce: 32 per warp

// out[i] = Σ_b part[b, i] for i < len: block x over the 32 columns from 32 x,
// warp w over partials w, w + 32, ... in order, then the warps' sums in warp
// order.
__global__ void __launch_bounds__(32 * kLnReduceWarps)
vil_ln_bwd_reduce(const float* __restrict__ part, float* __restrict__ out, int blocks, int len) {
  __shared__ float sums[kLnReduceWarps][33];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int i = blockIdx.x * 32 + lane;
  float sum = 0.f;
  if (i < len)
    for (int b = warp; b < blocks; b += kLnReduceWarps) sum += part[(long)b * len + i];
  sums[warp][lane] = sum;
  __syncthreads();
  if (warp == 0 && i < len) {
    float total = 0.f;
#pragma unroll
    for (int w = 0; w < kLnReduceWarps; ++w) total += sums[w][lane];
    out[i] = total;
  }
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

// f(VEC, L, V) as integral constants for the backward's row layout (the
// note above vil_ln_bwd_rows): 16-byte vectors when T is bf16, C % 8 == 0
// and the rows start on 16-byte boundaries (`aligned`), else one value a
// lane over the whole warp; cudaErrorInvalidValue above C = 1024.
template <typename T, typename F>
cudaError_t dispatch_ln_bwd(int C, bool aligned, F&& f) {
  using std::integral_constant;
  auto scalar = [&] {
    return dispatch_per_lane(C, [&](auto per) {
      return f(integral_constant<int, 1>{}, integral_constant<int, 32>{}, per);
    });
  };
  if constexpr (!std::is_same_v<T, __nv_bfloat16>) {
    return scalar();
  } else {
    if (C % 8 != 0 || !aligned) return scalar();
    using Vec = integral_constant<int, 8>;
    using One = integral_constant<int, 1>;
    using Three = integral_constant<int, 3>;
    const int nv = C / 8;  // vectors of a row
    // 3 · 2^k vectors (C = 96, 192, 384, 768 at ViL's widths): three a lane,
    // no lane idle, 32 / L rows a warp
    switch (nv) {
      case 3: return f(Vec{}, One{}, Three{});
      case 6: return f(Vec{}, integral_constant<int, 2>{}, Three{});
      case 12: return f(Vec{}, integral_constant<int, 4>{}, Three{});
      case 24: return f(Vec{}, integral_constant<int, 8>{}, Three{});
      case 48: return f(Vec{}, integral_constant<int, 16>{}, Three{});
      case 96: return f(Vec{}, integral_constant<int, 32>{}, Three{});
      default: break;
    }
    if (nv <= 1) return f(Vec{}, One{}, One{});
    if (nv <= 2) return f(Vec{}, integral_constant<int, 2>{}, One{});
    if (nv <= 4) return f(Vec{}, integral_constant<int, 4>{}, One{});
    if (nv <= 8) return f(Vec{}, integral_constant<int, 8>{}, One{});
    if (nv <= 16) return f(Vec{}, integral_constant<int, 16>{}, One{});
    using L = integral_constant<int, 32>;
    if (nv <= 32) return f(Vec{}, L{}, One{});
    if (nv <= 64) return f(Vec{}, L{}, integral_constant<int, 2>{});
    if (nv <= 96) return f(Vec{}, L{}, integral_constant<int, 3>{});
    if (nv <= 128) return f(Vec{}, L{}, integral_constant<int, 4>{});
    return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch_ln_bwd(const void* x, const float* gamma, const void* dy, void* dx,
                          float* part, float* out, int rows, int C, float eps, int blocks,
                          int rows_per_block, cudaStream_t stream) {
  const bool aligned = (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(dy) |
                        reinterpret_cast<uintptr_t>(dx)) % 16 == 0;
  cudaError_t err = dispatch_ln_bwd<T>(C, aligned, [&](auto vec, auto lanes, auto per) {
    constexpr int VEC = decltype(vec)::value, L = decltype(lanes)::value;
    constexpr int V = decltype(per)::value;
    return launch(vil_ln_bwd_rows<T, VEC, L, V>, dim3(blocks),
                  ln_bwd_smem_bytes<T, VEC, L, V>(C), stream, (const T*)x, gamma, (const T*)dy,
                  (T*)dx, part, rows, C, eps, rows_per_block);
  });
  if (err != cudaSuccess) return err;
  return launch_with(vil_ln_bwd_reduce, dim3((2 * C + 31) / 32), 32 * kLnReduceWarps, 0, stream,
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
