// Device helpers shared by the attention kernels of this directory.
//
// Both kernels are one thread block of kThreads threads per output tile. A
// query row belongs to one warp for the whole kernel. Keys are staged in
// shared memory one tile at a time and folded into each row with an online
// (running-max) softmax in f32, so no score matrix is ever stored, in shared
// memory or in device memory, whatever the number of keys.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace vil {

constexpr int kThreads = 256;  // 8 warps: measured faster than 4 on the H100 (PERF.md)
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFullMask, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFullMask, x, o);
  return x;
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Copy `rows` rows of M elements, `stride` elements apart in global memory,
// into shared memory as f32 with row stride `ld`. The whole block takes part;
// neighbouring threads read neighbouring elements of a row.
template <int M, typename T>
__device__ __forceinline__ void load_rows(float* dst, int ld, const T* src, long stride,
                                          int rows) {
  for (int idx = threadIdx.x; idx < rows * M; idx += blockDim.x) {
    const int r = idx / M, d = idx % M;
    dst[r * ld + d] = to_float(src[r * stride + d]);
  }
}

// Online-softmax state of one query row. m (running max) and l (running sum)
// are the same in every lane; lane holds output dims lane + 32 * i.
template <int M>
struct RowState {
  static constexpr int kDims = (M + 31) / 32;
  float m, l, acc[kDims];
};

// Load / store a row's state kept in shared memory between key tiles.
template <int M>
__device__ __forceinline__ void load_state(RowState<M>& st, const float* m_s, const float* l_s,
                                           const float* acc_s, int r, int lane) {
  st.m = m_s[r];
  st.l = l_s[r];
#pragma unroll
  for (int i = 0; i < RowState<M>::kDims; ++i) {
    const int d = lane + 32 * i;
    st.acc[i] = (M % 32 == 0 || d < M) ? acc_s[r * M + d] : 0.f;
  }
}

template <int M>
__device__ __forceinline__ void store_state(const RowState<M>& st, float* m_s, float* l_s,
                                            float* acc_s, int r, int lane) {
  if (lane == 0) {
    m_s[r] = st.m;
    l_s[r] = st.l;
  }
#pragma unroll
  for (int i = 0; i < RowState<M>::kDims; ++i) {
    const int d = lane + 32 * i;
    if (M % 32 == 0 || d < M) acc_s[r * M + d] = st.acc[i];
  }
}

// Fold keys [0, nkeys) of the staged tile into one query row; called by all
// 32 lanes of the warp that owns the row. Lane j scores keys j, j + 32, ...
//   q      the query row in shared memory (M floats, read by all lanes at once)
//   ks     K tile in shared memory, row stride M + 1 (the pad puts lane j's
//          key row in bank j + d, so the score loop has no bank conflicts)
//   vs     V tile in shared memory, row stride M
//   add0/1 additive score terms for the tile's keys (bias, then mask, the
//          reference's order of addition), in global memory, or nullptr
// Masked keys carry a large finite negative term, never -inf, so a row whose
// keys are all masked stays finite, as in the reference.
template <int M>
__device__ __forceinline__ void fold_keys(RowState<M>& st, const float* q, const float* ks,
                                          const float* vs, int nkeys, const float* add0,
                                          const float* add1, int lane) {
  for (int t0 = 0; t0 < nkeys; t0 += 32) {
    const int key = t0 + lane;
    const bool valid = key < nkeys;
    float s = -INFINITY;
    if (valid) {
      const float* kr = ks + key * (M + 1);
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < M; ++d) dot = fmaf(q[d], kr[d], dot);
      if (add0 != nullptr) dot += add0[key];
      if (add1 != nullptr) dot += add1[key];
      s = dot;
    }
    const float m_new = fmaxf(st.m, warp_max(s));
    const float alpha = expf(st.m - m_new);  // 0 on the first tile (m = -inf)
    const float p = valid ? expf(s - m_new) : 0.f;
    st.l = st.l * alpha + warp_sum(p);
#pragma unroll
    for (int i = 0; i < RowState<M>::kDims; ++i) st.acc[i] *= alpha;
    const int n = min(32, nkeys - t0);
    for (int j = 0; j < n; ++j) {
      const float pj = __shfl_sync(kFullMask, p, j);
      const float* vr = vs + (t0 + j) * M;
#pragma unroll
      for (int i = 0; i < RowState<M>::kDims; ++i) {
        const int d = lane + 32 * i;
        if (M % 32 == 0 || d < M) st.acc[i] = fmaf(pj, vr[d], st.acc[i]);
      }
    }
    st.m = m_new;
  }
}

// out[d] = acc[d] / l for one row, written by the lanes of its warp.
template <int M, typename T>
__device__ __forceinline__ void store_row(T* dst, const float* acc_s, const float* l_s, int r,
                                          int lane) {
  const float inv = 1.f / l_s[r];
  for (int d = lane; d < M; d += 32) dst[d] = from_float<T>(acc_s[r * M + d] * inv);
}

// ---------------------------------------------------------------------------
// Backward helpers. The backward kernels recompute each score exactly as the
// forward formed it: the same fmaf chain over d = 0..M-1, then bias, then
// mask. So P = exp(S - lse) uses the very S whose log-sum-exp the forward
// stored.

// a · b over M elements, in the forward's order of summation.
template <int M>
__device__ __forceinline__ float dot_m(const float* a, const float* b) {
  float acc = 0.f;
#pragma unroll
  for (int d = 0; d < M; ++d) acc = fmaf(a[d], b[d], acc);
  return acc;
}

// Per-lane slice (dims lane + 32 i) of an M-vector kept in shared memory.
template <int M>
struct LaneVec {
  static constexpr int kDims = (M + 31) / 32;
  float v[kDims];
  __device__ __forceinline__ void load(const float* src, int lane) {
#pragma unroll
    for (int i = 0; i < kDims; ++i) {
      const int d = lane + 32 * i;
      v[i] = (M % 32 == 0 || d < M) ? src[d] : 0.f;
    }
  }
  __device__ __forceinline__ void store(float* dst, int lane) const {
#pragma unroll
    for (int i = 0; i < kDims; ++i) {
      const int d = lane + 32 * i;
      if (M % 32 == 0 || d < M) dst[d] = v[i];
    }
  }
  // v += w * row (row in shared memory, M floats)
  __device__ __forceinline__ void fma(float w, const float* row, int lane) {
#pragma unroll
    for (int i = 0; i < kDims; ++i) {
      const int d = lane + 32 * i;
      if (M % 32 == 0 || d < M) v[i] = fmaf(w, row[d], v[i]);
    }
  }
};

// Row-wise pass over keys [0, nkeys) of a staged K/V tile (both with row
// stride M + 1) for one query row; lane j takes keys j, j + 32, ...
//   q, g       the query row and its upstream gradient (M floats each)
//   add0/1     score terms per key (bias, mask) or nullptr
//   lse        the row's log-sum-exp from the forward
// Returns rowsum(P ∘ dP) over the tile, in every lane.
template <int M>
__device__ __forceinline__ float row_delta(const float* q, const float* g, const float* ks,
                                           const float* vs, int nkeys, const float* add0,
                                           const float* add1, float lse, int lane) {
  float part = 0.f;
  for (int key = lane; key < nkeys; key += 32) {
    float s = dot_m<M>(q, ks + key * (M + 1));
    if (add0 != nullptr) s += add0[key];
    if (add1 != nullptr) s += add1[key];
    part = fmaf(expf(s - lse), dot_m<M>(g, vs + key * (M + 1)), part);
  }
  return warp_sum(part);
}

// The same pass, second sweep: dS = P ∘ (dP - delta) per key, folded into
// dq += dS · K (lane holds dims lane + 32 i). Optional outputs, indexed by
// key: p_out and ds_out receive P and dS, db accumulates dS (or, with
// db_add false, receives it).
template <int M>
__device__ __forceinline__ void row_dq(LaneVec<M>& dq, const float* q, const float* g,
                                       const float* ks, const float* vs, int nkeys,
                                       const float* add0, const float* add1, float lse,
                                       float delta, float* p_out, float* ds_out, float* db,
                                       int lane, bool db_add = true) {
  for (int t0 = 0; t0 < nkeys; t0 += 32) {
    const int key = t0 + lane;
    float ds = 0.f;
    if (key < nkeys) {
      float s = dot_m<M>(q, ks + key * (M + 1));
      if (add0 != nullptr) s += add0[key];
      if (add1 != nullptr) s += add1[key];
      const float p = expf(s - lse);
      ds = p * (dot_m<M>(g, vs + key * (M + 1)) - delta);
      if (p_out != nullptr) {
        p_out[key] = p;
        ds_out[key] = ds;
      }
      if (db != nullptr) db[key] = db_add ? db[key] + ds : ds;
    }
    const int n = min(32, nkeys - t0);
    for (int j = 0; j < n; ++j)
      dq.fma(__shfl_sync(kFullMask, ds, j), ks + (t0 + j) * (M + 1), lane);
  }
}

// Column-wise pass for one key row (k_t, v_t: M floats in shared memory)
// over nq staged query rows (q_s, g_s with row stride M + 1; lse_s, delta_s
// per row); lane j takes query rows j, j + 32, ... Accumulates
// dk += dSᵀ · q and dv += Pᵀ · g. add0/add1 point at this key's score term
// of query row 0; row l's is add[l * stride].
template <int M>
__device__ __forceinline__ void col_dkdv(LaneVec<M>& dk, LaneVec<M>& dv, const float* k_t,
                                         const float* v_t, const float* q_s, const float* g_s,
                                         const float* lse_s, const float* delta_s, int nq,
                                         const float* add0, long stride0, const float* add1,
                                         long stride1, int lane) {
  for (int l0 = 0; l0 < nq; l0 += 32) {
    const int l = l0 + lane;
    float p = 0.f, ds = 0.f;
    if (l < nq) {
      float s = dot_m<M>(q_s + l * (M + 1), k_t);
      if (add0 != nullptr) s += add0[l * stride0];
      if (add1 != nullptr) s += add1[l * stride1];
      p = expf(s - lse_s[l]);
      ds = p * (dot_m<M>(g_s + l * (M + 1), v_t) - delta_s[l]);
    }
    const int n = min(32, nq - l0);
    for (int j = 0; j < n; ++j) {
      const int row = (l0 + j) * (M + 1);
      dk.fma(__shfl_sync(kFullMask, ds, j), q_s + row, lane);
      dv.fma(__shfl_sync(kFullMask, p, j), g_s + row, lane);
    }
  }
}

// Write rows [0, rows) of an M-wide f32 tile in shared memory to global
// memory as T, `stride` elements apart.
template <int M, typename T>
__device__ __forceinline__ void store_rows(T* dst, long stride, const float* src, int rows) {
  for (int idx = threadIdx.x; idx < rows * M; idx += blockDim.x) {
    const int r = idx / M, d = idx % M;
    dst[r * stride + d] = from_float<T>(src[idx]);
  }
}

// Set the kernel's dynamic shared memory limit (needed above 48 KB) and
// launch `threads` threads a block; returns the launch's error.
template <typename Kernel, typename... Args>
cudaError_t launch_with(Kernel kernel, dim3 grid, int threads, size_t smem, cudaStream_t stream,
                        Args... args) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, stream>>>(args...);
  return cudaGetLastError();
}

template <typename Kernel, typename... Args>
cudaError_t launch(Kernel kernel, dim3 grid, size_t smem, cudaStream_t stream, Args... args) {
  return launch_with(kernel, grid, kThreads, smem, stream, args...);
}

}  // namespace vil
