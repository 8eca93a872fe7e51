// Tiled matrix products on the CUDA cores with f32 accumulation: the
// projections and weight gradients of the fused attention block
// (vil_block_fwd.cu, vil_block_bwd.cu), which the TPU kernel computes in its
// own body (vil_tpu/ops/pallas/vil_block.py _mm_rows, _project_rows and the
// dW dot_generals).
//
// One block of kThreads (256) threads computes a kTileM x kTileN (64 x 64)
// tile of the output: thread (ty, tx) of a 16 x 16 arrangement holds the
// 4 x 4 outputs at rows ty + 16 i and columns tx + 16 j in registers, so its
// shared-memory reads are broadcasts (A) and 16 consecutive words (B), and
// its stores are coalesced. The reduction dimension is walked kTileK (16)
// at a time; each step stages an A and a B tile in shared memory as f32.
// Every bound is checked, so any R, N and K are taken.
//
// Three forms, all operands row-major:
//   gemm_nn   Y (R, N) = A (R, K) · B (K, N) + bias (N)      rounded to T
//   gemm_nt   Y (R, N) = Σ_s A_s (R, K) · B_s (N, K)ᵀ        rounded to T
//   gemm_tn   P (Ka, N) = A (rows r0..r1, Ka)ᵀ · B (rows r0..r1, N)   f32
// gemm_tn reduces over a slice of rows; the caller writes one partial per
// slice and sums the partials in a second pass, in a fixed order: no
// atomics, the same result on every run.
//
// What bounds them on an H100: at ViL-Small's widths (C = 96, 192) a
// projection is 2 R C² FLOPs over 2 R C + C² elements, C/2 = 48-96 FLOP per
// element, far above the CUDA cores' f32 ridge (~20 FLOP/B), so they are
// bound by f32 FMA issue. Moving them to mma.sync/wgmma is the next step.
#pragma once

#include "attention_common.cuh"

namespace vil {

constexpr int kTileM = 64, kTileN = 64, kTileK = 16;

// One operand of a product, addressed as element (r, k) for r in
// [0, rows), k the reduction index: p[r * ld + k] when kKContig, else
// p[k * ld + r] (the operand is stored transposed).
template <typename T, bool kKContig>
struct Operand {
  const T* p;
  long ld;
  int rows;
  __device__ __forceinline__ float at(int r, int k) const {
    return to_float(kKContig ? p[(long)r * ld + k] : p[(long)k * ld + r]);
  }
};

// Stage rows [r0, r0 + kRows) and reduction indices [k0, k0 + kTileK) of an
// operand into s[kk][rr] as f32, zero outside the operand or past k_end.
// Neighbouring threads read neighbouring addresses along the contiguous index.
template <int kRows, typename Op>
__device__ __forceinline__ void stage_tile(float (*s)[kRows + 4], const Op& op, int r0, int k0,
                                           int k_end, bool k_contig) {
  for (int idx = threadIdx.x; idx < kRows * kTileK; idx += blockDim.x) {
    const int kk = k_contig ? idx % kTileK : idx / kRows;
    const int rr = k_contig ? idx / kTileK : idx % kRows;
    const int r = r0 + rr, k = k0 + kk;
    s[kk][rr] = (r < op.rows && k < k_end) ? op.at(r, k) : 0.f;
  }
}

// acc += A[m0.., k] · B[n0.., k] over k in [k_begin, k_end): the 64 x 64
// output tile at (m0, n0), this thread's 4 x 4 share in acc.
template <typename TA, bool kA, typename TB, bool kB>
__device__ __forceinline__ void gemm_tile(float (&acc)[4][4], const Operand<TA, kA>& a,
                                          const Operand<TB, kB>& b, int m0, int n0, int k_begin,
                                          int k_end) {
  __shared__ float a_s[kTileK][kTileM + 4];
  __shared__ float b_s[kTileK][kTileN + 4];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  for (int k0 = k_begin; k0 < k_end; k0 += kTileK) {
    __syncthreads();  // the previous step's tiles are consumed
    stage_tile<kTileM>(a_s, a, m0, k0, k_end, kA);
    stage_tile<kTileN>(b_s, b, n0, k0, k_end, kB);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kTileK; ++kk) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = a_s[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = b_s[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }
}

// Write this thread's share of the tile at (m0, n0) of a (R, N) row-major
// output: f(acc, n) for every element inside the output.
template <typename T, typename F>
__device__ __forceinline__ void store_tile(T* y, long ld, int R, int N, int m0, int n0,
                                           const float (&acc)[4][4], F f) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= R) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n < N) y[(long)m * ld + n] = f(acc[i][j], n);
    }
  }
}

// Y = A · B + bias, one 64 x 64 tile per block at (blockIdx.x, blockIdx.y);
// bias (N) f32 or null. The sum is rounded to T once.
template <typename T>
__device__ __forceinline__ void gemm_nn(const T* __restrict__ a, const T* __restrict__ b,
                                        const float* __restrict__ bias, T* __restrict__ y, int R,
                                        int K, int N) {
  const int m0 = blockIdx.x * kTileM, n0 = blockIdx.y * kTileN;
  float acc[4][4] = {};
  gemm_tile(acc, Operand<T, true>{a, K, R}, Operand<T, false>{b, N, N}, m0, n0, 0, K);
  store_tile(y, N, R, N, m0, n0, acc, [&](float s, int n) {
    return from_float<T>(bias != nullptr ? s + bias[n] : s);
  });
}

// Y = Σ_s A_s · B_s^T over n_seg segments, each A_s (R, K) and B_s (N, K);
// the f32 sum is rounded to T once.
template <typename T>
struct NtSegments {
  const T* a[3];
  const T* b[3];
  int n;
};

template <typename T>
__device__ __forceinline__ void gemm_nt(const NtSegments<T>& seg, T* __restrict__ y, int R,
                                        int K, int N) {
  const int m0 = blockIdx.x * kTileM, n0 = blockIdx.y * kTileN;
  float acc[4][4] = {};
  for (int s = 0; s < seg.n; ++s)
    gemm_tile(acc, Operand<T, true>{seg.a[s], K, R}, Operand<T, true>{seg.b[s], K, N}, m0, n0,
              0, K);
  store_tile(y, N, R, N, m0, n0, acc, [](float s, int) { return from_float<T>(s); });
}

// P = A[r0:r1]^T · B[r0:r1] in f32 for A (R, Ka) and B (R, N): the output
// tile at (blockIdx.x, blockIdx.y), written to the partial p (Ka, N).
template <typename T>
__device__ __forceinline__ void gemm_tn(const T* __restrict__ a, const T* __restrict__ b,
                                        float* __restrict__ p, int Ka, int N, int r0, int r1) {
  const int m0 = blockIdx.x * kTileM, n0 = blockIdx.y * kTileN;
  float acc[4][4] = {};
  gemm_tile(acc, Operand<T, false>{a, Ka, Ka}, Operand<T, false>{b, N, N}, m0, n0, r0, r1);
  store_tile(p, N, Ka, N, m0, n0, acc, [](float s, int) { return s; });
}

}  // namespace vil
