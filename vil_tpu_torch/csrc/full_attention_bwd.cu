// Dense multi-head attention backward for Hopper (sm_90a).
//
// Replaces the TPU kernels vil_tpu/ops/pallas/full_attention.py::_pallas_backward
// (Pallas body _bwd_kernel) and its q-tiled tier _pallas_backward_tiled
// (_tiled_bwd_kernel). For every image b and head h, given the forward's
// per-row log-sum-exp L and the upstream gradient g:
//
//   P  = exp(q · kᵀ + bias - L),   dP = g · vᵀ,   δ = rowsum(dP ∘ P)
//   dS = P ∘ (dP - δ)
//   dQ = dS · k,   dK = dSᵀ · q,   dV = Pᵀ · g,   dbias = Σ_b dS
//
// q, k, v, g and the gradients are (B, N, C) with the heads packed in C;
// q arrives scaled by M^-1/2 and dQ is with respect to that scaled q.
//
// FlashAttention-2 in shape, without atomics:
//   pass 1, one block per (64-row q tile, head, image): two sweeps over the
//     64-row key tiles, the first summing δ, the second forming dS and dQ;
//     with a bias, it writes dS into its own rows of a per-image dbias
//     partial (the wrapper sums the partials over images).
//   pass 2, one block per (64-row key tile, head, image): loops over the
//     q tiles, recomputing P and dS from L and δ, accumulating dK and dV.
// Ragged edges (N = 197 and 49 at ViL-Small 224²) are handled by row counts.
// Probabilities stay f32.
//
// What bounds it on an H100. ViL-Small stage 3 per image: the five products
// are 5 x 2 x 197² x 384 = 0.15 GFLOP over 1.06 MB of q, k, v, g, dq, dk,
// dv in bf16, ~140 FLOP/B, under the bf16 tensor-core ridge (~295 FLOP/B).
// This version recomputes S and dP in both sweeps of pass 1 and in pass 2
// (nine products where five would do), in f32 on the CUDA cores, so it is
// bound by f32 FMAs and the shared-memory reads that feed them.
//
// What the design does about it. Scores never reach device memory: shared
// memory holds one q tile, one K/V tile and the per-row sums, so the
// footprint is fixed for any N (N = 1025 and 4097 at 512² and 1024²).
// Tensor cores on the 64-row tiles are the next step.
#include "attention_common.cuh"

namespace vil {

constexpr int kBwdTile = 64;  // q rows (pass 1) or key rows (pass 2) per block

template <typename T, int M>
__global__ void __launch_bounds__(kThreads)
full_attention_bwd_pass1(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ g,
                         const float* __restrict__ bias, const float* __restrict__ lse,
                         float* __restrict__ delta, T* __restrict__ dq,
                         float* __restrict__ dbias_part, int N, int C) {
  extern __shared__ float smem[];
  const int h = blockIdx.y, b = blockIdx.z, H = gridDim.y;
  const int q0 = blockIdx.x * kBwdTile;
  const int nq = min(kBwdTile, N - q0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, nwarps = blockDim.x / 32;

  float* q_s = smem;                        // kBwdTile x M
  float* g_s = q_s + kBwdTile * M;          // kBwdTile x M
  float* k_s = g_s + kBwdTile * M;          // kBwdTile x (M + 1)
  float* v_s = k_s + kBwdTile * (M + 1);    // kBwdTile x (M + 1)
  float* dq_s = v_s + kBwdTile * (M + 1);   // kBwdTile x M
  float* lse_s = dq_s + kBwdTile * M;       // kBwdTile
  float* delta_s = lse_s + kBwdTile;        // kBwdTile

  auto row_ptr = [&](auto* base, int n) { return base + ((long)b * N + n) * C + h * M; };
  const long row0 = ((long)b * H + h) * N + q0;  // (b, h, q0)
  load_rows<M>(q_s, M, row_ptr(q, q0), C, nq);
  load_rows<M>(g_s, M, row_ptr(g, q0), C, nq);
  for (int idx = threadIdx.x; idx < nq * M; idx += blockDim.x) dq_s[idx] = 0.f;
  for (int idx = threadIdx.x; idx < nq; idx += blockDim.x) {
    lse_s[idx] = lse[row0 + idx];
    delta_s[idx] = 0.f;
  }

  for (int sweep = 0; sweep < 2; ++sweep) {
    for (int k0 = 0; k0 < N; k0 += kBwdTile) {
      const int nk = min(kBwdTile, N - k0);
      __syncthreads();  // the previous tile is consumed; rows and sums are set
      load_rows<M>(k_s, M + 1, row_ptr(k, k0), C, nk);
      load_rows<M>(v_s, M + 1, row_ptr(v, k0), C, nk);
      __syncthreads();
      for (int r = warp; r < nq; r += nwarps) {
        const float* bias_r =
            bias != nullptr ? bias + ((long)h * N + q0 + r) * N + k0 : nullptr;
        if (sweep == 0) {
          const float d = row_delta<M>(q_s + r * M, g_s + r * M, k_s, v_s, nk, bias_r, nullptr,
                                       lse_s[r], lane);
          if (lane == 0) delta_s[r] += d;
        } else {
          float* db = dbias_part != nullptr ? dbias_part + (row0 + r) * N + k0 : nullptr;
          LaneVec<M> acc;
          acc.load(dq_s + r * M, lane);
          row_dq<M>(acc, q_s + r * M, g_s + r * M, k_s, v_s, nk, bias_r, nullptr, lse_s[r],
                    delta_s[r], nullptr, nullptr, db, lane);
          acc.store(dq_s + r * M, lane);
        }
      }
    }
  }
  __syncthreads();
  store_rows<M>(row_ptr(dq, q0), C, dq_s, nq);
  for (int idx = threadIdx.x; idx < nq; idx += blockDim.x) delta[row0 + idx] = delta_s[idx];
}

template <typename T, int M>
__global__ void __launch_bounds__(kThreads)
full_attention_bwd_pass2(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ g,
                         const float* __restrict__ bias, const float* __restrict__ lse,
                         const float* __restrict__ delta, T* __restrict__ dk,
                         T* __restrict__ dv, int N, int C) {
  extern __shared__ float smem[];
  const int h = blockIdx.y, b = blockIdx.z, H = gridDim.y;
  const int k0 = blockIdx.x * kBwdTile;
  const int nk = min(kBwdTile, N - k0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, nwarps = blockDim.x / 32;

  float* k_s = smem;                        // kBwdTile x M
  float* v_s = k_s + kBwdTile * M;          // kBwdTile x M
  float* q_s = v_s + kBwdTile * M;          // kBwdTile x (M + 1)
  float* g_s = q_s + kBwdTile * (M + 1);    // kBwdTile x (M + 1)
  float* dk_s = g_s + kBwdTile * (M + 1);   // kBwdTile x M
  float* dv_s = dk_s + kBwdTile * M;        // kBwdTile x M
  float* lse_s = dv_s + kBwdTile * M;       // kBwdTile
  float* delta_s = lse_s + kBwdTile;        // kBwdTile

  auto row_ptr = [&](auto* base, int n) { return base + ((long)b * N + n) * C + h * M; };
  load_rows<M>(k_s, M, row_ptr(k, k0), C, nk);
  load_rows<M>(v_s, M, row_ptr(v, k0), C, nk);
  for (int idx = threadIdx.x; idx < nk * M; idx += blockDim.x) {
    dk_s[idx] = 0.f;
    dv_s[idx] = 0.f;
  }
  const float* bias_h = bias != nullptr ? bias + (long)h * N * N : nullptr;

  for (int q0 = 0; q0 < N; q0 += kBwdTile) {
    const int nq = min(kBwdTile, N - q0);
    const long row0 = ((long)b * H + h) * N + q0;
    __syncthreads();  // the previous q tile is consumed
    load_rows<M>(q_s, M + 1, row_ptr(q, q0), C, nq);
    load_rows<M>(g_s, M + 1, row_ptr(g, q0), C, nq);
    for (int idx = threadIdx.x; idx < nq; idx += blockDim.x) {
      lse_s[idx] = lse[row0 + idx];
      delta_s[idx] = delta[row0 + idx];
    }
    __syncthreads();
    for (int t = warp; t < nk; t += nwarps) {
      LaneVec<M> dk_acc, dv_acc;
      dk_acc.load(dk_s + t * M, lane);
      dv_acc.load(dv_s + t * M, lane);
      col_dkdv<M>(dk_acc, dv_acc, k_s + t * M, v_s + t * M, q_s, g_s, lse_s, delta_s, nq,
                  bias_h != nullptr ? bias_h + (long)q0 * N + k0 + t : nullptr, N, nullptr, 0,
                  lane);
      dk_acc.store(dk_s + t * M, lane);
      dv_acc.store(dv_s + t * M, lane);
    }
  }
  __syncthreads();
  store_rows<M>(row_ptr(dk, k0), C, dk_s, nk);
  store_rows<M>(row_ptr(dv, k0), C, dv_s, nk);
}

template <typename T, int M>
cudaError_t launch_full_bwd(const void* q, const void* k, const void* v, const void* g,
                            const float* bias, const float* lse, float* delta, void* dq,
                            void* dk, void* dv, float* dbias_part, int B, int N, int C, int H,
                            cudaStream_t stream) {
  const dim3 grid((N + kBwdTile - 1) / kBwdTile, H, B);
  const size_t smem1 = sizeof(float) * (size_t)kBwdTile * (5 * M + 4);
  cudaError_t err = launch(full_attention_bwd_pass1<T, M>, grid, smem1, stream, (const T*)q,
                           (const T*)k, (const T*)v, (const T*)g, bias, lse, delta, (T*)dq,
                           dbias_part, N, C);
  if (err != cudaSuccess) return err;
  const size_t smem2 = sizeof(float) * (size_t)kBwdTile * (6 * M + 4);
  return launch(full_attention_bwd_pass2<T, M>, grid, smem2, stream, (const T*)q, (const T*)k,
                (const T*)v, (const T*)g, bias, lse, (const float*)delta, (T*)dk, (T*)dv, N,
                C);
}

template <typename T>
cudaError_t dispatch_full_bwd(const void* q, const void* k, const void* v, const void* g,
                              const float* bias, const float* lse, float* delta, void* dq,
                              void* dk, void* dv, float* dbias_part, int B, int N, int C, int H,
                              cudaStream_t stream) {
  switch (C / H) {
#define FULL_BWD_CASE(M)                                                                   \
  case M:                                                                                  \
    return launch_full_bwd<T, M>(q, k, v, g, bias, lse, delta, dq, dk, dv, dbias_part, B, \
                                 N, C, H, stream);
    FULL_BWD_CASE(8)
    FULL_BWD_CASE(16)
    FULL_BWD_CASE(32)
    FULL_BWD_CASE(64)
    FULL_BWD_CASE(128)
#undef FULL_BWD_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace vil

// q, k, v, g, dq, dk, dv (B, N, C); bias (H, N, N) f32 or null; lse and
// delta (B, H, N) f32; dbias_part (B, H, N, N) f32 or null without a bias.
// All contiguous. Launches both passes on `stream`; returns the first launch
// error.
extern "C" int full_attention_bwd(const void* q, const void* k, const void* v, const void* g,
                                  const void* bias, const void* lse, void* delta, void* dq,
                                  void* dk, void* dv, void* dbias_part, int B, int N, int C,
                                  int H, int is_bf16, void* stream) {
  auto* s = static_cast<cudaStream_t>(stream);
  auto* bias_f = static_cast<const float*>(bias);
  auto* lse_f = static_cast<const float*>(lse);
  auto* delta_f = static_cast<float*>(delta);
  auto* db = static_cast<float*>(dbias_part);
  if (is_bf16)
    return vil::dispatch_full_bwd<__nv_bfloat16>(q, k, v, g, bias_f, lse_f, delta_f, dq, dk, dv,
                                                 db, B, N, C, H, s);
  return vil::dispatch_full_bwd<float>(q, k, v, g, bias_f, lse_f, delta_f, dq, dk, dv, db, B, N,
                                       C, H, s);
}
