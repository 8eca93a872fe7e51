// Sliding-chunk attention backward for Hopper (sm_90a).
//
// Replaces the TPU kernel vil_tpu/ops/pallas/vil_backward.py::vil_attention_backward
// and its four VMEM tiers (_backward_whole_image, _backward_whole_image_loop,
// _backward_tiled, _backward_two_pass). Given the forward's inputs, its
// per-row log-sum-exp L and the upstream gradient g, with the forward's
// column order [glo ‖ nbh 0 ‖ ... ‖ nbh 8] (see vil_attention_fwd.cu):
//
//   P  = exp(S - L)            S recomputed exactly as the forward formed it
//   dP = g · [V_glo ‖ V_nbh]ᵀ
//   δ  = rowsum(dP ∘ P)        (the TPU kernel's form, vil_backward.py:374)
//   dS = P ∘ (dP - δ)
//   dQ = dS · [K_glo ‖ K_nbh]
//   dK, dV of each chunk = Σ over the 9 query chunks that see it of dSᵀ · q, Pᵀ · g
//
// Two kernels, in the gather form: no atomics, so the result is the same on
// every run.
//   pass 1, one block per (query chunk, head, image): two sweeps over the 10
//     column tiles. The first sums δ, the second forms dS and dQ. It writes
//     δ, dQ, the global columns P_glo and dS_glo (the wrapper turns them into
//     dK_glo and dV_glo with one einsum each, as the TPU code does in XLA),
//     and, when a bias is given, dbias partials per (image, head): the block
//     then walks every chunk of its image itself, so each partial has one
//     writer.
//   pass 2, one block per (key chunk (r, c), head, image): for each of the 9
//     offsets (dx, dy) it stages query chunk ((r - dx) mod mx, (c - dy) mod my)
//     and recomputes P and dS against this key chunk from the stored L and δ,
//     accumulating dK += dSᵀ · q and dV += Pᵀ · g (vil_backward.py _pass2_kernel).
//     With mx or my ≤ 2 one key chunk is several neighbours of the same query
//     chunk; each occurrence adds, as the forward visits each one.
// Probabilities stay f32 throughout (the TPU kernel rounds P and dS to bf16
// before its products).
//
// What bounds it on an H100. The five products (S, dP, dQ, dK, dV) are about
// 2.5x the forward's FLOPs: ViL-Small stage 1 per image 1.3 GFLOP over
// 4.8 MB of q, k, v, g, dq, dk, dv in bf16, ~280 FLOP/B, near the bf16
// tensor-core ridge. This version recomputes S and dP in both sweeps of
// pass 1 and again in pass 2 (nine products where five would do), all in
// f32 on the CUDA cores, so like the forward it is bound by f32 FMAs and
// the shared-memory reads that feed them.
//
// What the design does about it. Scores never reach device memory: a block
// stages one K/V tile (pass 1) or one query chunk (pass 2) in shared memory
// and keeps per-row sums there, so device memory sees the operands once per
// reader, mostly from L2. The next steps are tensor cores for the
// recomputed products, and keeping P and dP of a row block in shared memory
// so that pass 1 needs one sweep.
#include "attention_common.cuh"

namespace vil {

template <typename T, int M>
__global__ void __launch_bounds__(kThreads)
vil_attention_bwd_pass1(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ k_glo,
                        const T* __restrict__ v_glo, const T* __restrict__ g,
                        const float* __restrict__ bias, const float* __restrict__ mask,
                        const float* __restrict__ lse, float* __restrict__ delta,
                        T* __restrict__ dq, float* __restrict__ p_glo,
                        float* __restrict__ ds_glo, float* __restrict__ dbias_part, int mx,
                        int my, int w2, int C, int nglo, int wq, int chunks_per_block) {
  extern __shared__ float smem[];
  const int h = blockIdx.y, b = blockIdx.z, H = gridDim.y;
  const int cols = nglo + 9 * w2;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, nwarps = blockDim.x / 32;

  float* q_s = smem;                  // w2 x M
  float* g_s = q_s + w2 * M;          // w2 x M
  float* k_s = g_s + w2 * M;          // w2 x (M + 1)
  float* v_s = k_s + w2 * (M + 1);    // w2 x (M + 1)
  float* dq_s = v_s + w2 * (M + 1);   // w2 x M
  float* lse_s = dq_s + w2 * M;       // w2
  float* delta_s = lse_s + w2;        // w2

  auto chunk_ptr = [&](auto* base, int ci, int cj) {
    return base + (((long)b * mx + ci) * my + cj) * w2 * C + h * M;
  };
  const float* bias_h = bias != nullptr ? bias + (long)h * w2 * cols : nullptr;
  const int n_glo_tiles = (nglo + w2 - 1) / w2;

  for (int c = 0; c < chunks_per_block; ++c) {
    const int chunk = blockIdx.x * chunks_per_block + c;  // i * my + j
    const int i = chunk / my, j = chunk % my;
    const long row0 = (((long)b * H + h) * mx * my + chunk) * w2;  // (b, h, i, j, 0)
    __syncthreads();  // the previous chunk is done with shared memory
    load_rows<M>(q_s, M, chunk_ptr(q, i, j), C, w2);
    load_rows<M>(g_s, M, chunk_ptr(g, i, j), C, w2);
    for (int idx = threadIdx.x; idx < w2 * M; idx += blockDim.x) dq_s[idx] = 0.f;
    for (int idx = threadIdx.x; idx < w2; idx += blockDim.x) {
      lse_s[idx] = lse[row0 + idx];
      delta_s[idx] = 0.f;
    }
    const float* mask_c = mask + (long)chunk * wq * cols;

    for (int sweep = 0; sweep < 2; ++sweep) {
      for (int tile = 0; tile < n_glo_tiles + 9; ++tile) {
        int col0, nkeys;
        const T *ksrc, *vsrc;
        if (tile < n_glo_tiles) {
          col0 = tile * w2;
          nkeys = min(w2, nglo - col0);
          ksrc = k_glo + ((long)b * nglo + col0) * C + h * M;
          vsrc = v_glo + ((long)b * nglo + col0) * C + h * M;
        } else {
          const int n = tile - n_glo_tiles;
          const int ci = (i + n / 3 - 1 + mx) % mx, cj = (j + n % 3 - 1 + my) % my;
          col0 = nglo + n * w2;
          nkeys = w2;
          ksrc = chunk_ptr(k, ci, cj);
          vsrc = chunk_ptr(v, ci, cj);
        }
        __syncthreads();  // the previous tile is consumed; rows and sums are set
        load_rows<M>(k_s, M + 1, ksrc, C, nkeys);
        load_rows<M>(v_s, M + 1, vsrc, C, nkeys);
        __syncthreads();
        for (int r = warp; r < w2; r += nwarps) {
          const float* bias_r = bias_h != nullptr ? bias_h + (long)r * cols + col0 : nullptr;
          const float* mask_r = mask_c + (long)(wq == 1 ? 0 : r) * cols + col0;
          if (sweep == 0) {
            const float d = row_delta<M>(q_s + r * M, g_s + r * M, k_s, v_s, nkeys, bias_r,
                                         mask_r, lse_s[r], lane);
            if (lane == 0) delta_s[r] += d;
          } else {
            float *p_out = nullptr, *ds_out = nullptr, *db = nullptr;
            if (tile < n_glo_tiles) {  // (b, h, i, j, r, glo column)
              p_out = p_glo + (row0 + r) * nglo + col0;
              ds_out = ds_glo + (row0 + r) * nglo + col0;
            }
            if (dbias_part != nullptr)  // (b, h, r, column)
              db = dbias_part + (((long)b * H + h) * w2 + r) * cols + col0;
            LaneVec<M> acc;
            acc.load(dq_s + r * M, lane);
            row_dq<M>(acc, q_s + r * M, g_s + r * M, k_s, v_s, nkeys, bias_r, mask_r,
                      lse_s[r], delta_s[r], p_out, ds_out, db, lane);
            acc.store(dq_s + r * M, lane);
          }
        }
      }
    }
    __syncthreads();
    store_rows<M>(chunk_ptr(dq, i, j), C, dq_s, w2);
    for (int idx = threadIdx.x; idx < w2; idx += blockDim.x) delta[row0 + idx] = delta_s[idx];
  }
}

template <typename T, int M>
__global__ void __launch_bounds__(kThreads)
vil_attention_bwd_pass2(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ g,
                        const float* __restrict__ bias, const float* __restrict__ mask,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        T* __restrict__ dk, T* __restrict__ dv, int mx, int my, int w2, int C,
                        int nglo, int wq) {
  extern __shared__ float smem[];
  const int chunk = blockIdx.x;  // the key chunk r * my + c
  const int h = blockIdx.y, b = blockIdx.z, H = gridDim.y;
  const int r = chunk / my, c = chunk % my;
  const int cols = nglo + 9 * w2;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, nwarps = blockDim.x / 32;

  float* k_s = smem;                  // w2 x M
  float* v_s = k_s + w2 * M;          // w2 x M
  float* q_s = v_s + w2 * M;          // w2 x (M + 1)
  float* g_s = q_s + w2 * (M + 1);    // w2 x (M + 1)
  float* dk_s = g_s + w2 * (M + 1);   // w2 x M
  float* dv_s = dk_s + w2 * M;        // w2 x M
  float* lse_s = dv_s + w2 * M;       // w2
  float* delta_s = lse_s + w2;        // w2

  auto chunk_ptr = [&](auto* base, int ci, int cj) {
    return base + (((long)b * mx + ci) * my + cj) * w2 * C + h * M;
  };
  load_rows<M>(k_s, M, chunk_ptr(k, r, c), C, w2);
  load_rows<M>(v_s, M, chunk_ptr(v, r, c), C, w2);
  for (int idx = threadIdx.x; idx < w2 * M; idx += blockDim.x) {
    dk_s[idx] = 0.f;
    dv_s[idx] = 0.f;
  }
  const float* bias_h = bias != nullptr ? bias + (long)h * w2 * cols : nullptr;

  for (int n = 0; n < 9; ++n) {
    // this key chunk is neighbour n = (dx + 1) * 3 + (dy + 1) of query chunk
    // (r - dx, c - dy), at its columns nglo + n * w2 ...
    const int qi = (r - (n / 3 - 1) + mx) % mx, qj = (c - (n % 3 - 1) + my) % my;
    const int qchunk = qi * my + qj;
    const long row0 = (((long)b * H + h) * mx * my + qchunk) * w2;
    __syncthreads();  // the previous query chunk is consumed
    load_rows<M>(q_s, M + 1, chunk_ptr(q, qi, qj), C, w2);
    load_rows<M>(g_s, M + 1, chunk_ptr(g, qi, qj), C, w2);
    for (int idx = threadIdx.x; idx < w2; idx += blockDim.x) {
      lse_s[idx] = lse[row0 + idx];
      delta_s[idx] = delta[row0 + idx];
    }
    __syncthreads();
    const int col0 = nglo + n * w2;
    const float* mask_q = mask + (long)qchunk * wq * cols + col0;
    for (int t = warp; t < w2; t += nwarps) {
      LaneVec<M> dk_acc, dv_acc;
      dk_acc.load(dk_s + t * M, lane);
      dv_acc.load(dv_s + t * M, lane);
      col_dkdv<M>(dk_acc, dv_acc, k_s + t * M, v_s + t * M, q_s, g_s, lse_s, delta_s, w2,
                  bias_h != nullptr ? bias_h + col0 + t : nullptr, cols, mask_q + t,
                  wq == 1 ? 0 : cols, lane);
      dk_acc.store(dk_s + t * M, lane);
      dv_acc.store(dv_s + t * M, lane);
    }
  }
  __syncthreads();
  store_rows<M>(chunk_ptr(dk, r, c), C, dk_s, w2);
  store_rows<M>(chunk_ptr(dv, r, c), C, dv_s, w2);
}

template <typename T, int M>
cudaError_t launch_vil_bwd(const void* q, const void* k, const void* v, const void* k_glo,
                           const void* v_glo, const void* g, const float* bias,
                           const float* mask, const float* lse, float* delta, void* dq,
                           void* dk, void* dv, float* p_glo, float* ds_glo, float* dbias_part,
                           int B, int mx, int my, int w2, int C, int H, int nglo, int wq,
                           cudaStream_t stream) {
  // with a bias, one block walks all chunks of its image (one writer per
  // dbias partial); without, one block per chunk
  const int per_block = dbias_part != nullptr ? mx * my : 1;
  const size_t smem1 = sizeof(float) * (size_t)w2 * (5 * M + 4);
  cudaError_t err = launch(vil_attention_bwd_pass1<T, M>, dim3(mx * my / per_block, H, B), smem1,
                           stream, (const T*)q, (const T*)k, (const T*)v, (const T*)k_glo,
                           (const T*)v_glo, (const T*)g, bias, mask, lse, delta, (T*)dq, p_glo,
                           ds_glo, dbias_part, mx, my, w2, C, nglo, wq, per_block);
  if (err != cudaSuccess) return err;
  const size_t smem2 = sizeof(float) * (size_t)w2 * (6 * M + 4);
  return launch(vil_attention_bwd_pass2<T, M>, dim3(mx * my, H, B), smem2, stream,
                (const T*)q, (const T*)k, (const T*)v, (const T*)g, bias, mask, lse,
                (const float*)delta, (T*)dk, (T*)dv, mx, my, w2, C, nglo, wq);
}

template <typename T>
cudaError_t dispatch_vil_bwd(const void* q, const void* k, const void* v, const void* k_glo,
                             const void* v_glo, const void* g, const float* bias,
                             const float* mask, const float* lse, float* delta, void* dq,
                             void* dk, void* dv, float* p_glo, float* ds_glo, float* dbias_part,
                             int B, int mx, int my, int w2, int C, int H, int nglo, int wq,
                             cudaStream_t stream) {
  switch (C / H) {
#define VIL_BWD_CASE(M)                                                                    \
  case M:                                                                                  \
    return launch_vil_bwd<T, M>(q, k, v, k_glo, v_glo, g, bias, mask, lse, delta, dq, dk, \
                                dv, p_glo, ds_glo, dbias_part, B, mx, my, w2, C, H, nglo, \
                                wq, stream);
    VIL_BWD_CASE(8)
    VIL_BWD_CASE(16)
    VIL_BWD_CASE(32)
    VIL_BWD_CASE(64)
    VIL_BWD_CASE(128)
#undef VIL_BWD_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace vil

// q, k, v, g, dq, dk, dv (B, mx, my, w2, C); k_glo, v_glo (B, nglo, C) or
// null when nglo is 0; bias (H, w2, nglo + 9 w2) f32 or null; mask
// (mx, my, wq, nglo + 9 w2) f32; lse and delta (B, H, mx, my, w2) f32;
// p_glo, ds_glo (B, H, mx, my, w2, nglo) f32 or null when nglo is 0;
// dbias_part (B, H, w2, nglo + 9 w2) f32, zero on entry, or null without a
// bias. All contiguous. Launches both passes on `stream`; returns the first
// launch error.
extern "C" int vil_attention_bwd(const void* q, const void* k, const void* v, const void* k_glo,
                                 const void* v_glo, const void* g, const void* bias,
                                 const void* mask, const void* lse, void* delta, void* dq,
                                 void* dk, void* dv, void* p_glo, void* ds_glo,
                                 void* dbias_part, int B, int mx, int my, int w2, int C, int H,
                                 int nglo, int wq, int is_bf16, void* stream) {
  auto* s = static_cast<cudaStream_t>(stream);
  auto* bias_f = static_cast<const float*>(bias);
  auto* mask_f = static_cast<const float*>(mask);
  auto* lse_f = static_cast<const float*>(lse);
  auto* delta_f = static_cast<float*>(delta);
  auto* pg = static_cast<float*>(p_glo);
  auto* dsg = static_cast<float*>(ds_glo);
  auto* db = static_cast<float*>(dbias_part);
  if (is_bf16)
    return vil::dispatch_vil_bwd<__nv_bfloat16>(q, k, v, k_glo, v_glo, g, bias_f, mask_f, lse_f,
                                                delta_f, dq, dk, dv, pg, dsg, db, B, mx, my, w2,
                                                C, H, nglo, wq, s);
  return vil::dispatch_vil_bwd<float>(q, k, v, k_glo, v_glo, g, bias_f, mask_f, lse_f, delta_f,
                                      dq, dk, dv, pg, dsg, db, B, mx, my, w2, C, H, nglo, wq,
                                      s);
}
