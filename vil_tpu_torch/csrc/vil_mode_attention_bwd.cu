// Sampled-neighbour sliding-chunk attention backward for Hopper (sm_90a):
// random-shift training, MODE 1..8, and its self-only instance, mode -1.
//
// Replaces the TPU kernel vil_tpu/ops/pallas/vil_mode_kernel.py::mode_backward
// (Pallas bodies _bwd_kernel_img, _bwd_kernel_row). Given the forward's
// inputs (vil_mode_attention_fwd.cu), its output `out`, its per-row
// log-sum-exp L and the upstream gradient g, with columns
// [glo ‖ self ‖ sampled]:
//
//   P  = exp(S - L)            S recomputed as the forward formed it
//   dP = g · [V_glo ‖ V_self ‖ V_sampled]ᵀ
//   δ  = rowsum(dP ∘ P) = rowsum(g ∘ out)
//   dS = P ∘ (dP - δ)
//   dQ = dS · [K_glo ‖ K_self ‖ K_sampled]
//   dK, dV of key chunk (r, c) = its self columns' dSᵀ · q, Pᵀ · g
//                              + the sampled columns' of query chunk
//                                ((r - dx) mod mx, (c - dy) mod my)
//
// dK and dV are with respect to the unrolled K and V: the TPU kernel writes
// the sampled chunk's share against a rolled copy (dknb, dvnb) and XLA rolls
// it back; here pass 2 gathers it in place. On a grid with mx or my ≤ 2 the
// sampled chunk can be the self chunk; each occurrence adds, as the rolled
// concat has it.
//
// Two kernels, in the gather form of B2 (vil_attention_bwd.cu): no atomics,
// the same result on every run.
//   pass 1, per query rows (per (head, image), walking its chunks, when a
//     bias is given, so each dbias partial has one writer): δ, dQ, the
//     global columns P_glo and dS_glo (the wrapper makes dK_glo and dV_glo
//     of them with one einsum each) and the dbias partials.
//   pass 2, per key rows: the two query chunks that see them, at the self
//     and at the sampled columns.
//
// What bounds it on an H100. The five products are about 2.5x the forward's
// FLOPs: ViL-Small stage 1 per image 0.30 GFLOP over 4.8 MB of q, k, v, g,
// dq, dk, dv in bf16, ~62 FLOP/B, under the bf16 tensor-core ridge (~295
// FLOP/B): device memory sets the least time, 0.1622 ms per random-shift
// step (PERF.md).
//
// The kernel is chosen by the operand dtype:
//
// bf16 (vil_mode_attention_bwd_wgmma_pass1/2, the main path: the bf16
// random-shift step). B2's tensor-core bodies (sliding_chunk_tc.cuh) over
// SampledNbh: one warpgroup a block, every product by wgmma, tiles by
// cp.async. Pass 1, one block per (64-row slice of a query chunk, head,
// image), takes δ = rowsum(g ∘ out) in its prologue and sweeps the 99
// concatenated [glo ‖ self ‖ sampled] keys (nglo 1) once, in 2 tiles of 64
// (29 padded columns, P = 0, never stored); pass 2, one block per (64-key
// slice of a key chunk, head, image), sweeps the 2 W² query rows of the two
// (neighbour, query chunk) pairs that see it, 2 tiles of 64. Where the
// CUDA-core version recomputed S and dP in both sweeps of pass 1 and in pass
// 2 in f32, each is now one wgmma a tile, and P and dS are rounded to bf16
// before their products, where the TPU kernel rounds them
// (vil_mode_kernel.py:247-248).
//
// f32 (vil_mode_attention_bwd_pass1/2). The tensor cores take no f32
// operands, and the f32 inputs are the parity checks' (one random-shift
// step's gradients within 1e-4 of the plain version), which need f32
// arithmetic. So f32 keeps the CUDA-core bodies sliding_chunk_bwd_pass1/2
// (sliding_chunk.cuh) over SampledNbh: one warp per row, δ by a first sweep
// of pass 1 (`out` is not read). Scores never reach device memory, and no
// rolled copy of K, V, dK or dV is made.
//
// Mode -1 (vil_self_attention_bwd): the same bodies over SelfNbh, the self
// chunk alone: pass 1 sweeps [glo ‖ self] (one 64-key tile at nglo 1), pass
// 2 the W² query rows of the chunk itself. vil_tpu differentiates its XLA
// tier there (vil_tpu/models/attention.py:768); the kernel is the port's, so
// that mode -1 trains on the card without its plain oracle.
#include "sliding_chunk_tc.cuh"

namespace vil {

template <typename T, int M, typename Nbh>
__global__ void __launch_bounds__(kThreads)
vil_mode_attention_bwd_pass1(Nbh nbh, const T* __restrict__ q, const T* __restrict__ k,
                             const T* __restrict__ v, const T* __restrict__ k_glo,
                             const T* __restrict__ v_glo, const T* __restrict__ g,
                             const float* __restrict__ bias, const float* __restrict__ mask,
                             const float* __restrict__ lse, float* __restrict__ delta,
                             T* __restrict__ dq, float* __restrict__ p_glo,
                             float* __restrict__ ds_glo, float* __restrict__ dbias_part, int mx,
                             int my, int w2, int C, int nglo, int wq, int chunks_per_block) {
  sliding_chunk_bwd_pass1<T, M>(nbh, q, k, v, k_glo, v_glo, g, bias, mask, lse, delta, dq, p_glo,
                                ds_glo, dbias_part, mx, my, w2, C, nglo, wq, chunks_per_block);
}

template <typename T, int M, typename Nbh>
__global__ void __launch_bounds__(kThreads)
vil_mode_attention_bwd_pass2(Nbh nbh, const T* __restrict__ q, const T* __restrict__ k,
                             const T* __restrict__ v, const T* __restrict__ g,
                             const float* __restrict__ bias, const float* __restrict__ mask,
                             const float* __restrict__ lse, const float* __restrict__ delta,
                             T* __restrict__ dk, T* __restrict__ dv, int mx, int my, int w2,
                             int C, int nglo, int wq) {
  sliding_chunk_bwd_pass2<T, M>(nbh, q, k, v, g, bias, mask, lse, delta, dk, dv, mx, my, w2, C,
                                nglo, wq);
}

template <int M, typename Nbh>
__global__ void __launch_bounds__(kTcThreads)
vil_mode_attention_bwd_wgmma_pass1(Nbh nbh, const bf16* __restrict__ q,
                                   const bf16* __restrict__ k, const bf16* __restrict__ v,
                                   const bf16* __restrict__ k_glo,
                                   const bf16* __restrict__ v_glo, const bf16* __restrict__ g,
                                   const bf16* __restrict__ out, const float* __restrict__ bias,
                                   const float* __restrict__ mask, const float* __restrict__ lse,
                                   float* __restrict__ delta, bf16* __restrict__ dq,
                                   float* __restrict__ p_glo, float* __restrict__ ds_glo,
                                   float* __restrict__ dbias_part, int mx, int my, int w2, int C,
                                   int nglo, int wq, int chunks_per_block, bool bf16_exp) {
  sliding_chunk_bwd_tc_pass1<M>(nbh, q, k, v, k_glo, v_glo, g, out, bias, mask, lse, delta, dq,
                                p_glo, ds_glo, dbias_part, mx, my, w2, C, nglo, wq,
                                chunks_per_block, bf16_exp);
}

template <int M, typename Nbh>
__global__ void __launch_bounds__(kTcThreads)
vil_mode_attention_bwd_wgmma_pass2(Nbh nbh, const bf16* __restrict__ q,
                                   const bf16* __restrict__ k, const bf16* __restrict__ v,
                                   const bf16* __restrict__ g, const float* __restrict__ bias,
                                   const float* __restrict__ mask, const float* __restrict__ lse,
                                   const float* __restrict__ delta, bf16* __restrict__ dk,
                                   bf16* __restrict__ dv, int mx, int my, int w2, int C,
                                   int nglo, int wq, bool bf16_exp) {
  sliding_chunk_bwd_tc_pass2<M>(nbh, q, k, v, g, bias, mask, lse, delta, dk, dv, mx, my, w2, C,
                                nglo, wq, bf16_exp);
}

template <typename T, typename Nbh>
cudaError_t launch_vil_mode_bwd(const void* q, const void* k, const void* v, const void* k_glo,
                                const void* v_glo, const void* g, const void* out,
                                const float* bias, const float* mask, const float* lse,
                                float* delta, void* dq, void* dk, void* dv, float* p_glo,
                                float* ds_glo, float* dbias_part, int B, int mx, int my, int w2,
                                int C, int H, int nglo, int wq, Nbh nbh,
                                bool bf16_exp, cudaStream_t stream) {
  // with a bias, one block walks all chunks of its image (one writer per
  // dbias partial); without, one block per chunk
  const int per_block = dbias_part != nullptr ? mx * my : 1;
  return dispatch_head_dim(C / H, [&](auto m) {
    constexpr int M = decltype(m)::value;
    if constexpr (std::is_same_v<T, bf16>) {
      const int slices = (w2 + kTcRows - 1) / kTcRows;  // 64-row slices of a chunk
      cudaError_t err = launch_with(
          vil_mode_attention_bwd_wgmma_pass1<M, Nbh>, dim3(mx * my / per_block * slices, H, B),
          kTcThreads, tc_pass1_smem_bytes(M), stream, nbh, (const T*)q, (const T*)k,
          (const T*)v, (const T*)k_glo, (const T*)v_glo, (const T*)g, (const T*)out, bias, mask,
          lse, delta, (T*)dq, p_glo, ds_glo, dbias_part, mx, my, w2, C, nglo, wq, per_block,
          bf16_exp);
      if (err != cudaSuccess) return err;
      return launch_with(vil_mode_attention_bwd_wgmma_pass2<M, Nbh>, dim3(mx * my * slices, H, B),
                         kTcThreads, tc_pass2_smem_bytes(M), stream, nbh, (const T*)q,
                         (const T*)k, (const T*)v, (const T*)g, bias, mask, lse,
                         (const float*)delta, (T*)dk, (T*)dv, mx, my, w2, C, nglo, wq, bf16_exp);
    } else {
      cudaError_t err = launch(vil_mode_attention_bwd_pass1<T, M, Nbh>,
                               dim3(mx * my / per_block, H, B), pass1_smem_bytes(w2, M), stream,
                               nbh, (const T*)q, (const T*)k, (const T*)v, (const T*)k_glo,
                               (const T*)v_glo, (const T*)g, bias, mask, lse, delta, (T*)dq,
                               p_glo, ds_glo, dbias_part, mx, my, w2, C, nglo, wq, per_block);
      if (err != cudaSuccess) return err;
      return launch(vil_mode_attention_bwd_pass2<T, M, Nbh>, dim3(mx * my, H, B),
                    pass2_smem_bytes(w2, M), stream, nbh, (const T*)q, (const T*)k, (const T*)v,
                    (const T*)g, bias, mask, lse, (const float*)delta, (T*)dk, (T*)dv, mx, my,
                    w2, C, nglo, wq);
    }
  });
}

}  // namespace vil

// q, k, v, g, out, dq, dk, dv (B, mx, my, w2, C), `out` the forward's
// output (read by the bf16 kernels for δ); k_glo, v_glo (B, nglo, C) or null
// when nglo is 0; bias (H, w2, nglo + 2 w2) f32 or null; mask
// (mx, my, wq, nglo + 2 w2) f32; lse and delta (B, H, mx, my, w2) f32;
// p_glo, ds_glo (B, H, mx, my, w2, nglo) f32 or null when nglo is 0;
// dbias_part (B, H, w2, nglo + 2 w2) f32, zero on entry, or null without a
// bias. All contiguous, bf16 operands 16-byte aligned. (dx, dy), each in
// {-1, 0, 1}, is the sampled chunk's offset. Launches both passes on
// `stream`; returns the first launch error.
extern "C" int vil_mode_attention_bwd(const void* q, const void* k, const void* v,
                                      const void* k_glo, const void* v_glo, const void* g,
                                      const void* out, const void* bias, const void* mask,
                                      const void* lse, void* delta, void* dq, void* dk, void* dv,
                                      void* p_glo, void* ds_glo, void* dbias_part, int B, int mx,
                                      int my, int w2, int C, int H, int nglo, int wq, int dx,
                                      int dy, int is_bf16, int bf16_exp,
                                      void* stream) {
  if (dx < -1 || dx > 1 || dy < -1 || dy > 1) return cudaErrorInvalidValue;
  auto* s = static_cast<cudaStream_t>(stream);
  auto* bias_f = static_cast<const float*>(bias);
  auto* mask_f = static_cast<const float*>(mask);
  auto* lse_f = static_cast<const float*>(lse);
  auto* delta_f = static_cast<float*>(delta);
  auto* pg = static_cast<float*>(p_glo);
  auto* dsg = static_cast<float*>(ds_glo);
  auto* db = static_cast<float*>(dbias_part);
  const vil::SampledNbh nbh{dx, dy};
  if (is_bf16)
    return vil::launch_vil_mode_bwd<__nv_bfloat16>(q, k, v, k_glo, v_glo, g, out, bias_f, mask_f,
                                                   lse_f, delta_f, dq, dk, dv, pg, dsg, db, B,
                                                   mx, my, w2, C, H, nglo, wq, nbh, bf16_exp != 0,
                                                   s);
  return vil::launch_vil_mode_bwd<float>(q, k, v, k_glo, v_glo, g, out, bias_f, mask_f, lse_f,
                                         delta_f, dq, dk, dv, pg, dsg, db, B, mx, my, w2, C, H,
                                         nglo, wq, nbh, bf16_exp != 0, s);
}

// The self-only instance (mode -1): vil_mode_attention_bwd's arguments
// without the offset; bias (H, w2, nglo + w2) f32 or null, mask
// (mx, my, wq, nglo + w2) f32, dbias_part (B, H, w2, nglo + w2).
extern "C" int vil_self_attention_bwd(const void* q, const void* k, const void* v,
                                      const void* k_glo, const void* v_glo, const void* g,
                                      const void* out, const void* bias, const void* mask,
                                      const void* lse, void* delta, void* dq, void* dk, void* dv,
                                      void* p_glo, void* ds_glo, void* dbias_part, int B, int mx,
                                      int my, int w2, int C, int H, int nglo, int wq,
                                      int is_bf16, int bf16_exp,
                                      void* stream) {
  auto* s = static_cast<cudaStream_t>(stream);
  auto* bias_f = static_cast<const float*>(bias);
  auto* mask_f = static_cast<const float*>(mask);
  auto* lse_f = static_cast<const float*>(lse);
  auto* delta_f = static_cast<float*>(delta);
  auto* pg = static_cast<float*>(p_glo);
  auto* dsg = static_cast<float*>(ds_glo);
  auto* db = static_cast<float*>(dbias_part);
  const vil::SelfNbh nbh{};
  if (is_bf16)
    return vil::launch_vil_mode_bwd<__nv_bfloat16>(q, k, v, k_glo, v_glo, g, out, bias_f, mask_f,
                                                   lse_f, delta_f, dq, dk, dv, pg, dsg, db, B,
                                                   mx, my, w2, C, H, nglo, wq, nbh, bf16_exp != 0,
                                                   s);
  return vil::launch_vil_mode_bwd<float>(q, k, v, k_glo, v_glo, g, out, bias_f, mask_f, lse_f,
                                         delta_f, dq, dk, dv, pg, dsg, db, B, mx, my, w2, C, H,
                                         nglo, wq, nbh, bf16_exp != 0, s);
}
