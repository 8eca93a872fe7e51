// Sampled-neighbour sliding-chunk attention backward for Hopper (sm_90a):
// random-shift training, MODE 1..8.
//
// Replaces the TPU kernel vil_tpu/ops/pallas/vil_mode_kernel.py::mode_backward
// (Pallas bodies _bwd_kernel_img, _bwd_kernel_row). Given the forward's
// inputs (vil_mode_attention_fwd.cu), its per-row log-sum-exp L and the
// upstream gradient g, with columns [glo ‖ self ‖ sampled]:
//
//   P  = exp(S - L)            S recomputed exactly as the forward formed it
//   dP = g · [V_glo ‖ V_self ‖ V_sampled]ᵀ
//   δ  = rowsum(dP ∘ P)
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
//   pass 1, one block per (query chunk, head, image) (per (head, image),
//     walking its chunks, when a bias is given, so each dbias partial has one
//     writer): δ, dQ, the global columns P_glo and dS_glo (the wrapper makes
//     dK_glo and dV_glo of them with one einsum each) and the dbias partials.
//   pass 2, one block per (key chunk, head, image): the two query chunks that
//     see it, at the self and at the sampled columns.
//
// What bounds it on an H100. The five products are about 2.5x the forward's
// FLOPs: ViL-Small stage 1 per image 0.30 GFLOP over 4.8 MB of q, k, v, g,
// dq, dk, dv in bf16, ~62 FLOP/B, under the bf16 tensor-core ridge: device
// memory sets the least time. Like B2, this version recomputes S and dP in
// both sweeps of pass 1 and in pass 2, in f32 on the CUDA cores, so it is
// bound by f32 FMAs and the shared-memory reads that feed them.
//
// What the design does about it. It is B2's pair of kernels over another
// neighbourhood: the bodies are sliding_chunk_bwd_pass1/2 (sliding_chunk.cuh)
// over SampledNbh. Scores never reach device memory, and no rolled copy of K,
// V, dK or dV is made.
#include "sliding_chunk.cuh"

namespace vil {

template <typename T, int M>
__global__ void __launch_bounds__(kThreads)
vil_mode_attention_bwd_pass1(SampledNbh nbh, const T* __restrict__ q, const T* __restrict__ k,
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

template <typename T, int M>
__global__ void __launch_bounds__(kThreads)
vil_mode_attention_bwd_pass2(SampledNbh nbh, const T* __restrict__ q, const T* __restrict__ k,
                             const T* __restrict__ v, const T* __restrict__ g,
                             const float* __restrict__ bias, const float* __restrict__ mask,
                             const float* __restrict__ lse, const float* __restrict__ delta,
                             T* __restrict__ dk, T* __restrict__ dv, int mx, int my, int w2,
                             int C, int nglo, int wq) {
  sliding_chunk_bwd_pass2<T, M>(nbh, q, k, v, g, bias, mask, lse, delta, dk, dv, mx, my, w2, C,
                                nglo, wq);
}

template <typename T>
cudaError_t launch_vil_mode_bwd(const void* q, const void* k, const void* v, const void* k_glo,
                                const void* v_glo, const void* g, const float* bias,
                                const float* mask, const float* lse, float* delta, void* dq,
                                void* dk, void* dv, float* p_glo, float* ds_glo,
                                float* dbias_part, int B, int mx, int my, int w2, int C, int H,
                                int nglo, int wq, SampledNbh nbh, cudaStream_t stream) {
  const int per_block = dbias_part != nullptr ? mx * my : 1;
  return dispatch_head_dim(C / H, [&](auto m) {
    constexpr int M = decltype(m)::value;
    cudaError_t err = launch(vil_mode_attention_bwd_pass1<T, M>,
                             dim3(mx * my / per_block, H, B), pass1_smem_bytes(w2, M), stream,
                             nbh, (const T*)q, (const T*)k, (const T*)v, (const T*)k_glo,
                             (const T*)v_glo, (const T*)g, bias, mask, lse, delta, (T*)dq, p_glo,
                             ds_glo, dbias_part, mx, my, w2, C, nglo, wq, per_block);
    if (err != cudaSuccess) return err;
    return launch(vil_mode_attention_bwd_pass2<T, M>, dim3(mx * my, H, B),
                  pass2_smem_bytes(w2, M), stream, nbh, (const T*)q, (const T*)k, (const T*)v,
                  (const T*)g, bias, mask, lse, (const float*)delta, (T*)dk, (T*)dv, mx, my, w2,
                  C, nglo, wq);
  });
}

}  // namespace vil

// q, k, v, g, dq, dk, dv (B, mx, my, w2, C); k_glo, v_glo (B, nglo, C) or
// null when nglo is 0; bias (H, w2, nglo + 2 w2) f32 or null; mask
// (mx, my, wq, nglo + 2 w2) f32; lse and delta (B, H, mx, my, w2) f32;
// p_glo, ds_glo (B, H, mx, my, w2, nglo) f32 or null when nglo is 0;
// dbias_part (B, H, w2, nglo + 2 w2) f32, zero on entry, or null without a
// bias. All contiguous. (dx, dy), each in {-1, 0, 1}, is the sampled chunk's
// offset. Launches both passes on `stream`; returns the first launch error.
extern "C" int vil_mode_attention_bwd(const void* q, const void* k, const void* v,
                                      const void* k_glo, const void* v_glo, const void* g,
                                      const void* bias, const void* mask, const void* lse,
                                      void* delta, void* dq, void* dk, void* dv, void* p_glo,
                                      void* ds_glo, void* dbias_part, int B, int mx, int my,
                                      int w2, int C, int H, int nglo, int wq, int dx, int dy,
                                      int is_bf16, void* stream) {
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
    return vil::launch_vil_mode_bwd<__nv_bfloat16>(q, k, v, k_glo, v_glo, g, bias_f, mask_f,
                                                   lse_f, delta_f, dq, dk, dv, pg, dsg, db, B,
                                                   mx, my, w2, C, H, nglo, wq, nbh, s);
  return vil::launch_vil_mode_bwd<float>(q, k, v, k_glo, v_glo, g, bias_f, mask_f, lse_f,
                                         delta_f, dq, dk, dv, pg, dsg, db, B, mx, my, w2, C, H,
                                         nglo, wq, nbh, s);
}
