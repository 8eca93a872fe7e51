// Halo-input sliding-chunk attention backward for Hopper (sm_90a): the local
// branch of spatial (chunk-row) parallelism.
//
// Replaces the TPU kernel vil_tpu/ops/pallas/vil_backward.py::backward_whole_image_halo
// (_bwd_kernel_img with halo=True). Given the forward's inputs
// (vil_attention_halo_fwd.cu: q of mx chunk rows, K/V of mx + 2), its output
// `out`, its per-row log-sum-exp L and the upstream gradient g, it writes dQ,
// dK_ext and dV_ext with mx + 2 rows (the halo rows' gradients included:
// parallel/spatial.py sends them back to the shards that own those rows and
// adds them there), dK_glo, dV_glo and dbias, by the formulas of B2
// (vil_attention_bwd.cu).
//
// Two kernels, in B2's gather form: no atomics, the same result on every run.
//   pass 1, per query chunk, head and image (per head and image, walking its
//     chunks, when a bias is given): δ, dQ, P_glo, dS_glo and the dbias
//     partials.
//   pass 2, per chunk of the extended K/V grid, head and image: K/V row e is
//     neighbour (dx, dy) of query row e - 1 - dx, where that row is in
//     [0, mx); the halo rows 0 and mx + 1 are seen by query rows 0 and mx - 1
//     only (both the one row of a shard with mx = 1).
//
// What bounds it on an H100: what bounds B2, on a shard of 1/D of the image's
// rows plus two rows of K and V: the products belong on the tensor cores.
//
// What the design does about it. It is B2's pair of kernels over another
// neighbourhood, chosen by dtype as B2's: bf16 runs the tensor-core bodies
// (sliding_chunk_tc.cuh, wgmma and cp.async; δ = rowsum(g ∘ out); pass 2's
// list of query rows holds only the neighbours that exist, 3 of 9 for a halo
// row) and f32 the CUDA-core ones (sliding_chunk.cuh), both over HaloNbh.
// Scores never reach device memory.
#include "sliding_chunk_tc.cuh"

namespace vil {

template <typename T, int M>
__global__ void __launch_bounds__(kThreads)
vil_attention_halo_bwd_pass1(const T* __restrict__ q, const T* __restrict__ k_ext,
                             const T* __restrict__ v_ext, const T* __restrict__ k_glo,
                             const T* __restrict__ v_glo, const T* __restrict__ g,
                             const float* __restrict__ bias, const float* __restrict__ mask,
                             const float* __restrict__ lse, float* __restrict__ delta,
                             T* __restrict__ dq, float* __restrict__ p_glo,
                             float* __restrict__ ds_glo, float* __restrict__ dbias_part, int mx,
                             int my, int w2, int C, int nglo, int wq, int chunks_per_block) {
  sliding_chunk_bwd_pass1<T, M>(HaloNbh{}, q, k_ext, v_ext, k_glo, v_glo, g, bias, mask, lse,
                                delta, dq, p_glo, ds_glo, dbias_part, mx, my, w2, C, nglo, wq,
                                chunks_per_block);
}

template <typename T, int M>
__global__ void __launch_bounds__(kThreads)
vil_attention_halo_bwd_pass2(const T* __restrict__ q, const T* __restrict__ k_ext,
                             const T* __restrict__ v_ext, const T* __restrict__ g,
                             const float* __restrict__ bias, const float* __restrict__ mask,
                             const float* __restrict__ lse, const float* __restrict__ delta,
                             T* __restrict__ dk_ext, T* __restrict__ dv_ext, int mx, int my,
                             int w2, int C, int nglo, int wq) {
  sliding_chunk_bwd_pass2<T, M>(HaloNbh{}, q, k_ext, v_ext, g, bias, mask, lse, delta, dk_ext,
                                dv_ext, mx, my, w2, C, nglo, wq);
}

template <int M>
__global__ void __launch_bounds__(kTcThreads)
vil_attention_halo_bwd_wgmma_pass1(const bf16* __restrict__ q, const bf16* __restrict__ k_ext,
                                   const bf16* __restrict__ v_ext, const bf16* __restrict__ k_glo,
                                   const bf16* __restrict__ v_glo, const bf16* __restrict__ g,
                                   const bf16* __restrict__ out, const float* __restrict__ bias,
                                   const float* __restrict__ mask, const float* __restrict__ lse,
                                   float* __restrict__ delta, bf16* __restrict__ dq,
                                   float* __restrict__ p_glo, float* __restrict__ ds_glo,
                                   float* __restrict__ dbias_part, int mx, int my, int w2, int C,
                                   int nglo, int wq, int chunks_per_block, bool bf16_exp) {
  sliding_chunk_bwd_tc_pass1<M>(HaloNbh{}, q, k_ext, v_ext, k_glo, v_glo, g, out, bias, mask, lse,
                                delta, dq, p_glo, ds_glo, dbias_part, mx, my, w2, C, nglo, wq,
                                chunks_per_block, bf16_exp);
}

template <int M>
__global__ void __launch_bounds__(kTcThreads)
vil_attention_halo_bwd_wgmma_pass2(const bf16* __restrict__ q, const bf16* __restrict__ k_ext,
                                   const bf16* __restrict__ v_ext, const bf16* __restrict__ g,
                                   const float* __restrict__ bias, const float* __restrict__ mask,
                                   const float* __restrict__ lse, const float* __restrict__ delta,
                                   bf16* __restrict__ dk_ext, bf16* __restrict__ dv_ext, int mx,
                                   int my, int w2, int C, int nglo, int wq, bool bf16_exp) {
  sliding_chunk_bwd_tc_pass2<M>(HaloNbh{}, q, k_ext, v_ext, g, bias, mask, lse, delta, dk_ext,
                                dv_ext, mx, my, w2, C, nglo, wq, bf16_exp);
}

template <typename T>
cudaError_t launch_vil_halo_bwd(const void* q, const void* k_ext, const void* v_ext,
                                const void* k_glo, const void* v_glo, const void* g,
                                const void* out, const float* bias, const float* mask,
                                const float* lse, float* delta, void* dq, void* dk_ext,
                                void* dv_ext, float* p_glo, float* ds_glo, float* dbias_part,
                                int B, int mx, int my, int w2, int C, int H, int nglo, int wq,
                                bool bf16_exp, cudaStream_t stream) {
  const int per_block = dbias_part != nullptr ? mx * my : 1;
  return dispatch_head_dim(C / H, [&](auto m) {
    constexpr int M = decltype(m)::value;
    if constexpr (std::is_same_v<T, bf16>) {
      const int slices = (w2 + kTcRows - 1) / kTcRows;  // 64-row slices of a chunk
      cudaError_t err = launch_with(
          vil_attention_halo_bwd_wgmma_pass1<M>, dim3(mx * my / per_block * slices, H, B),
          kTcThreads, tc_pass1_smem_bytes(M), stream, (const T*)q, (const T*)k_ext,
          (const T*)v_ext, (const T*)k_glo, (const T*)v_glo, (const T*)g, (const T*)out, bias,
          mask, lse, delta, (T*)dq, p_glo, ds_glo, dbias_part, mx, my, w2, C, nglo, wq,
          per_block, bf16_exp);
      if (err != cudaSuccess) return err;
      return launch_with(vil_attention_halo_bwd_wgmma_pass2<M>, dim3((mx + 2) * my * slices, H, B),
                         kTcThreads, tc_pass2_smem_bytes(M), stream, (const T*)q,
                         (const T*)k_ext, (const T*)v_ext, (const T*)g, bias, mask, lse,
                         (const float*)delta, (T*)dk_ext, (T*)dv_ext, mx, my, w2, C, nglo, wq,
                         bf16_exp);
    } else {
      cudaError_t err = launch(vil_attention_halo_bwd_pass1<T, M>,
                               dim3(mx * my / per_block, H, B), pass1_smem_bytes(w2, M), stream,
                               (const T*)q, (const T*)k_ext, (const T*)v_ext, (const T*)k_glo,
                               (const T*)v_glo, (const T*)g, bias, mask, lse, delta, (T*)dq,
                               p_glo, ds_glo, dbias_part, mx, my, w2, C, nglo, wq, per_block);
      if (err != cudaSuccess) return err;
      return launch(vil_attention_halo_bwd_pass2<T, M>, dim3((mx + 2) * my, H, B),
                    pass2_smem_bytes(w2, M), stream, (const T*)q, (const T*)k_ext,
                    (const T*)v_ext, (const T*)g, bias, mask, lse, (const float*)delta,
                    (T*)dk_ext, (T*)dv_ext, mx, my, w2, C, nglo, wq);
    }
  });
}

}  // namespace vil

// q, g, out, dq (B, mx, my, w2, C), `out` the forward's output (read by the
// bf16 kernels for δ); k_ext, v_ext, dk_ext, dv_ext (B, mx + 2, my, w2, C);
// k_glo, v_glo (B, nglo, C) or null when nglo is 0; bias (H, w2, nglo + 9 w2)
// f32 or null; mask (mx, my, wq, nglo + 9 w2) f32, this shard's rows; lse and
// delta (B, H, mx, my, w2) f32; p_glo, ds_glo (B, H, mx, my, w2, nglo) f32 or
// null when nglo is 0; dbias_part (B, H, w2, nglo + 9 w2) f32, zero on entry,
// or null without a bias. All contiguous, bf16 operands 16-byte aligned.
// Launches both passes on `stream`; returns the first launch error.
extern "C" int vil_attention_halo_bwd(const void* q, const void* k_ext, const void* v_ext,
                                      const void* k_glo, const void* v_glo, const void* g,
                                      const void* out, const void* bias, const void* mask,
                                      const void* lse, void* delta, void* dq, void* dk_ext,
                                      void* dv_ext, void* p_glo, void* ds_glo, void* dbias_part,
                                      int B, int mx, int my, int w2, int C, int H, int nglo,
                                      int wq, int is_bf16, int bf16_exp,
                                      void* stream) {
  auto* s = static_cast<cudaStream_t>(stream);
  auto* bias_f = static_cast<const float*>(bias);
  auto* mask_f = static_cast<const float*>(mask);
  auto* lse_f = static_cast<const float*>(lse);
  auto* delta_f = static_cast<float*>(delta);
  auto* pg = static_cast<float*>(p_glo);
  auto* dsg = static_cast<float*>(ds_glo);
  auto* db = static_cast<float*>(dbias_part);
  if (is_bf16)
    return vil::launch_vil_halo_bwd<__nv_bfloat16>(q, k_ext, v_ext, k_glo, v_glo, g, out, bias_f,
                                                   mask_f, lse_f, delta_f, dq, dk_ext, dv_ext,
                                                   pg, dsg, db, B, mx, my, w2, C, H, nglo, wq,
                                                   bf16_exp != 0, s);
  return vil::launch_vil_halo_bwd<float>(q, k_ext, v_ext, k_glo, v_glo, g, out, bias_f, mask_f,
                                         lse_f, delta_f, dq, dk_ext, dv_ext, pg, dsg, db, B, mx,
                                         my, w2, C, H, nglo, wq, bf16_exp != 0, s);
}
