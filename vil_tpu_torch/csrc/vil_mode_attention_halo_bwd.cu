// Sampled-neighbour sliding-chunk attention backward over halo-extended K/V
// for Hopper (sm_90a): random-shift training (MODE 1..8) under spatial
// (chunk-row) parallelism. B6h: the halo form of B6 (vil_mode_attention_bwd.cu).
//
// Replaces the TPU kernel vil_tpu/ops/pallas/vil_mode_kernel.py::mode_backward
// (Pallas bodies _bwd_kernel_img, _bwd_kernel_row) as vil_tpu runs it on a
// shard, after the XLA gather of vil_tpu/parallel/spatial.py::neighborhood_spatial:
// there the sampled chunk's share is written against a rolled copy (dknb,
// dvnb) that XLA rolls back onto the halo-extended rows. Given the forward's
// inputs (vil_mode_attention_halo_fwd.cu: q of mx chunk rows, K/V of
// mx + 2), its output `out`, its per-row log-sum-exp L and the upstream
// gradient g, with columns [glo ‖ self ‖ sampled]:
//
//   P  = exp(S - L),  dP = g · [V_glo ‖ V_self ‖ V_sampled]ᵀ,  δ = rowsum(g ∘ out)
//   dS = P ∘ (dP - δ),  dQ = dS · [K_glo ‖ K_self ‖ K_sampled]
//   dK, dV of K/V chunk (r, c), r in [0, mx + 2):
//       its self columns' dSᵀ · q, Pᵀ · g of query chunk (r - 1, c), if r - 1 in [0, mx)
//     + its sampled columns' of query chunk (r - 1 - dx, (c - dy) mod my), if in [0, mx)
//
// dK and dV have mx + 2 rows, the halo rows' share included (zero for a halo
// row the mode does not read); parallel/spatial.py's exchange sends them back
// to the shards that own those rows and adds them there. dK_glo, dV_glo and
// dbias come as B6's do.
//
// Two kernels, in the gather form of B6: no atomics, the same result on every
// run.
//   pass 1, per query rows (per (head, image), walking its chunks, when a
//     bias is given, so each dbias partial has one writer): δ, dQ, the
//     global columns P_glo and dS_glo and the dbias partials;
//   pass 2, per chunk of the extended K/V grid, head and image: the (up to
//     two) query chunks that see it, at the self and at the sampled columns.
//
// What bounds it on an H100: what bounds B6, device memory (about 62 FLOP/B
// at ViL-Small's stage 1 against the bf16 ridge of ~295), on a shard of 1/D
// of the image's rows plus two rows of K and V.
//
// What the design does about it: B6's pair of kernels over HaloSampledNbh
// (sliding_chunk.cuh), chosen by dtype as B6's: bf16 runs the tensor-core
// bodies (sliding_chunk_tc.cuh: wgmma and cp.async; δ = rowsum(g ∘ out);
// pass 2's list of query rows holds only the neighbours that exist, none for
// a halo row the mode does not read, whose dK and dV are then written as
// zeros) and f32 the CUDA-core ones (sliding_chunk.cuh). Scores never reach
// device memory, and no rolled copy of K, V, dK or dV is made.
#include "sliding_chunk_tc.cuh"

namespace vil {

template <typename T, int M>
__global__ void __launch_bounds__(kThreads)
vil_mode_attention_halo_bwd_pass1(HaloSampledNbh nbh, const T* __restrict__ q,
                                  const T* __restrict__ k_ext, const T* __restrict__ v_ext,
                                  const T* __restrict__ k_glo, const T* __restrict__ v_glo,
                                  const T* __restrict__ g, const float* __restrict__ bias,
                                  const float* __restrict__ mask, const float* __restrict__ lse,
                                  float* __restrict__ delta, T* __restrict__ dq,
                                  float* __restrict__ p_glo, float* __restrict__ ds_glo,
                                  float* __restrict__ dbias_part, int mx, int my, int w2, int C,
                                  int nglo, int wq, int chunks_per_block) {
  sliding_chunk_bwd_pass1<T, M>(nbh, q, k_ext, v_ext, k_glo, v_glo, g, bias, mask, lse, delta,
                                dq, p_glo, ds_glo, dbias_part, mx, my, w2, C, nglo, wq,
                                chunks_per_block);
}

template <typename T, int M>
__global__ void __launch_bounds__(kThreads)
vil_mode_attention_halo_bwd_pass2(HaloSampledNbh nbh, const T* __restrict__ q,
                                  const T* __restrict__ k_ext, const T* __restrict__ v_ext,
                                  const T* __restrict__ g, const float* __restrict__ bias,
                                  const float* __restrict__ mask, const float* __restrict__ lse,
                                  const float* __restrict__ delta, T* __restrict__ dk_ext,
                                  T* __restrict__ dv_ext, int mx, int my, int w2, int C, int nglo,
                                  int wq) {
  sliding_chunk_bwd_pass2<T, M>(nbh, q, k_ext, v_ext, g, bias, mask, lse, delta, dk_ext, dv_ext,
                                mx, my, w2, C, nglo, wq);
}

template <int M>
__global__ void __launch_bounds__(kTcThreads)
vil_mode_attention_halo_bwd_wgmma_pass1(
    HaloSampledNbh nbh, const bf16* __restrict__ q, const bf16* __restrict__ k_ext,
    const bf16* __restrict__ v_ext, const bf16* __restrict__ k_glo,
    const bf16* __restrict__ v_glo, const bf16* __restrict__ g, const bf16* __restrict__ out,
    const float* __restrict__ bias, const float* __restrict__ mask,
    const float* __restrict__ lse, float* __restrict__ delta, bf16* __restrict__ dq,
    float* __restrict__ p_glo, float* __restrict__ ds_glo, float* __restrict__ dbias_part,
    int mx, int my, int w2, int C, int nglo, int wq, int chunks_per_block, bool bf16_exp) {
  sliding_chunk_bwd_tc_pass1<M>(nbh, q, k_ext, v_ext, k_glo, v_glo, g, out, bias, mask, lse,
                                delta, dq, p_glo, ds_glo, dbias_part, mx, my, w2, C, nglo, wq,
                                chunks_per_block, bf16_exp);
}

template <int M>
__global__ void __launch_bounds__(kTcThreads)
vil_mode_attention_halo_bwd_wgmma_pass2(
    HaloSampledNbh nbh, const bf16* __restrict__ q, const bf16* __restrict__ k_ext,
    const bf16* __restrict__ v_ext, const bf16* __restrict__ g, const float* __restrict__ bias,
    const float* __restrict__ mask, const float* __restrict__ lse,
    const float* __restrict__ delta, bf16* __restrict__ dk_ext, bf16* __restrict__ dv_ext,
    int mx, int my, int w2, int C, int nglo, int wq, bool bf16_exp) {
  sliding_chunk_bwd_tc_pass2<M>(nbh, q, k_ext, v_ext, g, bias, mask, lse, delta, dk_ext, dv_ext,
                                mx, my, w2, C, nglo, wq, bf16_exp);
}

template <typename T>
cudaError_t launch_vil_mode_halo_bwd(const void* q, const void* k_ext, const void* v_ext,
                                     const void* k_glo, const void* v_glo, const void* g,
                                     const void* out, const float* bias, const float* mask,
                                     const float* lse, float* delta, void* dq, void* dk_ext,
                                     void* dv_ext, float* p_glo, float* ds_glo,
                                     float* dbias_part, int B, int mx, int my, int w2, int C,
                                     int H, int nglo, int wq, HaloSampledNbh nbh,
                                     bool bf16_exp, cudaStream_t stream) {
  // with a bias, one block walks all chunks of its image (one writer per
  // dbias partial); without, one block per chunk
  const int per_block = dbias_part != nullptr ? mx * my : 1;
  const int kv = kv_rows(nbh, mx);  // pass 2 covers the extended K/V grid
  return dispatch_head_dim(C / H, [&](auto m) {
    constexpr int M = decltype(m)::value;
    if constexpr (std::is_same_v<T, bf16>) {
      const int slices = (w2 + kTcRows - 1) / kTcRows;  // 64-row slices of a chunk
      cudaError_t err = launch_with(
          vil_mode_attention_halo_bwd_wgmma_pass1<M>, dim3(mx * my / per_block * slices, H, B),
          kTcThreads, tc_pass1_smem_bytes(M), stream, nbh, (const T*)q, (const T*)k_ext,
          (const T*)v_ext, (const T*)k_glo, (const T*)v_glo, (const T*)g, (const T*)out, bias,
          mask, lse, delta, (T*)dq, p_glo, ds_glo, dbias_part, mx, my, w2, C, nglo, wq,
          per_block, bf16_exp);
      if (err != cudaSuccess) return err;
      return launch_with(vil_mode_attention_halo_bwd_wgmma_pass2<M>, dim3(kv * my * slices, H, B),
                         kTcThreads, tc_pass2_smem_bytes(M), stream, nbh, (const T*)q,
                         (const T*)k_ext, (const T*)v_ext, (const T*)g, bias, mask, lse,
                         (const float*)delta, (T*)dk_ext, (T*)dv_ext, mx, my, w2, C, nglo, wq,
                         bf16_exp);
    } else {
      cudaError_t err = launch(vil_mode_attention_halo_bwd_pass1<T, M>,
                               dim3(mx * my / per_block, H, B), pass1_smem_bytes(w2, M), stream,
                               nbh, (const T*)q, (const T*)k_ext, (const T*)v_ext,
                               (const T*)k_glo, (const T*)v_glo, (const T*)g, bias, mask, lse,
                               delta, (T*)dq, p_glo, ds_glo, dbias_part, mx, my, w2, C, nglo, wq,
                               per_block);
      if (err != cudaSuccess) return err;
      return launch(vil_mode_attention_halo_bwd_pass2<T, M>, dim3(kv * my, H, B),
                    pass2_smem_bytes(w2, M), stream, nbh, (const T*)q, (const T*)k_ext,
                    (const T*)v_ext, (const T*)g, bias, mask, lse, (const float*)delta,
                    (T*)dk_ext, (T*)dv_ext, mx, my, w2, C, nglo, wq);
    }
  });
}

}  // namespace vil

// q, g, out, dq (B, mx, my, w2, C), `out` the forward's output (read by the
// bf16 kernels for δ); k_ext, v_ext, dk_ext, dv_ext (B, mx + 2, my, w2, C);
// k_glo, v_glo (B, nglo, C) or null when nglo is 0; bias (H, w2, nglo + 2 w2)
// f32 or null; mask (mx, my, wq, nglo + 2 w2) f32, this shard's rows; lse and
// delta (B, H, mx, my, w2) f32; p_glo, ds_glo (B, H, mx, my, w2, nglo) f32 or
// null when nglo is 0; dbias_part (B, H, w2, nglo + 2 w2) f32, zero on entry,
// or null without a bias. All contiguous, bf16 operands 16-byte aligned.
// (dx, dy), each in {-1, 0, 1}, is the sampled chunk's offset. Launches both
// passes on `stream`; returns the first launch error.
extern "C" int vil_mode_attention_halo_bwd(const void* q, const void* k_ext, const void* v_ext,
                                           const void* k_glo, const void* v_glo, const void* g,
                                           const void* out, const void* bias, const void* mask,
                                           const void* lse, void* delta, void* dq, void* dk_ext,
                                           void* dv_ext, void* p_glo, void* ds_glo,
                                           void* dbias_part, int B, int mx, int my, int w2,
                                           int C, int H, int nglo, int wq, int dx, int dy,
                                           int is_bf16, int bf16_exp,
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
  const vil::HaloSampledNbh nbh{{dx, dy}};
  if (is_bf16)
    return vil::launch_vil_mode_halo_bwd<__nv_bfloat16>(q, k_ext, v_ext, k_glo, v_glo, g, out,
                                                        bias_f, mask_f, lse_f, delta_f, dq,
                                                        dk_ext, dv_ext, pg, dsg, db, B, mx, my,
                                                        w2, C, H, nglo, wq, nbh, bf16_exp != 0, s);
  return vil::launch_vil_mode_halo_bwd<float>(q, k_ext, v_ext, k_glo, v_glo, g, out, bias_f,
                                              mask_f, lse_f, delta_f, dq, dk_ext, dv_ext, pg,
                                              dsg, db, B, mx, my, w2, C, H, nglo, wq, nbh,
                                              bf16_exp != 0, s);
}
