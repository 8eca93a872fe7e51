// Sampled-neighbour sliding-chunk attention forward over halo-extended K/V
// for Hopper (sm_90a): random-shift training (MODE 1..8) under spatial
// (chunk-row) parallelism. B5h: the halo form of B5 (vil_mode_attention_fwd.cu).
//
// Replaces the TPU kernel vil_tpu/ops/pallas/vil_mode_kernel.py::mode_forward
// (Pallas bodies _fwd_kernel_img, _fwd_kernel_row) as vil_tpu runs it on a
// shard: vil_tpu/parallel/spatial.py::neighborhood_spatial gathers the sampled
// neighbour from the halo-extended rows by XLA slices and rolls, and the mode
// kernel, which is chunk-local, attends [glo ‖ self ‖ sampled]. Here a shard
// holds mx chunk rows of q and mx + 2 rows of K and V (its own rows between
// the previous shard's last row and the next shard's first, exchanged by
// parallel/spatial.py). For every query chunk (i, j) of the shard and every
// head h:
//
//   S   = q · [K_glo ‖ K_self ‖ K_sampled]ᵀ + bias + mask
//   out = softmax(S) · [V_glo ‖ V_self ‖ V_sampled]          (softmax in f32)
//   lse = log Σ exp(S)   per query row, f32, when asked for (training)
//
// K_self is K/V chunk (i + 1, j), K_sampled is (i + dx + 1, (j + dy) mod my)
// with the launch's (dx, dy) = -MODE_ROLL_SHIFTS[mode]: the rows are not
// wrapped, since the halo rows are the wrap. The neighbourhood is
// HaloSampledNbh = Halo<SampledNbh> (sliding_chunk.cuh): SampledNbh's two
// chunks with the halo row addressing of B7a. A mode with dx = 0 reads no
// halo row; one with dx = ±1 reads one of the two. Columns are in front
// order [glo ‖ self ‖ sampled]; the mask (mx, my, Wq, Nglo+2W²) holds this
// shard's rows of the whole image's table of the mode; the bias
// (H, W², Nglo+2W²) is the same on every shard.
//
// What bounds it on an H100: what bounds B5, device memory (about 49 FLOP/B
// at ViL-Small's stage 1 against the bf16 ridge of ~295), on a shard of 1/D
// of the image's rows plus two rows of K and V.
//
// What the design does about it: it is B5's kernel over another
// neighbourhood, and reads the sampled chunk in place as B5 does, so neither
// the neighbourhood nor a rolled copy of K/V is materialised. The dtype picks
// the body, as for B5: bf16 (vil_mode_attention_halo_fwd_wgmma) runs the
// tensor-core flash body sliding_chunk_fwd_tc (sliding_chunk_tc.cuh), one
// warpgroup per (64-row slice of a query chunk, head, image), its 64-key
// tiles cut across [glo ‖ self ‖ sampled] by ConcatKeys, whose row address
// for a Halo neighbourhood is K/V row i + dx + 1 of the mx + 2 rows; f32
// (vil_mode_attention_halo_fwd_kernel) runs the CUDA-core body
// sliding_chunk_fwd (sliding_chunk.cuh) in full f32 for the parity checks.
#include "sliding_chunk_tc.cuh"

namespace vil {

template <typename T, int M>
__global__ void __launch_bounds__(kThreads)
vil_mode_attention_halo_fwd_kernel(HaloSampledNbh nbh, const T* __restrict__ q,
                                   const T* __restrict__ k_ext, const T* __restrict__ v_ext,
                                   const T* __restrict__ k_glo, const T* __restrict__ v_glo,
                                   const float* __restrict__ bias, const float* __restrict__ mask,
                                   T* __restrict__ out, float* __restrict__ lse, int mx, int my,
                                   int w2, int C, int nglo, int wq) {
  sliding_chunk_fwd<T, M>(nbh, q, k_ext, v_ext, k_glo, v_glo, bias, mask, out, lse, mx, my, w2,
                          C, nglo, wq);
}

template <int M>
__global__ void __launch_bounds__(kTcThreads)
vil_mode_attention_halo_fwd_wgmma(HaloSampledNbh nbh, const bf16* __restrict__ q,
                                  const bf16* __restrict__ k_ext,
                                  const bf16* __restrict__ v_ext,
                                  const bf16* __restrict__ k_glo,
                                  const bf16* __restrict__ v_glo, const float* __restrict__ bias,
                                  const float* __restrict__ mask, bf16* __restrict__ out,
                                  float* __restrict__ lse, int mx, int my, int w2, int C,
                                  int nglo, int wq, bool bf16_exp) {
  sliding_chunk_fwd_tc<M>(nbh, q, k_ext, v_ext, k_glo, v_glo, bias, mask, out, lse, mx, my, w2, C,
                          nglo, wq, bf16_exp);
}

template <typename T>
cudaError_t launch_vil_mode_halo(const void* q, const void* k_ext, const void* v_ext,
                                 const void* k_glo, const void* v_glo, const float* bias,
                                 const float* mask, void* out, float* lse, int B, int mx, int my,
                                 int w2, int C, int H, int nglo, int wq, HaloSampledNbh nbh,
                                 bool bf16_exp, cudaStream_t stream) {
  return dispatch_head_dim(C / H, [&](auto m) {
    constexpr int M = decltype(m)::value;
    if constexpr (std::is_same_v<T, bf16>) {
      const int slices = (w2 + kTcRows - 1) / kTcRows;  // 64-row slices of a chunk
      return launch_with(vil_mode_attention_halo_fwd_wgmma<M>, dim3(slices * mx * my, H, B),
                         kTcThreads, tc_fwd_smem_bytes(M, nglo + HaloSampledNbh::kCount * w2),
                         stream, nbh, (const T*)q, (const T*)k_ext, (const T*)v_ext,
                         (const T*)k_glo, (const T*)v_glo, bias, mask, (T*)out, lse, mx, my, w2,
                         C, nglo, wq, bf16_exp);
    } else {
      return launch(vil_mode_attention_halo_fwd_kernel<T, M>, dim3(mx * my, H, B),
                    fwd_smem_bytes(w2, M), stream, nbh, (const T*)q, (const T*)k_ext,
                    (const T*)v_ext, (const T*)k_glo, (const T*)v_glo, bias, mask, (T*)out, lse,
                    mx, my, w2, C, nglo, wq);
    }
  });
}

}  // namespace vil

// q, out (B, mx, my, w2, C); k_ext, v_ext (B, mx + 2, my, w2, C); k_glo,
// v_glo (B, nglo, C) or null when nglo is 0; bias (H, w2, nglo + 2 w2) f32 or
// null; mask (mx, my, wq, nglo + 2 w2) f32, this shard's rows; lse
// (B, H, mx, my, w2) f32 or null. All contiguous, bf16 operands 16-byte
// aligned. (dx, dy), each in {-1, 0, 1}, is the sampled chunk's offset.
// Returns the launch's error.
extern "C" int vil_mode_attention_halo_fwd(const void* q, const void* k_ext, const void* v_ext,
                                           const void* k_glo, const void* v_glo,
                                           const void* bias, const void* mask, void* out,
                                           void* lse, int B, int mx, int my, int w2, int C, int H,
                                           int nglo, int wq, int dx, int dy, int is_bf16,
                                           int bf16_exp,
                                           void* stream) {
  if (dx < -1 || dx > 1 || dy < -1 || dy > 1) return cudaErrorInvalidValue;
  auto* s = static_cast<cudaStream_t>(stream);
  auto* bias_f = static_cast<const float*>(bias);
  auto* mask_f = static_cast<const float*>(mask);
  auto* lse_f = static_cast<float*>(lse);
  const vil::HaloSampledNbh nbh{{dx, dy}};
  if (is_bf16)
    return vil::launch_vil_mode_halo<__nv_bfloat16>(q, k_ext, v_ext, k_glo, v_glo, bias_f,
                                                    mask_f, out, lse_f, B, mx, my, w2, C, H,
                                                    nglo, wq, nbh, bf16_exp != 0, s);
  return vil::launch_vil_mode_halo<float>(q, k_ext, v_ext, k_glo, v_glo, bias_f, mask_f, out,
                                          lse_f, B, mx, my, w2, C, H, nglo, wq, nbh, bf16_exp != 0,
                                          s);
}
