// Sampled-neighbour sliding-chunk attention forward for Hopper (sm_90a):
// random-shift training, MODE 1..8.
//
// Replaces the TPU kernel vil_tpu/ops/pallas/vil_mode_kernel.py::mode_forward
// (Pallas bodies _fwd_kernel_img, _fwd_kernel_row). For every query chunk
// (i, j) of an mx x my grid of W x W chunks and every head h:
//
//   S   = q · [K_glo ‖ K_self ‖ K_sampled]ᵀ + bias + mask
//   out = softmax(S) · [V_glo ‖ V_self ‖ V_sampled]          (softmax in f32)
//   lse = log Σ exp(S)   per query row, f32, when asked for (training)
//
// The sampled chunk is ((i + dx) mod mx, (j + dy) mod my), with the launch's
// (dx, dy) = -MODE_ROLL_SHIFTS[mode]. The TPU path materialises rolled copies
// of K and V in XLA first (Mosaic has no dynamic rotate); here the block
// computes the sampled chunk's address and reads it in place, so no rolled
// copy exists. Columns are in front order [glo ‖ self ‖ sampled], the order
// of the XLA tier and of B1 (the TPU kernel's tail order [self ‖ sampled ‖
// glo] is a layout choice of Mosaic's); the bias (H, W², Nglo+2W²) and mask
// (mx, my, Wq, Nglo+2W²) tables are in that order.
//
// What bounds it on an H100. ViL-Small stage 1 per image: q, k, v and out
// are 4 x 3136 x 96 bf16 = 2.41 MB, and 2 x 2 x 3136 x 99 x 96 = 0.12 GFLOP,
// about 49 FLOP/B: far under the bf16 tensor-core ridge (~295 FLOP/B), so
// the least time is set by device memory. This first version does its
// arithmetic in f32 on the CUDA cores, like B1, so it is bound by the f32
// FMAs and the shared-memory reads that feed them, at 99 columns a row where
// B1 has 442.
//
// What the design does about it. It is B1's kernel over another
// neighbourhood: the body is sliding_chunk_fwd (sliding_chunk.cuh) over
// SampledNbh, an online softmax over the column tiles (the global keys, the
// self chunk, the sampled chunk) with scores in registers, so device memory
// sees only q, k, v, the tables and out.
#include "sliding_chunk.cuh"

namespace vil {

template <typename T, int M>
__global__ void __launch_bounds__(kThreads)
vil_mode_attention_fwd_kernel(SampledNbh nbh, const T* __restrict__ q, const T* __restrict__ k,
                              const T* __restrict__ v, const T* __restrict__ k_glo,
                              const T* __restrict__ v_glo, const float* __restrict__ bias,
                              const float* __restrict__ mask, T* __restrict__ out,
                              float* __restrict__ lse, int mx, int my, int w2, int C, int nglo,
                              int wq) {
  sliding_chunk_fwd<T, M>(nbh, q, k, v, k_glo, v_glo, bias, mask, out, lse, mx, my, w2, C, nglo,
                          wq);
}

template <typename T>
cudaError_t launch_vil_mode(const void* q, const void* k, const void* v, const void* k_glo,
                            const void* v_glo, const float* bias, const float* mask, void* out,
                            float* lse, int B, int mx, int my, int w2, int C, int H, int nglo,
                            int wq, SampledNbh nbh, cudaStream_t stream) {
  return dispatch_head_dim(C / H, [&](auto m) {
    constexpr int M = decltype(m)::value;
    return launch(vil_mode_attention_fwd_kernel<T, M>, dim3(mx * my, H, B),
                  fwd_smem_bytes(w2, M), stream, nbh, (const T*)q, (const T*)k, (const T*)v,
                  (const T*)k_glo, (const T*)v_glo, bias, mask, (T*)out, lse, mx, my, w2, C,
                  nglo, wq);
  });
}

}  // namespace vil

// q, k, v, out (B, mx, my, w2, C); k_glo, v_glo (B, nglo, C) or null when
// nglo is 0; bias (H, w2, nglo + 2 w2) f32 or null; mask
// (mx, my, wq, nglo + 2 w2) f32; lse (B, H, mx, my, w2) f32 or null. All
// contiguous. (dx, dy), each in {-1, 0, 1}, is the sampled chunk's offset.
// Returns the launch's error.
extern "C" int vil_mode_attention_fwd(const void* q, const void* k, const void* v,
                                      const void* k_glo, const void* v_glo, const void* bias,
                                      const void* mask, void* out, void* lse, int B, int mx,
                                      int my, int w2, int C, int H, int nglo, int wq, int dx,
                                      int dy, int is_bf16, void* stream) {
  if (dx < -1 || dx > 1 || dy < -1 || dy > 1) return cudaErrorInvalidValue;
  auto* s = static_cast<cudaStream_t>(stream);
  auto* bias_f = static_cast<const float*>(bias);
  auto* mask_f = static_cast<const float*>(mask);
  auto* lse_f = static_cast<float*>(lse);
  const vil::SampledNbh nbh{dx, dy};
  if (is_bf16)
    return vil::launch_vil_mode<__nv_bfloat16>(q, k, v, k_glo, v_glo, bias_f, mask_f, out,
                                               lse_f, B, mx, my, w2, C, H, nglo, wq, nbh, s);
  return vil::launch_vil_mode<float>(q, k, v, k_glo, v_glo, bias_f, mask_f, out, lse_f, B, mx,
                                     my, w2, C, H, nglo, wq, nbh, s);
}
