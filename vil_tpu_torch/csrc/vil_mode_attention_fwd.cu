// Sampled-neighbour sliding-chunk attention forward for Hopper (sm_90a):
// random-shift training, MODE 1..8, and its self-only instance, mode -1.
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
// copy exists. On a grid with mx or my ≤ 2 the sampled chunk can be the self
// chunk; its keys then appear twice among the columns, as in the rolled
// concat. Columns are in front order [glo ‖ self ‖ sampled], the order of
// the XLA tier and of B1 (the TPU kernel's tail order [self ‖ sampled ‖
// glo] is a layout choice of Mosaic's); the bias (H, W², Nglo+2W²) and mask
// (mx, my, Wq, Nglo+2W²) tables are in that order.
//
// What bounds it on an H100. ViL-Small stage 1 per image: q, k, v and out
// are 4 x 3136 x 96 bf16 = 2.41 MB, and 2 x 2 x 3136 x 99 x 96 = 0.12 GFLOP,
// about 49 FLOP/B: far under the bf16 tensor-core ridge (~295 FLOP/B), so
// device memory sets the least time, 0.0932 ms per random-shift step
// (PERF.md). A block's work is small: 99 columns at nglo 1 where B1 has 442,
// so its fixed cost (the Q tile, the ring's fill, the mask row, the
// epilogue) weighs 3.5 times more per key than in B1.
//
// The kernel is chosen by the operand dtype:
//
// bf16 (vil_mode_attention_fwd_wgmma, the main path: the bf16 random-shift
// step). B1's tensor-core flash body sliding_chunk_fwd_tc
// (sliding_chunk_tc.cuh) over SampledNbh, launched as B1: one warpgroup per
// (64-row slice of a query chunk, head, image), S = Q·Kᵀ and O += P·V by
// wgmma, tiles by cp.async. What the design does about the fixed cost:
//   - ConcatKeys<SampledNbh> cuts the 99 columns [glo ‖ self ‖ sampled] into
//     two 64-key tiles (29 of the 128 columns are zero fill, P = 0); a
//     tile's rows cross from the self chunk into the sampled one, so no
//     third, mostly empty tile is staged.
//   - The ring holds three stages, so both tiles are in flight from the
//     block's first instruction, with Q; the Wq = 1 mask row (99 f32) is
//     read into shared memory while they land.
//   - P is rounded to bf16 as the A operand of P·V, where the TPU kernel
//     rounds it (_attend_row, vil_kernel.py:391, which mode_forward's bodies
//     call); the LSE is taken from the unrounded probabilities in f32.
//
// f32 (vil_mode_attention_fwd_kernel). The tensor cores take no f32
// operands, and the f32 inputs are the parity checks' (one random-shift
// step's gradients within 1e-4 of the plain version), which need f32
// arithmetic. So f32 keeps the CUDA-core body sliding_chunk_fwd
// (sliding_chunk.cuh) over SampledNbh: one block of 256 threads per (query
// chunk, head, image), one warp per query row, an online softmax over the
// column tiles (the global keys, the self chunk, the sampled chunk).
//
// Mode -1 (vil_self_attention_fwd): the same two bodies over SelfNbh, the
// self chunk alone, [glo ‖ self]: 50 columns at nglo 1, one 64-key tile in
// bf16. It replaces no TPU kernel: vil_tpu runs mode -1 in its XLA tier
// (vil_tpu/models/attention.py:768). It exists so that mode -1 runs a kernel
// on the card, where the port's plain version is an oracle only. Its bound
// is the same bytes as B5's (q, k, v, out), half its products: device memory
// again.
#include "sliding_chunk_tc.cuh"

namespace vil {

template <typename T, int M, typename Nbh>
__global__ void __launch_bounds__(kThreads)
vil_mode_attention_fwd_kernel(Nbh nbh, const T* __restrict__ q, const T* __restrict__ k,
                              const T* __restrict__ v, const T* __restrict__ k_glo,
                              const T* __restrict__ v_glo, const float* __restrict__ bias,
                              const float* __restrict__ mask, T* __restrict__ out,
                              float* __restrict__ lse, int mx, int my, int w2, int C, int nglo,
                              int wq) {
  sliding_chunk_fwd<T, M>(nbh, q, k, v, k_glo, v_glo, bias, mask, out, lse, mx, my, w2, C, nglo,
                          wq);
}

template <int M, typename Nbh>
__global__ void __launch_bounds__(kTcThreads)
vil_mode_attention_fwd_wgmma(Nbh nbh, const bf16* __restrict__ q,
                             const bf16* __restrict__ k, const bf16* __restrict__ v,
                             const bf16* __restrict__ k_glo, const bf16* __restrict__ v_glo,
                             const float* __restrict__ bias, const float* __restrict__ mask,
                             bf16* __restrict__ out, float* __restrict__ lse, int mx, int my,
                             int w2, int C, int nglo, int wq, bool bf16_exp) {
  sliding_chunk_fwd_tc<M>(nbh, q, k, v, k_glo, v_glo, bias, mask, out, lse, mx, my, w2, C, nglo,
                          wq, bf16_exp);
}

template <typename T, typename Nbh>
cudaError_t launch_vil_mode(const void* q, const void* k, const void* v, const void* k_glo,
                            const void* v_glo, const float* bias, const float* mask, void* out,
                            float* lse, int B, int mx, int my, int w2, int C, int H, int nglo,
                            int wq, Nbh nbh, bool bf16_exp, cudaStream_t stream) {
  return dispatch_head_dim(C / H, [&](auto m) {
    constexpr int M = decltype(m)::value;
    if constexpr (std::is_same_v<T, bf16>) {
      const int slices = (w2 + kTcRows - 1) / kTcRows;  // 64-row slices of a chunk
      return launch_with(vil_mode_attention_fwd_wgmma<M, Nbh>, dim3(slices * mx * my, H, B),
                         kTcThreads, tc_fwd_smem_bytes(M, nglo + Nbh::kCount * w2),
                         stream, nbh, (const T*)q, (const T*)k, (const T*)v, (const T*)k_glo,
                         (const T*)v_glo, bias, mask, (T*)out, lse, mx, my, w2, C, nglo, wq,
                         bf16_exp);
    } else {
      return launch(vil_mode_attention_fwd_kernel<T, M, Nbh>, dim3(mx * my, H, B),
                    fwd_smem_bytes(w2, M), stream, nbh, (const T*)q, (const T*)k, (const T*)v,
                    (const T*)k_glo, (const T*)v_glo, bias, mask, (T*)out, lse, mx, my, w2, C,
                    nglo, wq);
    }
  });
}

}  // namespace vil

// q, k, v, out (B, mx, my, w2, C); k_glo, v_glo (B, nglo, C) or null when
// nglo is 0; bias (H, w2, nglo + 2 w2) f32 or null; mask
// (mx, my, wq, nglo + 2 w2) f32; lse (B, H, mx, my, w2) f32 or null. All
// contiguous, bf16 operands 16-byte aligned. (dx, dy), each in {-1, 0, 1},
// is the sampled chunk's offset. Returns the launch's error.
extern "C" int vil_mode_attention_fwd(const void* q, const void* k, const void* v,
                                      const void* k_glo, const void* v_glo, const void* bias,
                                      const void* mask, void* out, void* lse, int B, int mx,
                                      int my, int w2, int C, int H, int nglo, int wq, int dx,
                                      int dy, int is_bf16, int bf16_exp,
                                      void* stream) {
  if (dx < -1 || dx > 1 || dy < -1 || dy > 1) return cudaErrorInvalidValue;
  auto* s = static_cast<cudaStream_t>(stream);
  auto* bias_f = static_cast<const float*>(bias);
  auto* mask_f = static_cast<const float*>(mask);
  auto* lse_f = static_cast<float*>(lse);
  const vil::SampledNbh nbh{dx, dy};
  if (is_bf16)
    return vil::launch_vil_mode<__nv_bfloat16>(q, k, v, k_glo, v_glo, bias_f, mask_f, out,
                                               lse_f, B, mx, my, w2, C, H, nglo, wq, nbh,
                                               bf16_exp != 0, s);
  return vil::launch_vil_mode<float>(q, k, v, k_glo, v_glo, bias_f, mask_f, out, lse_f, B, mx,
                                     my, w2, C, H, nglo, wq, nbh, bf16_exp != 0, s);
}

// The self-only instance (mode -1): vil_mode_attention_fwd's arguments
// without the offset; bias (H, w2, nglo + w2) f32 or null, mask
// (mx, my, wq, nglo + w2) f32.
extern "C" int vil_self_attention_fwd(const void* q, const void* k, const void* v,
                                      const void* k_glo, const void* v_glo, const void* bias,
                                      const void* mask, void* out, void* lse, int B, int mx,
                                      int my, int w2, int C, int H, int nglo, int wq,
                                      int is_bf16, int bf16_exp,
                                      void* stream) {
  auto* s = static_cast<cudaStream_t>(stream);
  auto* bias_f = static_cast<const float*>(bias);
  auto* mask_f = static_cast<const float*>(mask);
  auto* lse_f = static_cast<float*>(lse);
  const vil::SelfNbh nbh{};
  if (is_bf16)
    return vil::launch_vil_mode<__nv_bfloat16>(q, k, v, k_glo, v_glo, bias_f, mask_f, out,
                                               lse_f, B, mx, my, w2, C, H, nglo, wq, nbh,
                                               bf16_exp != 0, s);
  return vil::launch_vil_mode<float>(q, k, v, k_glo, v_glo, bias_f, mask_f, out, lse_f, B, mx,
                                     my, w2, C, H, nglo, wq, nbh, bf16_exp != 0, s);
}
