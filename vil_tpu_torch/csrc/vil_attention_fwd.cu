// Sliding-chunk attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel vil_tpu/ops/pallas/vil_kernel.py::_pallas_forward_mh
// (Pallas bodies _mh_kernel_img, _mh_kernel_img_loop, _mh_kernel_kv_res,
// _mh_kernel). For every query chunk (i, j) of an mx x my grid of W x W
// chunks and every head h:
//
//   S   = q · [K_glo ‖ K of the 3x3 cyclic chunk neighbourhood]ᵀ + bias + mask
//   out = softmax(S) · [V_glo ‖ V_nbh]              (softmax in f32)
//   lse = log Σ exp(S)   per query row, f32, when asked for (training)
//
// Neighbour n = 0..8 is chunk ((i + dx) mod mx, (j + dy) mod my) with
// (dx, dy) = (n / 3 - 1, n % 3 - 1), the order of masks.NEIGHBOR_OFFSETS.
// Score columns are in front order [glo ‖ nbh 0 ‖ ... ‖ nbh 8], as the
// bias (H, W², Nglo+9W²) and mask (mx, my, Wq, Nglo+9W²) tables have them;
// Wq is 1 (one mask row per chunk) or W² (one per query pixel, SW_EXACT 1).
// q arrives scaled by M^-1/2; the kernel does not scale.
//
// What bounds it on an H100. ViL-Small stage 1 per image: q, k, v and out
// are 4 x 3136 x 96 bf16 = 2.41 MB, and 2 x 2 x 3136 x 442 x 96 = 0.53 GFLOP,
// about 220 FLOP/B: under the bf16 tensor-core ridge (~295 FLOP/B), so on the
// tensor cores device memory sets the least time: 0.0932 ms per training step
// (PERF.md), against 0.069 ms at the bf16 peak.
//
// The kernel is chosen by the operand dtype:
//
// bf16 (vil_attention_fwd_wgmma, the main path: serving and the bf16
// training step; body sliding_chunk_fwd_tc, sliding_chunk_tc.cuh). One
// warpgroup (128 threads) per (64-row slice of a query chunk, head, image):
// 12288 blocks at stage 1 and 3072 at stage 2 for ViL-Small at batch 64. A
// chunk's 49 rows pad the slice to 64; W² > 64 takes several slices.
//   - The keys of a query chunk are cut into 64-column tiles of the
//     concatenated [glo ‖ neighbour 0 ‖ ... ‖ 8] rows (442 columns in 7
//     tiles at nglo 1, 1% padding, where a tile per chunk would pad 23%);
//     each staged row's address comes from its column (ConcatKeys, shared
//     with the backward's pass 1), copied by cp.async 16 bytes a thread,
//     rows past the columns zero-filled by the copy itself, so no row of
//     another chunk or image is read.
//   - The ring holds 3 stages: two tiles are in flight while one is
//     multiplied. A tile's 128 rows come from up to three chunks scattered
//     over L2, and with one tile in flight (the backward's two-stage ring,
//     PERF.md) its latency is exposed; a fourth stage would cost a block 8 KB
//     (M = 32) to 32 KB (M = 128) of shared memory and blocks per SM.
//   - S = Q·Kᵀ by wgmma m64n64k16 from shared memory; bias and mask added
//     per element in base 2, columns past the list at -inf (P = 0). At
//     Wq = 1 (SW_EXACT 0, the main path) the chunk's mask row (cols f32,
//     1.7 KB at nglo 1) is staged in shared memory once per block, -inf
//     past the columns; at Wq = W² (SW_EXACT ±1)
//     each element is read from device memory (L1/L2), as the bias is. The
//     mask's fill is finite, so a row whose keys are all masked stays
//     finite.
//   - The online softmax in the accumulator's registers (a row's max by two
//     quad shuffles, l kept per thread and summed once at the end, from the
//     unrounded probabilities, so LSE = m + log l holds in f32); scores and
//     max in natural units, exp2 of (x - m) · log2 e.
//   - P rounded to bf16 into the register A operand, where the TPU kernel
//     rounds it (vil_kernel.py:391); O += P·V by wgmma, V read MN-major from
//     the same staging, so no transposed copy exists.
//   - Only the slice's valid rows of O / l are stored; the LSE (training)
//     when asked for, serving calls it without.
//
// f32 (vil_attention_fwd_kernel). The tensor cores take no f32 operands, and
// the f32 inputs are the parity checks' (whole-model logits within 1e-3 of
// the plain version), which need f32 arithmetic. So f32 keeps the CUDA-core
// body sliding_chunk_fwd (sliding_chunk.cuh): one block of 256 threads per
// (query chunk, head, image), one warp per query row, an online softmax over
// the column tiles (the global keys, then each neighbour chunk), W²(4M+3)
// floats of shared memory. The sampled-neighbour forward B5
// (vil_mode_attention_fwd.cu) runs that body in both dtypes; the halo
// forward B7a (vil_attention_halo_fwd.cu) runs both of B1's bodies, by dtype
// as B1 does.
#include "sliding_chunk_tc.cuh"

namespace vil {

template <typename T, int M>
__global__ void __launch_bounds__(kThreads)
vil_attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ k_glo,
                         const T* __restrict__ v_glo, const float* __restrict__ bias,
                         const float* __restrict__ mask, T* __restrict__ out,
                         float* __restrict__ lse, int mx, int my, int w2, int C, int nglo,
                         int wq) {
  sliding_chunk_fwd<T, M>(FullNbh{}, q, k, v, k_glo, v_glo, bias, mask, out, lse, mx, my, w2,
                          C, nglo, wq);
}

template <int M>
__global__ void __launch_bounds__(kTcThreads)
vil_attention_fwd_wgmma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const bf16* __restrict__ k_glo,
                        const bf16* __restrict__ v_glo, const float* __restrict__ bias,
                        const float* __restrict__ mask, bf16* __restrict__ out,
                        float* __restrict__ lse, int mx, int my, int w2, int C, int nglo,
                        int wq, bool bf16_exp) {
  sliding_chunk_fwd_tc<M>(FullNbh{}, q, k, v, k_glo, v_glo, bias, mask, out, lse, mx, my, w2, C,
                          nglo, wq, bf16_exp);
}

template <typename T>
cudaError_t launch_vil(const void* q, const void* k, const void* v, const void* k_glo,
                       const void* v_glo, const float* bias, const float* mask, void* out,
                       float* lse, int B, int mx, int my, int w2, int C, int H, int nglo, int wq,
                       bool bf16_exp, cudaStream_t stream) {
  if constexpr (std::is_same_v<T, bf16>) {
    return launch_full_fwd_tc(
        [](auto m) { return vil_attention_fwd_wgmma<decltype(m)::value>; }, (const T*)q,
        (const T*)k, (const T*)v, (const T*)k_glo, (const T*)v_glo, bias, mask, (T*)out, lse, B,
        mx, my, w2, C, H, nglo, wq, bf16_exp, stream);
  } else {
    return dispatch_head_dim(C / H, [&](auto m) {
      constexpr int M = decltype(m)::value;
      return launch(vil_attention_fwd_kernel<T, M>, dim3(mx * my, H, B), fwd_smem_bytes(w2, M),
                    stream, (const T*)q, (const T*)k, (const T*)v, (const T*)k_glo,
                    (const T*)v_glo, bias, mask, (T*)out, lse, mx, my, w2, C, nglo, wq);
    });
  }
}

}  // namespace vil

// q, k, v, out (B, mx, my, w2, C); k_glo, v_glo (B, nglo, C) or null when
// nglo is 0; bias (H, w2, nglo + 9 w2) f32 or null; mask
// (mx, my, wq, nglo + 9 w2) f32; lse (B, H, mx, my, w2) f32 or null. All
// contiguous, bf16 operands 16-byte aligned. Returns the launch's error.
extern "C" int vil_attention_fwd(const void* q, const void* k, const void* v, const void* k_glo,
                                 const void* v_glo, const void* bias, const void* mask,
                                 void* out, void* lse, int B, int mx, int my, int w2, int C,
                                 int H, int nglo, int wq, int is_bf16, int bf16_exp,
                                 void* stream) {
  auto* s = static_cast<cudaStream_t>(stream);
  auto* bias_f = static_cast<const float*>(bias);
  auto* mask_f = static_cast<const float*>(mask);
  auto* lse_f = static_cast<float*>(lse);
  if (is_bf16)
    return vil::launch_vil<__nv_bfloat16>(q, k, v, k_glo, v_glo, bias_f, mask_f, out, lse_f, B,
                                          mx, my, w2, C, H, nglo, wq, bf16_exp != 0, s);
  return vil::launch_vil<float>(q, k, v, k_glo, v_glo, bias_f, mask_f, out, lse_f, B, mx, my,
                                w2, C, H, nglo, wq, bf16_exp != 0, s);
}

extern "C" const char* vil_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
