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
// about 220 FLOP/B: under the bf16 tensor-core ridge (~295 FLOP/B), so with
// tensor cores it would be bound by device memory. This first version does
// its arithmetic in f32 on the CUDA cores (ridge ~20 FLOP/B), so it is bound
// by instruction throughput: f32 FMAs and the shared-memory reads that feed
// them; PERF.md shows shared-memory bandwidth is the limit at stage 1.
//
// What the design does about it. One block per (b, chunk, head) reads each
// K/V chunk once per neighbour, from L2 after the first of its 9 readers, and
// keeps scores in registers: device memory sees only q, k, v and out. An
// online softmax over the 10 column tiles keeps shared memory at
// W²(4M+3) floats whatever the number of columns. Moving QKᵀ and P·V to
// tensor cores (mma.sync or wgmma, several chunks per block to fill 64-row
// tiles) is the next step.
//
// The body is sliding_chunk_fwd (sliding_chunk.cuh) over FullNbh; the
// sampled-neighbour forward of random-shift training (vil_mode_attention_fwd.cu)
// runs the same body over two chunks.
#include "sliding_chunk.cuh"

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

template <typename T>
cudaError_t launch_vil(const void* q, const void* k, const void* v, const void* k_glo,
                       const void* v_glo, const float* bias, const float* mask, void* out,
                       float* lse, int B, int mx, int my, int w2, int C, int H, int nglo, int wq,
                       cudaStream_t stream) {
  return dispatch_head_dim(C / H, [&](auto m) {
    constexpr int M = decltype(m)::value;
    return launch(vil_attention_fwd_kernel<T, M>, dim3(mx * my, H, B), fwd_smem_bytes(w2, M),
                  stream, (const T*)q, (const T*)k, (const T*)v, (const T*)k_glo,
                  (const T*)v_glo, bias, mask, (T*)out, lse, mx, my, w2, C, nglo, wq);
  });
}

}  // namespace vil

// q, k, v, out (B, mx, my, w2, C); k_glo, v_glo (B, nglo, C) or null when
// nglo is 0; bias (H, w2, nglo + 9 w2) f32 or null; mask
// (mx, my, wq, nglo + 9 w2) f32; lse (B, H, mx, my, w2) f32 or null. All
// contiguous. Returns the launch's error.
extern "C" int vil_attention_fwd(const void* q, const void* k, const void* v, const void* k_glo,
                                 const void* v_glo, const void* bias, const void* mask,
                                 void* out, void* lse, int B, int mx, int my, int w2, int C,
                                 int H, int nglo, int wq, int is_bf16, void* stream) {
  auto* s = static_cast<cudaStream_t>(stream);
  auto* bias_f = static_cast<const float*>(bias);
  auto* mask_f = static_cast<const float*>(mask);
  auto* lse_f = static_cast<float*>(lse);
  if (is_bf16)
    return vil::launch_vil<__nv_bfloat16>(q, k, v, k_glo, v_glo, bias_f, mask_f, out, lse_f, B,
                                          mx, my, w2, C, H, nglo, wq, s);
  return vil::launch_vil<float>(q, k, v, k_glo, v_glo, bias_f, mask_f, out, lse_f, B, mx, my,
                                w2, C, H, nglo, wq, s);
}

extern "C" const char* vil_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
