// Halo-input sliding-chunk attention forward for Hopper (sm_90a): the local
// branch of spatial (chunk-row) parallelism.
//
// Replaces the TPU kernel vil_tpu/ops/pallas/vil_kernel.py::_pallas_forward_halo
// (Pallas body _mh_kernel_img_halo). A spatial shard holds mx chunk rows of q
// and mx + 2 rows of K and V: its own rows between the previous shard's last
// row and the next shard's first, exchanged by parallel/spatial.py. For every
// query chunk (i, j) of the shard and every head h:
//
//   S   = q · [K_glo ‖ K of the 3x3 chunk neighbourhood]ᵀ + bias + mask
//   out = softmax(S) · [V_glo ‖ V_nbh]              (softmax in f32)
//   lse = log Σ exp(S)   per query row, f32, when asked for (training)
//
// Neighbour n = 0..8, (dx, dy) = (n / 3 - 1, n % 3 - 1), is K/V chunk
// (i + dx + 1, (j + dy) mod my): the row is not wrapped, since the halo rows
// are the wrap. Columns are in front order [glo ‖ nbh 0 ‖ ... ‖ nbh 8]; the
// mask (mx, my, Wq, Nglo+9W²) holds this shard's rows of the whole image's
// table. The TPU kernel takes a table of distinct mask rows and a traced row
// class per row instead, to save VMEM and SMEM; a Hopper block reads its own
// chunk's mask row from device memory, so the rows are passed as they are.
//
// What bounds it on an H100: what bounds B1 (vil_attention_fwd.cu), on a
// shard of 1/D of the image's rows, plus two rows of K and V: the f32 FMAs on
// the CUDA cores and the shared-memory reads that feed them.
//
// What the design does about it. It is B1's kernel over another
// neighbourhood: the body is sliding_chunk_fwd (sliding_chunk.cuh) over
// HaloNbh, which reads K/V row i + dx + 1 of the extended buffer where B1
// reads row (i + dx) mod mx. No neighbourhood is materialised.
#include "sliding_chunk.cuh"

namespace vil {

template <typename T, int M>
__global__ void __launch_bounds__(kThreads)
vil_attention_halo_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k_ext,
                              const T* __restrict__ v_ext, const T* __restrict__ k_glo,
                              const T* __restrict__ v_glo, const float* __restrict__ bias,
                              const float* __restrict__ mask, T* __restrict__ out,
                              float* __restrict__ lse, int mx, int my, int w2, int C, int nglo,
                              int wq) {
  sliding_chunk_fwd<T, M>(HaloNbh{}, q, k_ext, v_ext, k_glo, v_glo, bias, mask, out, lse, mx, my,
                          w2, C, nglo, wq);
}

template <typename T>
cudaError_t launch_vil_halo(const void* q, const void* k_ext, const void* v_ext,
                            const void* k_glo, const void* v_glo, const float* bias,
                            const float* mask, void* out, float* lse, int B, int mx, int my,
                            int w2, int C, int H, int nglo, int wq, cudaStream_t stream) {
  return dispatch_head_dim(C / H, [&](auto m) {
    constexpr int M = decltype(m)::value;
    return launch(vil_attention_halo_fwd_kernel<T, M>, dim3(mx * my, H, B),
                  fwd_smem_bytes(w2, M), stream, (const T*)q, (const T*)k_ext, (const T*)v_ext,
                  (const T*)k_glo, (const T*)v_glo, bias, mask, (T*)out, lse, mx, my, w2, C,
                  nglo, wq);
  });
}

}  // namespace vil

// q, out (B, mx, my, w2, C); k_ext, v_ext (B, mx + 2, my, w2, C); k_glo,
// v_glo (B, nglo, C) or null when nglo is 0; bias (H, w2, nglo + 9 w2) f32 or
// null; mask (mx, my, wq, nglo + 9 w2) f32, this shard's rows; lse
// (B, H, mx, my, w2) f32 or null. All contiguous. Returns the launch's error.
extern "C" int vil_attention_halo_fwd(const void* q, const void* k_ext, const void* v_ext,
                                      const void* k_glo, const void* v_glo, const void* bias,
                                      const void* mask, void* out, void* lse, int B, int mx,
                                      int my, int w2, int C, int H, int nglo, int wq,
                                      int is_bf16, void* stream) {
  auto* s = static_cast<cudaStream_t>(stream);
  auto* bias_f = static_cast<const float*>(bias);
  auto* mask_f = static_cast<const float*>(mask);
  auto* lse_f = static_cast<float*>(lse);
  if (is_bf16)
    return vil::launch_vil_halo<__nv_bfloat16>(q, k_ext, v_ext, k_glo, v_glo, bias_f, mask_f, out,
                                               lse_f, B, mx, my, w2, C, H, nglo, wq, s);
  return vil::launch_vil_halo<float>(q, k_ext, v_ext, k_glo, v_glo, bias_f, mask_f, out, lse_f, B,
                                     mx, my, w2, C, H, nglo, wq, s);
}
