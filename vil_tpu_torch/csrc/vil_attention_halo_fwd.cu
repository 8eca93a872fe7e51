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
// What bounds it on an H100: device memory, as for B1 (vil_attention_fwd.cu),
// on a shard of 1/D of the image's rows plus two halo rows of K and V. For
// ViL-Small 224² at batch 64 on one rank (D = 1), one serving forward's three
// launches read q, the extended K/V, the global rows and the mask and write
// out: 0.1094 ms at 3.35 TB/s (PERF.md), above their time at the bf16
// tensor-core peak.
//
// The kernel is chosen by the operand dtype:
//
// bf16 (vil_attention_halo_fwd_wgmma, the main path: the spatial serving
// forward and the spatial backward's forward). It is B1's tensor-core kernel
// over another neighbourhood: the body is sliding_chunk_fwd_tc
// (sliding_chunk_tc.cuh) over HaloNbh, launched as B1 launches it, one
// warpgroup per (64-row slice of a query chunk, head, image). Its 64-key
// tiles of the concatenated [glo ‖ 9 chunks] keys are staged by cp.async
// through ConcatKeys, whose row address for HaloNbh is K/V row i + dx + 1 of
// the mx + 2 rows (kv_rows, key_row in sliding_chunk.cuh), in a three-stage
// ring; S = Q·Kᵀ and O += P·V by wgmma, the online softmax in registers.
// What differs from the whole grid is the row addressing alone: q, out, the
// mask rows (mask + chunk · Wq · cols) and the LSE are indexed over the
// shard's own mx x my chunks, and a halo row is read, never written. No
// neighbourhood is materialised.
//
// f32 (vil_attention_halo_fwd_kernel): the CUDA-core body sliding_chunk_fwd
// (sliding_chunk.cuh) over HaloNbh, in full f32 for the whole-model parity
// checks (the tensor cores take no f32 operands).
#include "sliding_chunk_tc.cuh"

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

template <int M>
__global__ void __launch_bounds__(kTcThreads)
vil_attention_halo_fwd_wgmma(const bf16* __restrict__ q, const bf16* __restrict__ k_ext,
                             const bf16* __restrict__ v_ext, const bf16* __restrict__ k_glo,
                             const bf16* __restrict__ v_glo, const float* __restrict__ bias,
                             const float* __restrict__ mask, bf16* __restrict__ out,
                             float* __restrict__ lse, int mx, int my, int w2, int C, int nglo,
                             int wq, bool bf16_exp) {
  sliding_chunk_fwd_tc<M>(HaloNbh{}, q, k_ext, v_ext, k_glo, v_glo, bias, mask, out, lse, mx, my,
                          w2, C, nglo, wq, bf16_exp);
}

template <typename T>
cudaError_t launch_vil_halo(const void* q, const void* k_ext, const void* v_ext,
                            const void* k_glo, const void* v_glo, const float* bias,
                            const float* mask, void* out, float* lse, int B, int mx, int my,
                            int w2, int C, int H, int nglo, int wq, bool bf16_exp,
                            cudaStream_t stream) {
  return dispatch_head_dim(C / H, [&](auto m) {
    constexpr int M = decltype(m)::value;
    if constexpr (std::is_same_v<T, bf16>) {
      const int slices = (w2 + kTcRows - 1) / kTcRows;  // 64-row slices of a chunk
      return launch_with(vil_attention_halo_fwd_wgmma<M>, dim3(slices * mx * my, H, B),
                         kTcThreads, tc_fwd_smem_bytes(M, nglo + HaloNbh::kCount * w2), stream,
                         (const T*)q, (const T*)k_ext, (const T*)v_ext, (const T*)k_glo,
                         (const T*)v_glo, bias, mask, (T*)out, lse, mx, my, w2, C, nglo, wq,
                         bf16_exp);
    } else {
      return launch(vil_attention_halo_fwd_kernel<T, M>, dim3(mx * my, H, B),
                    fwd_smem_bytes(w2, M), stream, (const T*)q, (const T*)k_ext,
                    (const T*)v_ext, (const T*)k_glo, (const T*)v_glo, bias, mask, (T*)out, lse,
                    mx, my, w2, C, nglo, wq);
    }
  });
}

}  // namespace vil

// q, out (B, mx, my, w2, C); k_ext, v_ext (B, mx + 2, my, w2, C); k_glo,
// v_glo (B, nglo, C) or null when nglo is 0; bias (H, w2, nglo + 9 w2) f32 or
// null; mask (mx, my, wq, nglo + 9 w2) f32, this shard's rows; lse
// (B, H, mx, my, w2) f32 or null. All contiguous, bf16 operands 16-byte
// aligned. Returns the launch's error.
extern "C" int vil_attention_halo_fwd(const void* q, const void* k_ext, const void* v_ext,
                                      const void* k_glo, const void* v_glo, const void* bias,
                                      const void* mask, void* out, void* lse, int B, int mx,
                                      int my, int w2, int C, int H, int nglo, int wq,
                                      int is_bf16, int bf16_exp,
                                      void* stream) {
  auto* s = static_cast<cudaStream_t>(stream);
  auto* bias_f = static_cast<const float*>(bias);
  auto* mask_f = static_cast<const float*>(mask);
  auto* lse_f = static_cast<float*>(lse);
  if (is_bf16)
    return vil::launch_vil_halo<__nv_bfloat16>(q, k_ext, v_ext, k_glo, v_glo, bias_f, mask_f, out,
                                               lse_f, B, mx, my, w2, C, H, nglo, wq, bf16_exp != 0,
                                               s);
  return vil::launch_vil_halo<float>(q, k_ext, v_ext, k_glo, v_glo, bias_f, mask_f, out, lse_f, B,
                                     mx, my, w2, C, H, nglo, wq, bf16_exp != 0, s);
}
