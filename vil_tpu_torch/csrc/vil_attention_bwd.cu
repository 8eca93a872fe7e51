// Sliding-chunk attention backward for Hopper (sm_90a).
//
// Replaces the TPU kernel vil_tpu/ops/pallas/vil_backward.py::vil_attention_backward
// and its four VMEM tiers (_backward_whole_image, _backward_whole_image_loop,
// _backward_tiled, _backward_two_pass). Given the forward's inputs, its output
// `out`, its per-row log-sum-exp L and the upstream gradient g, with the
// forward's column order [glo ‖ nbh 0 ‖ ... ‖ nbh 8] (see vil_attention_fwd.cu):
//
//   P  = exp(S - L)            S recomputed as the forward formed it
//   dP = g · [V_glo ‖ V_nbh]ᵀ
//   δ  = rowsum(dP ∘ P) = rowsum(g ∘ out)
//   dS = P ∘ (dP - δ)
//   dQ = dS · [K_glo ‖ K_nbh]
//   dK, dV of each chunk = Σ over the 9 query chunks that see it of dSᵀ · q, Pᵀ · g
//
// Two kernels, in the gather form: no atomics, so the result is the same on
// every run.
//   pass 1, per query chunk, head and image: δ, dQ, the global columns P_glo
//     and dS_glo (the wrapper turns them into dK_glo and dV_glo with one
//     einsum each, as the TPU code does in XLA), and, when a bias is given,
//     dbias partials per (image, chunk group, head): the block then walks the
//     chunks_per_block chunks of its group, so each partial has one writer,
//     and the wrapper sums the partials (ops/kernels/vil_attention.py::
//     chunk_group picks the group so that the grid still fills the card).
//   pass 2, per key chunk (r, c), head and image: the query chunks
//     ((r - dx) mod mx, (c - dy) mod my) of the 9 offsets recompute P and dS
//     against this key chunk from the stored L and δ, accumulating
//     dK += dSᵀ · q and dV += Pᵀ · g (vil_backward.py _pass2_kernel). With mx
//     or my ≤ 2 one key chunk is several neighbours of the same query chunk;
//     each occurrence adds, as the forward visits each one.
//
// What bounds it on an H100. The five products (S, dP, dQ, dK, dV) are about
// 2.5x the forward's FLOPs: ViL-Small stage 1 per image 1.3 GFLOP over
// 4.8 MB of q, k, v, g, dq, dk, dv in bf16, ~280 FLOP/B, near the bf16
// tensor-core ridge (~295 FLOP/B) and far above the f32 CUDA-core ridge
// (~20 FLOP/B): the products belong on the tensor cores.
//
// The kernel is chosen by the operand dtype:
//
// bf16 (vil_attention_bwd_wgmma_pass1/2, the main path: the bf16 training
// step). One warpgroup a block, seven products per tile pair, all by wgmma,
// on the bodies of sliding_chunk_tc.cuh over FullNbh: pass 1 takes δ =
// rowsum(g ∘ out) in its prologue and sweeps the concatenated
// [glo ‖ 9 chunks] keys once in 64-key tiles; pass 2 sweeps the concatenated
// query rows of the 9 chunks that see its key chunk. P and dS are rounded to
// bf16 before their products, where the TPU kernel rounds them.
//
// f32 (vil_attention_bwd_pass1/2). The tensor cores take no f32 operands, and
// the f32 inputs are the parity checks' (one training step's gradients within
// 1e-4 of the plain version), which need f32 arithmetic. So f32 keeps the
// CUDA-core bodies sliding_chunk_bwd_pass1/2 (sliding_chunk.cuh; the
// sampled-neighbour backward vil_mode_attention_bwd.cu runs them over two
// chunks): one warp per row, δ by a first sweep of pass 1 (`out` is not
// read), S recomputed with the forward's fmaf chain so that P = exp(S - L)
// uses the very S whose L the forward stored.
#include "sliding_chunk_tc.cuh"

namespace vil {

template <typename T, int M>
__global__ void __launch_bounds__(kThreads)
vil_attention_bwd_pass1(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ k_glo,
                        const T* __restrict__ v_glo, const T* __restrict__ g,
                        const float* __restrict__ bias, const float* __restrict__ mask,
                        const float* __restrict__ lse, float* __restrict__ delta,
                        T* __restrict__ dq, float* __restrict__ p_glo,
                        float* __restrict__ ds_glo, float* __restrict__ dbias_part, int mx,
                        int my, int w2, int C, int nglo, int wq, int chunks_per_block) {
  sliding_chunk_bwd_pass1<T, M>(FullNbh{}, q, k, v, k_glo, v_glo, g, bias, mask, lse, delta, dq,
                                p_glo, ds_glo, dbias_part, mx, my, w2, C, nglo, wq,
                                chunks_per_block);
}

template <typename T, int M>
__global__ void __launch_bounds__(kThreads)
vil_attention_bwd_pass2(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ g,
                        const float* __restrict__ bias, const float* __restrict__ mask,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        T* __restrict__ dk, T* __restrict__ dv, int mx, int my, int w2, int C,
                        int nglo, int wq) {
  sliding_chunk_bwd_pass2<T, M>(FullNbh{}, q, k, v, g, bias, mask, lse, delta, dk, dv, mx, my,
                                w2, C, nglo, wq);
}

// kBiased: the instance with a bias (its tiles' bias and dbias values
// loaded before the products; sliding_chunk_tc.cuh)
template <int M, bool kBiased>
__global__ void __launch_bounds__(kTcThreads)
vil_attention_bwd_wgmma_pass1(const bf16* __restrict__ q, const bf16* __restrict__ k,
                              const bf16* __restrict__ v, const bf16* __restrict__ k_glo,
                              const bf16* __restrict__ v_glo, const bf16* __restrict__ g,
                              const bf16* __restrict__ out, const float* __restrict__ bias,
                              const float* __restrict__ mask, const float* __restrict__ lse,
                              float* __restrict__ delta, bf16* __restrict__ dq,
                              float* __restrict__ p_glo, float* __restrict__ ds_glo,
                              float* __restrict__ dbias_part, int mx, int my, int w2, int C,
                              int nglo, int wq, int chunks_per_block, bool bf16_exp) {
  sliding_chunk_bwd_tc_pass1<M, FullNbh, kBiased>(FullNbh{}, q, k, v, k_glo, v_glo, g, out, bias,
                                                 mask, lse, delta, dq, p_glo, ds_glo, dbias_part,
                                                 mx, my, w2, C, nglo, wq, chunks_per_block,
                                                 bf16_exp);
}

template <int M>
__global__ void __launch_bounds__(kTcThreads)
vil_attention_bwd_wgmma_pass2(const bf16* __restrict__ q, const bf16* __restrict__ k,
                              const bf16* __restrict__ v, const bf16* __restrict__ g,
                              const float* __restrict__ bias, const float* __restrict__ mask,
                              const float* __restrict__ lse, const float* __restrict__ delta,
                              bf16* __restrict__ dk, bf16* __restrict__ dv, int mx, int my,
                              int w2, int C, int nglo, int wq, bool bf16_exp) {
  sliding_chunk_bwd_tc_pass2<M>(FullNbh{}, q, k, v, g, bias, mask, lse, delta, dk, dv, mx, my, w2,
                                C, nglo, wq, bf16_exp);
}

template <typename T>
cudaError_t launch_vil_bwd(const void* q, const void* k, const void* v, const void* k_glo,
                           const void* v_glo, const void* g, const void* out, const float* bias,
                           const float* mask, const float* lse, float* delta, void* dq,
                           void* dk, void* dv, float* p_glo, float* ds_glo, float* dbias_part,
                           int B, int mx, int my, int w2, int C, int H, int nglo, int wq,
                           int chunks_per_block, bool bf16_exp, cudaStream_t stream) {
  // with a bias, one block walks a group of chunks (one writer per dbias
  // partial); without, one block per chunk
  const int per_block = dbias_part != nullptr ? chunks_per_block : 1;
  const int groups = (mx * my + per_block - 1) / per_block;
  return dispatch_head_dim(C / H, [&](auto m) {
    constexpr int M = decltype(m)::value;
    if constexpr (std::is_same_v<T, bf16>) {
      const int slices = (w2 + kTcRows - 1) / kTcRows;  // 64-row slices of a chunk
      auto pass1 = [&](auto kernel) {
        return launch_with(kernel, dim3(groups * slices, H, B), kTcThreads,
                           tc_pass1_smem_bytes(M), stream, (const T*)q, (const T*)k,
                           (const T*)v, (const T*)k_glo, (const T*)v_glo, (const T*)g,
                           (const T*)out, bias, mask, lse, delta, (T*)dq, p_glo, ds_glo,
                           dbias_part, mx, my, w2, C, nglo, wq, per_block, bf16_exp);
      };
      cudaError_t err = dbias_part != nullptr ? pass1(vil_attention_bwd_wgmma_pass1<M, true>)
                                              : pass1(vil_attention_bwd_wgmma_pass1<M, false>);
      if (err != cudaSuccess) return err;
      return launch_with(vil_attention_bwd_wgmma_pass2<M>, dim3(mx * my * slices, H, B),
                         kTcThreads, tc_pass2_smem_bytes(M), stream, (const T*)q, (const T*)k,
                         (const T*)v, (const T*)g, bias, mask, lse, (const float*)delta, (T*)dk,
                         (T*)dv, mx, my, w2, C, nglo, wq, bf16_exp);
    } else {
      cudaError_t err = launch(vil_attention_bwd_pass1<T, M>, dim3(groups, H, B),
                               pass1_smem_bytes(w2, M), stream, (const T*)q, (const T*)k,
                               (const T*)v, (const T*)k_glo, (const T*)v_glo, (const T*)g, bias,
                               mask, lse, delta, (T*)dq, p_glo, ds_glo, dbias_part, mx, my, w2,
                               C, nglo, wq, per_block);
      if (err != cudaSuccess) return err;
      return launch(vil_attention_bwd_pass2<T, M>, dim3(mx * my, H, B), pass2_smem_bytes(w2, M),
                    stream, (const T*)q, (const T*)k, (const T*)v, (const T*)g, bias, mask, lse,
                    (const float*)delta, (T*)dk, (T*)dv, mx, my, w2, C, nglo, wq);
    }
  });
}

}  // namespace vil

// q, k, v, g, out, dq, dk, dv (B, mx, my, w2, C), `out` the forward's
// output (read by the bf16 kernels for δ); k_glo, v_glo (B, nglo, C) or null
// when nglo is 0; bias (H, w2, nglo + 9 w2) f32 or null; mask
// (mx, my, wq, nglo + 9 w2) f32; lse and delta (B, H, mx, my, w2) f32;
// p_glo, ds_glo (B, H, mx, my, w2, nglo) f32 or null when nglo is 0;
// dbias_part (B, groups, H, w2, nglo + 9 w2) f32, zero on entry, groups =
// ceil(mx my / chunks_per_block), or null without a bias (chunks_per_block
// is then not read). All contiguous, bf16 operands 16-byte aligned. Launches
// both passes on `stream`; returns the first launch error.
extern "C" int vil_attention_bwd(const void* q, const void* k, const void* v, const void* k_glo,
                                 const void* v_glo, const void* g, const void* out,
                                 const void* bias, const void* mask, const void* lse,
                                 void* delta, void* dq,
                                 void* dk, void* dv, void* p_glo, void* ds_glo,
                                 void* dbias_part, int B, int mx, int my, int w2, int C, int H,
                                 int nglo, int wq, int chunks_per_block, int is_bf16, int bf16_exp,
                                void* stream) {
  if (dbias_part != nullptr && chunks_per_block < 1) return cudaErrorInvalidValue;
  auto* s = static_cast<cudaStream_t>(stream);
  auto* bias_f = static_cast<const float*>(bias);
  auto* mask_f = static_cast<const float*>(mask);
  auto* lse_f = static_cast<const float*>(lse);
  auto* delta_f = static_cast<float*>(delta);
  auto* pg = static_cast<float*>(p_glo);
  auto* dsg = static_cast<float*>(ds_glo);
  auto* db = static_cast<float*>(dbias_part);
  if (is_bf16)
    return vil::launch_vil_bwd<__nv_bfloat16>(q, k, v, k_glo, v_glo, g, out, bias_f, mask_f,
                                              lse_f, delta_f, dq, dk, dv, pg, dsg, db, B, mx, my,
                                              w2, C, H, nglo, wq, chunks_per_block, bf16_exp != 0,
                                              s);
  return vil::launch_vil_bwd<float>(q, k, v, k_glo, v_glo, g, out, bias_f, mask_f, lse_f, delta_f,
                                    dq, dk, dv, pg, dsg, db, B, mx, my, w2, C, H, nglo, wq,
                                    chunks_per_block, bf16_exp != 0, s);
}
