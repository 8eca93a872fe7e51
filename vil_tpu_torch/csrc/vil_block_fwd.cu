// Fused attention block forward for Hopper (sm_90a).
//
// Replaces the TPU kernel vil_tpu/ops/pallas/vil_block.py::_pallas_block_forward
// (Pallas body _block_fwd_kernel): the query/key/value projections, the 2-D
// sliding-chunk attention and the output projection of one ViL attention
// block at neighbour mode 0. For x (B, mx, my, W², C), the LayerNorm output,
// and weights (C, C) in (in, out) layout, y = x · W:
//
//   q = x · Wq + bq,  k = x · Wk + bk,  v = x · Wv + bv     (f32 sums, rounded to T)
//   attn = softmax(q · [K_glo ‖ K_nbh]ᵀ + bias + mask) · [V_glo ‖ V_nbh]
//   y = attn · Wo + bo
//
// Wq and bq arrive scaled by M^-1/2; biases are f32 (bq, bk, bv may be null).
// k and v are outputs (the block's global branch reads them), and so are q
// and attn, which the backward reads instead of recomputing them; lse
// (B, H, mx, my, W²) when asked for. The attention is B1's body
// (sliding_chunk_fwd over FullNbh, sliding_chunk.cuh), column order
// [glo ‖ nbh 0 ‖ ... ‖ nbh 8].
//
// Three kernels, each with a name of its own: vil_block_fwd_proj_qkv (the
// three input projections, gridDim.z = 3), vil_block_fwd_attention (one block
// per (chunk, head, image), as B1) and vil_block_fwd_proj_out.
//
// What bounds it on an H100. The four projections are 8 R C² FLOPs over
// about 10 R C bytes in bf16 (R = B mx my W² rows): 0.8 C FLOP/B, under the
// bf16 tensor-core ridge (~295 FLOP/B) at C = 96..192, so with tensor cores
// the block would be bound by device memory. Here they run on the CUDA
// cores (gemm.cuh), where they are bound by f32 FMA issue, and the attention
// as B1 is (PERF.md).
//
// What the design does about it. Nothing of the TPU kernel's whole-image
// staging is kept: the TPU kernel holds an image in VMEM so that no
// projection output makes a round trip through HBM; here q, k, v and attn
// make one each, in T, which at ViL-Small's widths costs less than the
// GEMMs. So the kernels take any grid (padded, cyclic 1 x 2 and 2 x 2) and
// have no VMEM gate.
#include "gemm.cuh"
#include "sliding_chunk.cuh"

namespace vil {

template <typename T>
struct QkvProjection {
  const T* w[3];
  const float* b[3];
  T* out[3];
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
vil_block_fwd_proj_qkv(const T* __restrict__ x, QkvProjection<T> p, int R, int C) {
  const int z = blockIdx.z;
  gemm_nn<T>(x, p.w[z], p.b[z], p.out[z], R, C, C);
}

template <typename T, int M>
__global__ void __launch_bounds__(kThreads)
vil_block_fwd_attention(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ k_glo,
                        const T* __restrict__ v_glo, const float* __restrict__ bias,
                        const float* __restrict__ mask, T* __restrict__ out,
                        float* __restrict__ lse, int mx, int my, int w2, int C, int nglo, int wq) {
  sliding_chunk_fwd<T, M>(FullNbh{}, q, k, v, k_glo, v_glo, bias, mask, out, lse, mx, my, w2, C,
                          nglo, wq);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
vil_block_fwd_proj_out(const T* __restrict__ attn, const T* __restrict__ wo,
                       const float* __restrict__ bo, T* __restrict__ y, int R, int C) {
  gemm_nn<T>(attn, wo, bo, y, R, C, C);
}

inline dim3 proj_grid(int R, int C, int problems) {
  return dim3((R + kTileM - 1) / kTileM, (C + kTileN - 1) / kTileN, problems);
}

template <typename T>
cudaError_t launch_block_fwd(const T* x, const T* wq, const T* wk, const T* wv, const float* bq,
                             const float* bk, const float* bv, const T* wo, const float* bo,
                             const T* k_glo, const T* v_glo, const float* bias, const float* mask,
                             T* q, T* k, T* v, T* attn, T* y, float* lse, int B, int mx, int my,
                             int w2, int C, int H, int nglo, int wq_rows, cudaStream_t stream) {
  const int R = B * mx * my * w2;
  QkvProjection<T> proj{{wq, wk, wv}, {bq, bk, bv}, {q, k, v}};
  cudaError_t err = launch(vil_block_fwd_proj_qkv<T>, proj_grid(R, C, 3), 0, stream, x, proj, R, C);
  if (err != cudaSuccess) return err;
  err = dispatch_head_dim(C / H, [&](auto m) {
    constexpr int M = decltype(m)::value;
    return launch(vil_block_fwd_attention<T, M>, dim3(mx * my, H, B), fwd_smem_bytes(w2, M),
                  stream, (const T*)q, (const T*)k, (const T*)v, k_glo, v_glo, bias, mask, attn,
                  lse, mx, my, w2, C, nglo, wq_rows);
  });
  if (err != cudaSuccess) return err;
  return launch(vil_block_fwd_proj_out<T>, proj_grid(R, C, 1), 0, stream, (const T*)attn, wo, bo,
                y, R, C);
}

}  // namespace vil

// x, q, k, v, attn, y (B, mx, my, w2, C); wq, wk, wv, wo (C, C) in x's type;
// bq, bk, bv (C) f32 or null, bo (C) f32; k_glo, v_glo (B, nglo, C) or null
// when nglo is 0; bias (H, w2, nglo + 9 w2) f32 or null; mask
// (mx, my, wq_rows, nglo + 9 w2) f32; lse (B, H, mx, my, w2) f32 or null.
// All contiguous. Launches the three kernels on `stream`; returns the first
// launch error.
extern "C" int vil_block_fwd(const void* x, const void* wq, const void* wk, const void* wv,
                             const void* bq, const void* bk, const void* bv, const void* wo,
                             const void* bo, const void* k_glo, const void* v_glo,
                             const void* bias, const void* mask, void* q, void* k, void* v,
                             void* attn, void* y, void* lse, int B, int mx, int my, int w2, int C,
                             int H, int nglo, int wq_rows, int is_bf16, void* stream) {
  auto* s = static_cast<cudaStream_t>(stream);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto run = [&](auto tag) {
    using T = decltype(tag);
    return vil::launch_block_fwd<T>(
        (const T*)x, (const T*)wq, (const T*)wk, (const T*)wv, f(bq), f(bk), f(bv), (const T*)wo,
        f(bo), (const T*)k_glo, (const T*)v_glo, f(bias), f(mask), (T*)q, (T*)k, (T*)v, (T*)attn,
        (T*)y, static_cast<float*>(lse), B, mx, my, w2, C, H, nglo, wq_rows, s);
  };
  return is_bf16 ? run(__nv_bfloat16{}) : run(float{});
}
