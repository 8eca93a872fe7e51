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
// (B, H, mx, my, W²) when asked for. The attention is B1's, column order
// [glo ‖ nbh 0 ‖ ... ‖ nbh 8].
//
// What bounds it on an H100. The four projections are 8 R C² FLOPs and the
// attention 4 R C (nglo + 9 W²) (R = B mx my W² rows); the function reads x
// and writes y, k, v (and lse), 2 bytes a value in bf16. At ViL-Small's
// widths (C = 96, 192; 442 key columns) that is ≈ 310-410 FLOP/B, above the
// bf16 tensor-core ridge (~295 FLOP/B): the products' rate sets the least
// time (PERF.md: 0.1138 ms per fused step), though q, k, v and attn add
// four more round trips of R C values through device memory (below).
//
// The kernels are chosen by the operand dtype, each with a name of its own:
//
// bf16 (the main path: the fused configuration's serving forward and
// training step), every product on the tensor cores (wgmma, tiles by
// cp.async):
//   vil_block_fwd_proj_qkv_wgmma  q, k, v = x·W + b (gemm_tc.cuh,
//       gemm_tc_nn): one warpgroup per (64 rows, projection), every output
//       column of the projection in the block (NB 64-column sub-tiles, C >
//       256 in blocks along y); W is in (in, out) layout, so it is read
//       MN-major through the ring, with no transposed copy. The projection
//       is the fastest-moving index of blockIdx.x, so the three blocks that
//       read one 64-row tile of x run side by side and two of them find it
//       in L2: x crosses device memory about once. The f32 bias is added in
//       the epilogue before the one rounding to bf16, as _project_rows does
//       (vil_tpu/ops/pallas/vil_block.py:94-97); a null bias adds nothing.
//   vil_block_fwd_attn_wgmma  B1's flash body (sliding_chunk_fwd_tc over
//       FullNbh, sliding_chunk_tc.cuh) by B1's own launch
//       (launch_full_fwd_tc): one warpgroup per (64-row slice of a query
//       chunk, head, image), the keys in 64-column tiles of the concatenated
//       [glo ‖ 9 chunks], P rounded to bf16 before P·V where the TPU kernel
//       rounds it (vil_kernel.py:332, :391); the LSE when asked for.
//   vil_block_fwd_proj_out_wgmma  y = attn·Wo + bo, the same product.
// The TPU kernel holds a whole image in VMEM so that no projection output
// makes a round trip through HBM; here q, k, v and attn each make one, in
// bf16 (k and v are outputs anyway, q and attn are kept for the backward),
// which at ViL-Small's widths costs less than the products would lose by
// being fused into the attention. So the kernels take any grid (padded,
// cyclic 1 x 2 and 2 x 2) and have no VMEM gate.
//
// f32 (the parity checks' operands, which need f32 arithmetic; the tensor
// cores take no f32 operands): the CUDA-core kernels vil_block_fwd_proj_qkv
// (gemm.cuh, gridDim.z = 3), vil_block_fwd_attention (B1's CUDA-core body,
// sliding_chunk_fwd over FullNbh, sliding_chunk.cuh: one block per (chunk,
// head, image), P in f32) and vil_block_fwd_proj_out.
#include "gemm.cuh"
#include "gemm_tc.cuh"
#include "sliding_chunk_tc.cuh"

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

// The three input projections of the bf16 path: weights, f32 biases (or
// null) and outputs of q, k and v.
struct TcProjections {
  const bf16* w[3];
  const float* b[3];
  bf16* y[3];
};

// grid (3 · ceil(R / 64), column blocks): block x computes projection x % 3
// of the 64 rows from 64 (x / 3).
template <int NB>
__global__ void __launch_bounds__(kTcThreads)
vil_block_fwd_proj_qkv_wgmma(const bf16* __restrict__ x, TcProjections p, int R, int C) {
  const int z = blockIdx.x % 3;
  gemm_tc_nn<NB>(x, p.w[z], p.b[z], p.y[z], R, C, C, blockIdx.x / 3 * kGemmTile,
                 blockIdx.y * NB * kGemmTile);
}

template <int M>
__global__ void __launch_bounds__(kTcThreads)
vil_block_fwd_attn_wgmma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, const bf16* __restrict__ k_glo,
                         const bf16* __restrict__ v_glo, const float* __restrict__ bias,
                         const float* __restrict__ mask, bf16* __restrict__ out,
                         float* __restrict__ lse, int mx, int my, int w2, int C, int nglo,
                         int wq, bool bf16_exp) {
  sliding_chunk_fwd_tc<M>(FullNbh{}, q, k, v, k_glo, v_glo, bias, mask, out, lse, mx, my, w2, C,
                          nglo, wq, bf16_exp);
}

template <int NB>
__global__ void __launch_bounds__(kTcThreads)
vil_block_fwd_proj_out_wgmma(const bf16* __restrict__ attn, const bf16* __restrict__ wo,
                             const float* __restrict__ bo, bf16* __restrict__ y, int R, int C) {
  gemm_tc_nn<NB>(attn, wo, bo, y, R, C, C, blockIdx.x * kGemmTile, blockIdx.y * NB * kGemmTile);
}

// The bf16 kernels (the note at the top), in the order of the f32 ones of
// launch_block_fwd below.
inline cudaError_t launch_block_fwd_tc(const bf16* x, const bf16* wq, const bf16* wk,
                                       const bf16* wv, const float* bq, const float* bk,
                                       const float* bv, const bf16* wo, const float* bo,
                                       const bf16* k_glo, const bf16* v_glo, const float* bias,
                                       const float* mask, bf16* q, bf16* k, bf16* v, bf16* attn,
                                       bf16* y, float* lse, int B, int mx, int my, int w2, int C,
                                       int H, int nglo, int wq_rows, bool bf16_exp,
                                       cudaStream_t stream) {
  const int R = B * mx * my * w2;
  const int row_tiles = (R + kGemmTile - 1) / kGemmTile;
  cudaError_t err = dispatch_col_tiles(C, [&](auto nb) {
    constexpr int NB = decltype(nb)::value;
    const dim3 grid(3 * row_tiles, (C + NB * kGemmTile - 1) / (NB * kGemmTile));
    return launch_with(vil_block_fwd_proj_qkv_wgmma<NB>, grid, kTcThreads,
                       gemm_tc_smem_bytes(NB), stream, x,
                       TcProjections{{wq, wk, wv}, {bq, bk, bv}, {q, k, v}}, R, C);
  });
  if (err != cudaSuccess) return err;
  err = launch_full_fwd_tc([](auto m) { return vil_block_fwd_attn_wgmma<decltype(m)::value>; },
                           q, k, v, k_glo, v_glo, bias, mask, attn, lse, B, mx, my, w2, C, H,
                           nglo, wq_rows, bf16_exp, stream);
  if (err != cudaSuccess) return err;
  return dispatch_col_tiles(C, [&](auto nb) {
    constexpr int NB = decltype(nb)::value;
    const dim3 grid(row_tiles, (C + NB * kGemmTile - 1) / (NB * kGemmTile));
    return launch_with(vil_block_fwd_proj_out_wgmma<NB>, grid, kTcThreads,
                       gemm_tc_smem_bytes(NB), stream, (const bf16*)attn, wo, bo, y, R, C);
  });
}

inline dim3 proj_grid(int R, int C, int problems) {
  return dim3((R + kTileM - 1) / kTileM, (C + kTileN - 1) / kTileN, problems);
}

template <typename T>
cudaError_t launch_block_fwd(const T* x, const T* wq, const T* wk, const T* wv, const float* bq,
                             const float* bk, const float* bv, const T* wo, const float* bo,
                             const T* k_glo, const T* v_glo, const float* bias, const float* mask,
                             T* q, T* k, T* v, T* attn, T* y, float* lse, int B, int mx, int my,
                             int w2, int C, int H, int nglo, int wq_rows, bool bf16_exp,
                             cudaStream_t stream) {
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
// All contiguous; C a multiple of 8 and the bf16 operands 16-byte aligned.
// Launches the three kernels on `stream`; returns the first launch error.
extern "C" int vil_block_fwd(const void* x, const void* wq, const void* wk, const void* wv,
                             const void* bq, const void* bk, const void* bv, const void* wo,
                             const void* bo, const void* k_glo, const void* v_glo,
                             const void* bias, const void* mask, void* q, void* k, void* v,
                             void* attn, void* y, void* lse, int B, int mx, int my, int w2, int C,
                             int H, int nglo, int wq_rows, int is_bf16, int bf16_exp,
                             void* stream) {
  auto* s = static_cast<cudaStream_t>(stream);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto run = [&](auto tag) {
    using T = decltype(tag);
    auto call = [&](auto fn) {
      return fn((const T*)x, (const T*)wq, (const T*)wk, (const T*)wv, f(bq), f(bk), f(bv),
                (const T*)wo, f(bo), (const T*)k_glo, (const T*)v_glo, f(bias), f(mask), (T*)q,
                (T*)k, (T*)v, (T*)attn, (T*)y, static_cast<float*>(lse), B, mx, my, w2, C, H,
                nglo, wq_rows, bf16_exp != 0, s);
    };
    if constexpr (std::is_same_v<T, float>) return call(vil::launch_block_fwd<float>);
    else return call(vil::launch_block_fwd_tc);
  };
  return is_bf16 ? run(__nv_bfloat16{}) : run(float{});
}
