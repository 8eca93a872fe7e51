// Fused attention block backward for Hopper (sm_90a).
//
// Replaces the TPU kernel vil_tpu/ops/pallas/vil_block.py::_pallas_block_backward
// (Pallas body _block_bwd_kernel). Given the forward's x, weights, the q, k,
// v and attn it wrote, its lse, and the gradient g of y (see
// vil_block_fwd.cu for the forward):
//
//   dattn = g · Woᵀ                  (rounded to T)
//   dWo = attnᵀ · g,  dbo = Σ_rows g
//   dq, dk, dv, P_glo, dS_glo, dbias partials: B2's two gather passes with
//       dattn in the place of B2's upstream gradient and attn in the place
//       of its forward output (δ = rowsum(dattn ∘ attn) in bf16)
//   dk_glo = Σ_rows dS_glo · q,  dv_glo = Σ_rows P_glo · dattn   (per head)
//   dx = dq · Wqᵀ + dk · Wkᵀ + dv · Wvᵀ
//   dWq = xᵀ · dq, dWk = xᵀ · dk, dWv = xᵀ · dv,  dbq, dbk, dbv = Σ_rows dq, dk, dv
//
// dx is written in T; every weight, bias and global-row gradient in f32. The
// TPU kernel recomputes q, k, v and attn from x; here the forward keeps them
// (four activations of x's size, in T). No atomics: the result is the same
// on every run.
//
// What bounds it on an H100. The three products (proj_out, wgrad, proj_in)
// are 16 R C² FLOPs over about 12 R C bf16 values moved (x, q, k, v, attn,
// g, dattn, dq, dk, dv, dx; R = B mx my W² rows): 0.67 C FLOP/B, 64 at
// ViL-Small's stage-1 width C = 96 and 128 at C = 192; the attention
// backward is 2.5 times B1's work at about 220 FLOP/B. All of it is under
// the bf16 tensor-core ridge (~295 FLOP/B), so on the tensor cores device
// memory and the products' own rate come close; PERF.md counts the least
// time, 0.2621 ms per fused step, by operations.
//
// The kernels are chosen by the operand dtype, each with a name of its own:
//
// bf16 (the main path: the fused bf16 training step), every product on the
// tensor cores (wgmma, tiles by cp.async):
//   vil_block_bwd_proj_out_wgmma  dattn = g·Woᵀ (gemm_tc.cuh, gemm_tc_nt):
//       one warpgroup per 64 rows, every output column in the block (NB
//       64-column sub-tiles), Wo read K-major through the ring
//   vil_block_bwd_attn_wgmma_pass1, _pass2  B2's tensor-core bodies
//       (sliding_chunk_tc.cuh over FullNbh): pass 1 per 64-row slice of a
//       query chunk over the 7 64-key tiles of [glo ‖ 9 chunks] (with a
//       bias, one block walks every chunk of its image, so each dbias
//       partial has one writer), pass 2 per 64-key slice gathering the query
//       rows that see it. P and dS are rounded to bf16 before their
//       products, where the TPU kernel rounds them (vil_block.py:304, :321).
//   vil_block_bwd_glo  dk_glo, dv_glo on the CUDA cores (M values a block)
//   vil_block_bwd_wgrad_wgmma  the four dW = aᵀ·b (gemm_tc_tn): one block per
//       (64 input channels, problem, row slice), a and b both read MN-major
//       (the rows are wgmma's k), one f32 partial per slice; the blocks of
//       the first 64 channels also sum b's columns of their slice from the
//       staged tiles (the four bias gradients' partials)
//   vil_block_bwd_reduce  the partials summed in slice order (CUDA cores)
//   vil_block_bwd_proj_in_wgmma  dx = Σ_s d_s·W_sᵀ over the three segments
//       (gemm_tc_nt, a K of 3C streamed 64 at a time)
//
// f32 (the parity checks' operands, which need f32 arithmetic; the tensor
// cores take no f32 operands): the CUDA-core kernels vil_block_bwd_proj_out,
// vil_block_bwd_attn_pass1 and _pass2 (B2's CUDA-core bodies,
// sliding_chunk.cuh; δ = rowsum(P ∘ dP) from a first sweep, P and dS in
// f32), vil_block_bwd_glo, vil_block_bwd_wgrad (gemm.cuh, gridDim.z = 4 x
// slices), vil_block_bwd_bgrad (the bias gradients over the same slices),
// vil_block_bwd_reduce and vil_block_bwd_proj_in.
#include "gemm.cuh"
#include "gemm_tc.cuh"
#include "sliding_chunk_tc.cuh"

namespace vil {

constexpr int kProblems = 4;  // (x, dq), (x, dk), (x, dv), (attn, g)

template <typename T>
struct WeightGrads {
  const T* a[kProblems];  // left operand of each dW = aᵀ · b
  const T* b[kProblems];  // right operand; its column sums are the bias gradient
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
vil_block_bwd_proj_out(NtSegments<T> seg, T* __restrict__ dattn, int R, int C) {
  gemm_nt<T>(seg, dattn, R, C, C);
}

template <typename T, int M>
__global__ void __launch_bounds__(kThreads)
vil_block_bwd_attn_pass1(const T* __restrict__ q, const T* __restrict__ k,
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
vil_block_bwd_attn_pass2(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ g,
                         const float* __restrict__ bias, const float* __restrict__ mask,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         T* __restrict__ dk, T* __restrict__ dv, int mx, int my, int w2, int C,
                         int nglo, int wq) {
  sliding_chunk_bwd_pass2<T, M>(FullNbh{}, q, k, v, g, bias, mask, lse, delta, dk, dv, mx, my,
                                w2, C, nglo, wq);
}

// One block per (global row t, head h, image b): dk_glo[b, t, h] and
// dv_glo[b, t, h] (M values each) summed over the image's `rows` rows.
// Thread (group, m) takes rows group, group + groups, ...; the groups' sums
// are added in group order.
template <typename T>
__global__ void __launch_bounds__(kThreads)
vil_block_bwd_glo(const T* __restrict__ q, const T* __restrict__ dattn,
                  const float* __restrict__ p_glo, const float* __restrict__ ds_glo,
                  float* __restrict__ dkg, float* __restrict__ dvg, int rows, int C, int nglo) {
  __shared__ float red[2][kThreads];
  const int t = blockIdx.x, h = blockIdx.y, b = blockIdx.z, H = gridDim.y;
  const int M = C / H, groups = kThreads / M;
  const int m = threadIdx.x % M, group = threadIdx.x / M;
  float acc_k = 0.f, acc_v = 0.f;
  if (group < groups) {
    const float* ds = ds_glo + ((long)b * H + h) * rows * nglo + t;
    const float* p = p_glo + ((long)b * H + h) * rows * nglo + t;
    const long base = (long)b * rows * C + h * M + m;
    for (int r = group; r < rows; r += groups) {
      acc_k = fmaf(ds[(long)r * nglo], to_float(q[base + (long)r * C]), acc_k);
      acc_v = fmaf(p[(long)r * nglo], to_float(dattn[base + (long)r * C]), acc_v);
    }
  }
  red[0][threadIdx.x] = acc_k;
  red[1][threadIdx.x] = acc_v;
  __syncthreads();
  if (threadIdx.x < M) {
    float sk = 0.f, sv = 0.f;
    for (int gr = 0; gr < groups; ++gr) {
      sk += red[0][gr * M + threadIdx.x];
      sv += red[1][gr * M + threadIdx.x];
    }
    const long out = ((long)b * nglo + t) * C + h * M + threadIdx.x;
    dkg[out] = sk;
    dvg[out] = sv;
  }
}

// Partial of slice s = blockIdx.z / kProblems for problem blockIdx.z %
// kProblems: rows [s * rows_per_slice, ...) of aᵀ · b, at
// part[s * stride + problem * C * C].
template <typename T>
__global__ void __launch_bounds__(kThreads)
vil_block_bwd_wgrad(WeightGrads<T> w, float* __restrict__ part, int R, int C,
                    int rows_per_slice, long stride) {
  const int problem = blockIdx.z % kProblems, s = blockIdx.z / kProblems;
  const int r0 = s * rows_per_slice, r1 = min(R, r0 + rows_per_slice);
  gemm_tn<T>(w.a[problem], w.b[problem], part + s * stride + (long)problem * C * C, C, C, r0,
             r1);
}

// Column sums of each problem's b over the same slices, at
// part[s * stride + kProblems * C * C + problem * C].
template <typename T>
__global__ void __launch_bounds__(kThreads)
vil_block_bwd_bgrad(WeightGrads<T> w, float* __restrict__ part, int R, int C,
                    int rows_per_slice, long stride) {
  const int problem = blockIdx.z % kProblems, s = blockIdx.z / kProblems;
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= C) return;
  const int r0 = s * rows_per_slice, r1 = min(R, r0 + rows_per_slice);
  const T* b = w.b[problem];
  float sum = 0.f;
  for (int r = r0; r < r1; ++r) sum += to_float(b[(long)r * C + n]);
  part[s * stride + (long)kProblems * C * C + problem * C + n] = sum;
}

// out[i] = Σ_s part[s * len + i], in slice order.
__global__ void __launch_bounds__(kThreads)
vil_block_bwd_reduce(const float* __restrict__ part, float* __restrict__ out, int slices,
                     long len) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= len) return;
  float sum = 0.f;
  for (int s = 0; s < slices; ++s) sum += part[s * len + i];
  out[i] = sum;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
vil_block_bwd_proj_in(NtSegments<T> seg, T* __restrict__ dx, int R, int C) {
  gemm_nt<T>(seg, dx, R, C, C);
}

template <int NB>
__global__ void __launch_bounds__(kTcThreads)
vil_block_bwd_proj_out_wgmma(TcSegments seg, bf16* __restrict__ dattn, int R, int C) {
  gemm_tc_nt<NB>(seg, dattn, R, C, C);
}

template <int M>
__global__ void __launch_bounds__(kTcThreads)
vil_block_bwd_attn_wgmma_pass1(const bf16* __restrict__ q, const bf16* __restrict__ k,
                               const bf16* __restrict__ v, const bf16* __restrict__ k_glo,
                               const bf16* __restrict__ v_glo, const bf16* __restrict__ g,
                               const bf16* __restrict__ out, const float* __restrict__ bias,
                               const float* __restrict__ mask, const float* __restrict__ lse,
                               float* __restrict__ delta, bf16* __restrict__ dq,
                               float* __restrict__ p_glo, float* __restrict__ ds_glo,
                               float* __restrict__ dbias_part, int mx, int my, int w2, int C,
                               int nglo, int wq, int chunks_per_block, bool bf16_exp) {
  sliding_chunk_bwd_tc_pass1<M>(FullNbh{}, q, k, v, k_glo, v_glo, g, out, bias, mask, lse, delta,
                                dq, p_glo, ds_glo, dbias_part, mx, my, w2, C, nglo, wq,
                                chunks_per_block, bf16_exp);
}

template <int M>
__global__ void __launch_bounds__(kTcThreads)
vil_block_bwd_attn_wgmma_pass2(const bf16* __restrict__ q, const bf16* __restrict__ k,
                               const bf16* __restrict__ v, const bf16* __restrict__ g,
                               const float* __restrict__ bias, const float* __restrict__ mask,
                               const float* __restrict__ lse, const float* __restrict__ delta,
                               bf16* __restrict__ dk, bf16* __restrict__ dv, int mx, int my,
                               int w2, int C, int nglo, int wq, bool bf16_exp) {
  sliding_chunk_bwd_tc_pass2<M>(FullNbh{}, q, k, v, g, bias, mask, lse, delta, dk, dv, mx, my,
                                w2, C, nglo, wq, bf16_exp);
}

// The partial of slice s = blockIdx.z / kProblems for problem blockIdx.z %
// kProblems, input channels from 64 blockIdx.x: rows [s * rows_per_slice,
// ...) of aᵀ · b at part[s * stride + problem * C * C], and (blocks of
// blockIdx.x 0) the column sums of b at part[s * stride + kProblems * C * C
// + problem * C].
template <int NB>
__global__ void __launch_bounds__(kTcThreads)
vil_block_bwd_wgrad_wgmma(WeightGrads<bf16> w, float* __restrict__ part, int R, int C,
                          int rows_per_slice, long stride) {
  const int problem = blockIdx.z % kProblems, s = blockIdx.z / kProblems;
  const int r0 = s * rows_per_slice, r1 = min(R, r0 + rows_per_slice);
  float* p = part + s * stride;
  gemm_tc_tn<NB>(w.a[problem], w.b[problem], p + (long)problem * C * C,
                 p + (long)kProblems * C * C + problem * C, C, C, r0, r1);
}

template <int NB>
__global__ void __launch_bounds__(kTcThreads)
vil_block_bwd_proj_in_wgmma(TcSegments seg, bf16* __restrict__ dx, int R, int C) {
  gemm_tc_nt<NB>(seg, dx, R, C, C);
}

inline dim3 tile_grid(int R, int C, int z) {
  return dim3((R + kTileM - 1) / kTileM, (C + kTileN - 1) / kTileN, z);
}

// The bf16 kernels (the note at the top), in the order of the f32 ones of
// launch_block_bwd below.
inline cudaError_t launch_block_bwd_tc(
    const bf16* x, const bf16* wq, const bf16* wk, const bf16* wv, const bf16* wo,
    const bf16* k_glo, const bf16* v_glo, const float* bias, const float* mask, const bf16* q,
    const bf16* k, const bf16* v, const bf16* attn, const bf16* g, const float* lse, bf16* dattn,
    float* delta, bf16* dq, bf16* dk, bf16* dv, float* p_glo, float* ds_glo, float* dbias_part,
    float* dkg, float* dvg, float* part, float* grads, bf16* dx, int B, int mx, int my, int w2,
    int C, int H, int nglo, int wq_rows, int slices, int rows_per_slice, bool bf16_exp,
    cudaStream_t stream) {
  const int R = B * mx * my * w2;
  const int row_tiles = (R + kGemmTile - 1) / kGemmTile;
  cudaError_t err = dispatch_col_tiles(C, [&](auto nb) {
    constexpr int NB = decltype(nb)::value;
    const dim3 grid(row_tiles, (C + NB * kGemmTile - 1) / (NB * kGemmTile));
    return launch_with(vil_block_bwd_proj_out_wgmma<NB>, grid, kTcThreads, gemm_tc_smem_bytes(NB),
                       stream, TcSegments{{g}, {wo}, 1}, dattn, R, C);
  });
  if (err != cudaSuccess) return err;
  // with a bias, one pass-1 block walks all chunks of its image (one writer
  // per dbias partial), as in B2
  const int per_block = dbias_part != nullptr ? mx * my : 1;
  const int slices_q = (w2 + kTcRows - 1) / kTcRows;  // 64-row slices of a chunk
  err = dispatch_head_dim(C / H, [&](auto m) {
    constexpr int M = decltype(m)::value;
    cudaError_t e = launch_with(
        vil_block_bwd_attn_wgmma_pass1<M>, dim3(mx * my / per_block * slices_q, H, B),
        kTcThreads, tc_pass1_smem_bytes(M), stream, q, k, v, k_glo, v_glo, (const bf16*)dattn,
        attn, bias, mask, lse, delta, dq, p_glo, ds_glo, dbias_part, mx, my, w2, C, nglo,
        wq_rows, per_block, bf16_exp);
    if (e != cudaSuccess) return e;
    return launch_with(vil_block_bwd_attn_wgmma_pass2<M>, dim3(mx * my * slices_q, H, B),
                       kTcThreads, tc_pass2_smem_bytes(M), stream, q, k, v, (const bf16*)dattn,
                       bias, mask, lse, (const float*)delta, dk, dv, mx, my, w2, C, nglo,
                       wq_rows, bf16_exp);
  });
  if (err != cudaSuccess) return err;
  if (nglo > 0) {
    err = launch(vil_block_bwd_glo<bf16>, dim3(nglo, H, B), 0, stream, q, (const bf16*)dattn,
                 (const float*)p_glo, (const float*)ds_glo, dkg, dvg, mx * my * w2, C, nglo);
    if (err != cudaSuccess) return err;
  }
  const WeightGrads<bf16> wg{{x, x, x, attn}, {dq, dk, dv, g}};
  const long stride = (long)kProblems * C * C + kProblems * C;
  err = dispatch_col_tiles(C, [&](auto nb) {
    constexpr int NB = decltype(nb)::value;
    const dim3 grid((C + kGemmTile - 1) / kGemmTile, (C + NB * kGemmTile - 1) / (NB * kGemmTile),
                    kProblems * slices);
    return launch_with(vil_block_bwd_wgrad_wgmma<NB>, grid, kTcThreads, gemm_tc_smem_bytes(NB),
                       stream, wg, part, R, C, rows_per_slice, stride);
  });
  if (err != cudaSuccess) return err;
  err = launch(vil_block_bwd_reduce, dim3((unsigned)((stride + kThreads - 1) / kThreads)), 0,
               stream, (const float*)part, grads, slices, stride);
  if (err != cudaSuccess) return err;
  return dispatch_col_tiles(C, [&](auto nb) {
    constexpr int NB = decltype(nb)::value;
    const dim3 grid(row_tiles, (C + NB * kGemmTile - 1) / (NB * kGemmTile));
    return launch_with(vil_block_bwd_proj_in_wgmma<NB>, grid, kTcThreads, gemm_tc_smem_bytes(NB),
                       stream, TcSegments{{dq, dk, dv}, {wq, wk, wv}, 3}, dx, R, C);
  });
}

template <typename T>
cudaError_t launch_block_bwd(const T* x, const T* wq, const T* wk, const T* wv, const T* wo,
                             const T* k_glo, const T* v_glo, const float* bias,
                             const float* mask, const T* q, const T* k, const T* v, const T* attn,
                             const T* g, const float* lse, T* dattn, float* delta, T* dq, T* dk,
                             T* dv, float* p_glo, float* ds_glo, float* dbias_part, float* dkg,
                             float* dvg, float* part, float* grads, T* dx, int B, int mx, int my,
                             int w2, int C, int H, int nglo, int wq_rows, int slices,
                             int rows_per_slice, bool bf16_exp, cudaStream_t stream) {
  const int R = B * mx * my * w2;
  cudaError_t err = launch(vil_block_bwd_proj_out<T>, tile_grid(R, C, 1), 0, stream,
                           NtSegments<T>{{g}, {wo}, 1}, dattn, R, C);
  if (err != cudaSuccess) return err;
  // with a bias, one pass-1 block walks all chunks of its image (one writer
  // per dbias partial), as in B2
  const int per_block = dbias_part != nullptr ? mx * my : 1;
  err = dispatch_head_dim(C / H, [&](auto m) {
    constexpr int M = decltype(m)::value;
    cudaError_t e = launch(vil_block_bwd_attn_pass1<T, M>, dim3(mx * my / per_block, H, B),
                           pass1_smem_bytes(w2, M), stream, q, k, v, k_glo, v_glo,
                           (const T*)dattn, bias, mask, lse, delta, dq, p_glo, ds_glo,
                           dbias_part, mx, my, w2, C, nglo, wq_rows, per_block);
    if (e != cudaSuccess) return e;
    return launch(vil_block_bwd_attn_pass2<T, M>, dim3(mx * my, H, B), pass2_smem_bytes(w2, M),
                  stream, q, k, v, (const T*)dattn, bias, mask, lse, (const float*)delta, dk, dv,
                  mx, my, w2, C, nglo, wq_rows);
  });
  if (err != cudaSuccess) return err;
  if (nglo > 0) {
    err = launch(vil_block_bwd_glo<T>, dim3(nglo, H, B), 0, stream, q, (const T*)dattn,
                 (const float*)p_glo, (const float*)ds_glo, dkg, dvg, mx * my * w2, C, nglo);
    if (err != cudaSuccess) return err;
  }
  const WeightGrads<T> wg{{x, x, x, attn}, {dq, dk, dv, g}};
  const long stride = (long)kProblems * C * C + kProblems * C;
  err = launch(vil_block_bwd_wgrad<T>, tile_grid(C, C, kProblems * slices), 0, stream, wg, part,
               R, C, rows_per_slice, stride);
  if (err != cudaSuccess) return err;
  err = launch(vil_block_bwd_bgrad<T>, dim3((C + kThreads - 1) / kThreads, 1, kProblems * slices),
               0, stream, wg, part, R, C, rows_per_slice, stride);
  if (err != cudaSuccess) return err;
  err = launch(vil_block_bwd_reduce, dim3((unsigned)((stride + kThreads - 1) / kThreads)), 0,
               stream, (const float*)part, grads, slices, stride);
  if (err != cudaSuccess) return err;
  return launch(vil_block_bwd_proj_in<T>, tile_grid(R, C, 1), 0, stream,
                NtSegments<T>{{dq, dk, dv}, {wq, wk, wv}, 3}, dx, R, C);
}

}  // namespace vil

// x, q, k, v, attn, g, dattn, dq, dk, dv, dx (B, mx, my, w2, C); wq, wk,
// wv, wo (C, C) in x's type; k_glo, v_glo (B, nglo, C) or null when nglo is
// 0; bias (H, w2, nglo + 9 w2) f32 or null; mask (mx, my, wq_rows,
// nglo + 9 w2) f32; lse, delta (B, H, mx, my, w2) f32; p_glo, ds_glo
// (B, H, mx, my, w2, nglo) f32 or null; dbias_part (B, H, w2, nglo + 9 w2)
// f32, zero on entry, or null without a bias; dkg, dvg (B, nglo, C) f32 or
// null; part (slices, 4 C² + 4 C) f32 scratch; grads (4 C² + 4 C) f32:
// dWq, dWk, dWv, dWo (each (C, C), in, out), then dbq, dbk, dbv, dbo. The
// rows of x are cut into `slices` slices of rows_per_slice. All contiguous.
// Launches every kernel on `stream`; returns the first launch error.
extern "C" int vil_block_bwd(const void* x, const void* wq, const void* wk, const void* wv,
                             const void* wo, const void* k_glo, const void* v_glo,
                             const void* bias, const void* mask, const void* q, const void* k,
                             const void* v, const void* attn, const void* g, const void* lse,
                             void* dattn, void* delta, void* dq, void* dk, void* dv, void* p_glo,
                             void* ds_glo, void* dbias_part, void* dkg, void* dvg, void* part,
                             void* grads, void* dx, int B, int mx, int my, int w2, int C, int H,
                             int nglo, int wq_rows, int slices, int rows_per_slice, int is_bf16,
                             int bf16_exp,
                             void* stream) {
  auto* s = static_cast<cudaStream_t>(stream);
  auto f = [](void* p) { return static_cast<float*>(p); };
  auto cf = [](const void* p) { return static_cast<const float*>(p); };
  auto run = [&](auto tag) {
    using T = decltype(tag);
    auto call = [&](auto fn) {
      return fn((const T*)x, (const T*)wq, (const T*)wk, (const T*)wv, (const T*)wo,
                (const T*)k_glo, (const T*)v_glo, cf(bias), cf(mask), (const T*)q, (const T*)k,
                (const T*)v, (const T*)attn, (const T*)g, cf(lse), (T*)dattn, f(delta), (T*)dq,
                (T*)dk, (T*)dv, f(p_glo), f(ds_glo), f(dbias_part), f(dkg), f(dvg), f(part),
                f(grads), (T*)dx, B, mx, my, w2, C, H, nglo, wq_rows, slices, rows_per_slice,
                bf16_exp != 0, s);
    };
    if constexpr (std::is_same_v<T, float>) return call(vil::launch_block_bwd<float>);
    else return call(vil::launch_block_bwd_tc);
  };
  return is_bf16 ? run(__nv_bfloat16{}) : run(float{});
}
