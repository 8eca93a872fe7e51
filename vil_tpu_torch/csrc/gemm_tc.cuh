// Matrix products on Hopper's tensor cores (sm_90a): bf16 operands, f32
// accumulators. The projections of the bf16 fused attention-block forward
// (vil_block_fwd.cu) and the projection products and weight gradients of its
// backward (vil_block_bwd.cu), which the TPU kernels compute in their own
// bodies (vil_tpu/ops/pallas/vil_block.py: _project_rows, _mm_rows and the
// dW dot_generals, bf16 operands with preferred_element_type f32).
//
// One warpgroup (kTcThreads = 128 threads) per block computes a 64-row
// output tile against NB sub-tiles of 64 columns (NB ≤ 4: up to 256
// columns, so at ViL's widths C = 96 and 192 a block holds every output
// column of its rows and reads its rows of A once). Each product is
// wgmma m64n64k16 from shared memory (wgmma_ss_n64_t, tensor_core.cuh); a
// 64-deep k-tile is 4 k-steps x NB sub-tiles. Tiles come by cp.async, 16
// bytes a thread, into a ring of kGemmStages stages, so two k-tiles are in
// flight while one is multiplied; the weights of proj_in at C = 192 (three
// 192 x 192 bf16 matrices, 216 KB) are streamed through the ring 64 rows of
// k at a time with the activations, never held whole.
//
// Operands (TcOperand) are row-major in device memory, either way round:
//   K-major   element (i, k) at p[i * ld + k]: the reduction index is
//             contiguous (the activations of Y = X·Wᵀ, and Wᵀ's W)
//   MN-major  element (i, k) at p[k * ld + i]: the output index is
//             contiguous (both operands of dW = aᵀ·b, whose reduction runs
//             over the rows; and W of Y = X·W, the forward's products)
// A 64 x 64 tile of either is staged in tensor_core.cuh's swizzle-free
// layout with DP = 64: the 16 bytes of tile row r, values 8c .. 8c + 7, at
// byte ((r / 8) * 8 + c) * 128 + (r % 8) * 16. A K-major tile's rows are
// the operand's M (or N) rows and its values the k's (k_major<64>); an
// MN-major tile's rows are the k's and its values M or N (mn_major<64>,
// imm-trans 1), which is how wgmma reads aᵀ without a transposed copy.
// Edges are zero-filled by the copies themselves (ragged R, C = 96's second
// half tile, a slice's last k-tile), so no bound is checked inside the
// products; the stores skip rows and columns past the output.
//
// Three forms:
//   gemm_tc_nn   Y (R, N) = A (R, K) · W (K, N) + b, W in (in, out) layout
//                and so read MN-major, the f32 bias added before one rounding
//                to bf16 (the forward's q, k, v and y, vil_block_fwd.cu)
//   gemm_tc_nt   Y (R, N) = Σ_s A_s (R, K) · B_s (N, K)ᵀ, rounded to bf16 once
//                (proj_out: dattn = g·Woᵀ; proj_in: dx = Σ dq·Wqᵀ + ...)
//   gemm_tc_tn   P (Ka, N) = A[r0:r1]ᵀ · B[r0:r1] in f32, one partial per row
//                slice, summed by the caller in slice order: no atomics, the
//                same result on every run (wgrad)
// (the last two in vil_block_bwd.cu).
#pragma once

#include "tensor_core.cuh"

namespace vil {

using bf16 = __nv_bfloat16;

constexpr int kGemmTile = 64;    // rows, columns and depth of a tile
constexpr int kGemmStages = 3;   // depth of the ring
constexpr int kGemmTileElems = kGemmTile * kGemmTile;

// Stage a 64 x 64 tile: row r from row_ptr(r) (values 0 .. kv - 1, kv a
// multiple of 8), zeros where row_ptr(r) is null and at values >= kv.
template <typename RowPtr>
__device__ __forceinline__ void stage_gemm_tile(bf16* dst, const bf16* any, RowPtr row_ptr,
                                                int kv) {
  const uint32_t base = smem_u32(dst);
#pragma unroll
  for (int i = threadIdx.x; i < kGemmTileElems / 8; i += kTcThreads) {
    const int r8 = i % 8, c = (i / 8) % 8, grp = i / 64;
    const bf16* src = row_ptr(grp * 8 + r8);
    const bool ok = src != nullptr && c * 8 < kv;
    cp_async16(base + (grp * 8 + c) * 128 + r8 * 16, ok ? src + c * 8 : any, ok ? 16 : 0);
  }
}

// One operand of a product: `extent` rows along M (or N) and `depth` along
// k, element (i, k) at p[i * ld + k] (kKMajor) or p[k * ld + i].
template <bool kKMajor>
struct TcOperand {
  const bf16* p;
  long ld;
  int extent, depth;

  // the tile of rows i0 .. i0 + 63 and k0 .. k0 + 63 (uncommitted copies)
  __device__ __forceinline__ void stage(bf16* dst, int i0, int k0) const {
    const bf16* q = p;
    const int e = extent, d = depth;
    const long l = ld;
    if constexpr (kKMajor) {
      stage_gemm_tile(dst, q, [=](int r) { return i0 + r < e ? q + (i0 + r) * l + k0 : nullptr; },
                      d - k0);
    } else {
      stage_gemm_tile(dst, q, [=](int r) { return k0 + r < d ? q + (k0 + r) * l + i0 : nullptr; },
                      e - i0);
    }
  }
  // the descriptor of k-step kk (16 values of k) of a staged tile
  __device__ __forceinline__ uint64_t desc(const bf16* tile, int kk) const {
    if constexpr (kKMajor) return k_major<kGemmTile>(tile) + 16 * kk;  // 256 bytes a step
    return mn_major<kGemmTile>(tile) + 2 * kGemmTile * kk;               // 16 rows: 32 DP bytes
  }
};

// The two operands of one segment of a product
template <typename A, typename B>
struct OperandPair {
  A a;
  B b;
};

// Shared memory of a block with NB column sub-tiles: kGemmStages stages of
// one A tile and NB B tiles.
constexpr size_t gemm_tc_smem_bytes(int NB) {
  return sizeof(bf16) * kGemmStages * (1 + NB) * kGemmTileElems;
}

// The main loop: acc[j] += Σ_s Σ_k A_s(m0 + i, k) · B_s(n0 + 64 j + n, k) over
// the k-tiles k_begin, k_begin + 64, ... < k_end of every segment s <
// n_seg; seg(s) gives (A_s, B_s) as an OperandPair. After each k-tile has
// landed and before its products, on_tile(b_tiles) sees its B sub-tiles in
// shared memory.
template <int NB, bool kAK, bool kBK, typename Segment, typename OnTile>
__device__ __forceinline__ void gemm_tc_mainloop(float (&acc)[NB][32], Segment seg, int n_seg,
                                                 int m0, int n0, int k_begin, int k_end,
                                                 OnTile on_tile) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);  // stage s: A, then B's NB sub-tiles
  const int per_seg = (k_end - k_begin + kGemmTile - 1) / kGemmTile;
  const int tiles = n_seg * per_seg;
  auto stage = [&](int t) {
    bf16* dst = ring + (t % kGemmStages) * (1 + NB) * kGemmTileElems;
    const auto ops = seg(t / per_seg);
    const int k0 = k_begin + (t % per_seg) * kGemmTile;
    ops.a.stage(dst, m0, k0);
#pragma unroll
    for (int j = 0; j < NB; ++j)
      ops.b.stage(dst + (1 + j) * kGemmTileElems, n0 + j * kGemmTile, k0);
  };
#pragma unroll
  for (int j = 0; j < NB; ++j)
#pragma unroll
    for (int x = 0; x < 32; ++x) acc[j][x] = 0.f;
#pragma unroll
  for (int t = 0; t < kGemmStages - 1; ++t) {
    if (t < tiles) stage(t);
    cp_async_commit();
  }
  for (int t = 0; t < tiles; ++t) {
    cp_async_wait<kGemmStages - 2>();  // tile t has landed (this thread's copies)
    __syncthreads();  // everyone's copies; tile t - 1's stage is no longer read
    if (t + kGemmStages - 1 < tiles) stage(t + kGemmStages - 1);
    cp_async_commit();
    const bf16* a_t = ring + (t % kGemmStages) * (1 + NB) * kGemmTileElems;
    const bf16* b_t = a_t + kGemmTileElems;
    const auto ops = seg(t / per_seg);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < NB; ++j) fence_operand(acc[j]);
#pragma unroll
    for (int kk = 0; kk < kGemmTile / 16; ++kk)
#pragma unroll
      for (int j = 0; j < NB; ++j)
        wgmma_ss_n64_t<!kAK, !kBK>(acc[j], ops.a.desc(a_t, kk),
                                   ops.b.desc(b_t + j * kGemmTileElems, kk), 1);
    wgmma_commit();
    on_tile(b_t);  // reads shared memory beside the products
    wgmma_wait_all();
#pragma unroll
    for (int j = 0; j < NB; ++j) fence_operand(acc[j]);
  }
  cp_async_wait<0>();  // no copy outlives the block (the empty groups)
}

__device__ __forceinline__ void put2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void put2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// Store a 64 x 64 accumulator at rows m0 .. m0 + 63 and columns n0 .. n0 + 63
// of a (rows, cols) row-major matrix whose row i starts at y + i * ld, in
// y's type, with bias[col] (f32) added first where bias is not null; rows
// >= rows and columns >= cols (a multiple of 8) are skipped.
template <typename T>
__device__ __forceinline__ void store_gemm_tile(T* y, long ld, const float (&d)[32], int m0,
                                                int n0, int rows, int cols,
                                                const float* __restrict__ bias = nullptr) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = m0 + 16 * warp + lane / 4 + 8 * i;
    if (row >= rows) continue;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const int col = n0 + 8 * jj + 2 * (lane % 4);
      if (col >= cols) continue;
      float v0 = d[4 * jj + 2 * i], v1 = d[4 * jj + 2 * i + 1];
      if (bias) v0 += bias[col], v1 += bias[col + 1];
      put2(y + row * ld + col, v0, v1);
    }
  }
}

// Y = A · W + bias, rounded to bf16 once, for A (R, K) and W (K, N) in (in,
// out) layout (element (n, k) of the product's B at W[k * N + n]: MN-major,
// read through the ring without a transposed copy) and bias (N) f32 or
// null: the 64 rows from m0 and NB 64-column sub-tiles from n0. K and N are
// multiples of 8.
template <int NB>
__device__ __forceinline__ void gemm_tc_nn(const bf16* __restrict__ a,
                                           const bf16* __restrict__ w,
                                           const float* __restrict__ bias,
                                           bf16* __restrict__ y, int R, int K, int N, int m0,
                                           int n0) {
  float acc[NB][32];
  auto seg = [&](int) {
    return OperandPair<TcOperand<true>, TcOperand<false>>{{a, K, R, K}, {w, N, N, K}};
  };
  gemm_tc_mainloop<NB, true, false>(acc, seg, 1, m0, n0, 0, K, [](const bf16*) {});
#pragma unroll
  for (int j = 0; j < NB; ++j)
    store_gemm_tile(y, N, acc[j], m0, n0 + j * kGemmTile, R, N, bias);
}

// Up to three (A_s, B_s) pairs of Y = Σ_s A_s · B_sᵀ, all (R, K) and (N, K).
struct TcSegments {
  const bf16* a[3];
  const bf16* b[3];
  int n;
};

// Y = Σ_s A_s · B_sᵀ, rounded to bf16 once: the 64 rows of block x, columns
// from NB * 64 * blockIdx.y. K and N are multiples of 8.
template <int NB>
__device__ __forceinline__ void gemm_tc_nt(const TcSegments& segs, bf16* __restrict__ y, int R,
                                           int K, int N) {
  const int m0 = blockIdx.x * kGemmTile, n0 = blockIdx.y * NB * kGemmTile;
  float acc[NB][32];
  auto seg = [&](int s) {
    using Op = TcOperand<true>;
    return OperandPair<Op, Op>{{segs.a[s], K, R, K}, {segs.b[s], K, N, K}};
  };
  gemm_tc_mainloop<NB, true, true>(acc, seg, segs.n, m0, n0, 0, K, [](const bf16*) {});
#pragma unroll
  for (int j = 0; j < NB; ++j)
    store_gemm_tile(y, N, acc[j], m0, n0 + j * kGemmTile, R, N);
}

// P = A[r0:r1]ᵀ · B[r0:r1] in f32 for A (R, Ka) and B (R, N): rows m0 = 64
// blockIdx.x of P and columns from n0, written to the partial p (Ka, N).
// The blocks with blockIdx.x == 0 also write Σ_r B[r, n] over the slice to
// colsum[n], in the order of the rows.
template <int NB>
__device__ __forceinline__ void gemm_tc_tn(const bf16* __restrict__ a, const bf16* __restrict__ b,
                                           float* __restrict__ p, float* __restrict__ colsum,
                                           int Ka, int N, int r0, int r1) {
  const int m0 = blockIdx.x * kGemmTile, n0 = blockIdx.y * NB * kGemmTile;
  float acc[NB][32];
  // the columns of B this thread sums: col = threadIdx.x + x * kTcThreads
  float sum[(NB * kGemmTile + kTcThreads - 1) / kTcThreads] = {};
  const bool sums = blockIdx.x == 0;
  auto seg = [&](int) {
    using Op = TcOperand<false>;
    return OperandPair<Op, Op>{{a, Ka, Ka, r1}, {b, N, N, r1}};
  };
  gemm_tc_mainloop<NB, false, false>(acc, seg, 1, m0, n0, r0, r1, [&](const bf16* b_t) {
    if (!sums) return;
#pragma unroll
    for (int x = 0; x < (NB * kGemmTile + kTcThreads - 1) / kTcThreads; ++x) {
      const int col = threadIdx.x + x * kTcThreads;  // of the block's NB * 64
      if (col >= NB * kGemmTile) continue;
      const bf16* tile = b_t + (col / kGemmTile) * kGemmTileElems;
      const int c = col % kGemmTile;
      float s = sum[x];
      for (int r = 0; r < kGemmTile; ++r)  // the tile's k rows, in order (zeros past r1)
        s += __bfloat162float(tile[((r / 8) * 8 + c / 8) * 64 + (r % 8) * 8 + c % 8]);
      sum[x] = s;
    }
  });
#pragma unroll
  for (int j = 0; j < NB; ++j)
    store_gemm_tile(p, N, acc[j], m0, n0 + j * kGemmTile, Ka, N);
  if (sums) {
#pragma unroll
    for (int x = 0; x < (NB * kGemmTile + kTcThreads - 1) / kTcThreads; ++x) {
      const int col = threadIdx.x + x * kTcThreads;
      if (col < NB * kGemmTile && n0 + col < N) colsum[n0 + col] = sum[x];
    }
  }
}

// f(std::integral_constant<int, NB>{}) with NB = the 64-column sub-tiles of
// an N-wide output, at most 4 (N > 256 takes several blocks along y).
template <typename F>
cudaError_t dispatch_col_tiles(int N, F&& f) {
  switch ((N + kGemmTile - 1) / kGemmTile) {
    case 1: return f(std::integral_constant<int, 1>{});
    case 2: return f(std::integral_constant<int, 2>{});
    case 3: return f(std::integral_constant<int, 3>{});
    default: return f(std::integral_constant<int, 4>{});
  }
}

}  // namespace vil
