// Sliding-chunk attention over a neighbourhood of key chunks: the CUDA-core
// bodies of the forward (B5, and B1 and B7a in f32) and backward (B2, B6 and
// B7b in f32) kernels of this directory; the bf16 B1, B2, B6, B7a and B7b
// run sliding_chunk_tc.cuh.
//
// Each query chunk (i, j) of an mx x my grid of W x W chunks attends to the
// global keys and to Nbh::kCount key chunks, neighbour n being K/V chunk
// (key_row(nbh, i, n, mx), (j + nbh.dy(n)) mod my) of a K/V grid of
// kv_rows(nbh, mx) x my chunks: ((i + nbh.dx(n)) mod mx, ...) for the cyclic
// neighbourhoods, whose K/V share q's grid. Score columns are in
// front order [glo ‖ nbh 0 ‖ ... ‖ nbh kCount-1], as the bias
// (H, W², cols) and mask (mx, my, Wq, cols) tables have them, with
// cols = nglo + kCount W²; Wq is 1 (one mask row per chunk) or W² (one per
// query pixel). q arrives scaled by M^-1/2; no kernel scales.
//
// The neighbourhoods:
//   FullNbh      the 3x3 cyclic neighbourhood of MODE 0, in the order of
//                masks.NEIGHBOR_OFFSETS: (dx, dy) = (n / 3 - 1, n % 3 - 1)
//   SampledNbh   [self ‖ one sampled neighbour] of MODE 1..8 (random-shift
//                training): (0, 0), then (dx, dy) = -MODE_ROLL_SHIFTS[mode]
//   SelfNbh      the self chunk alone, mode -1: (0, 0)
//   Halo<Base>   Base's neighbours over halo-extended K/V (spatial
//                parallelism): K/V hold mx + 2 chunk rows, a shard's own rows
//                between the previous shard's last row (row 0) and the next
//                shard's first (row mx + 1), so neighbour (dx, dy) of query
//                row i is K/V row i + dx + 1, never wrapped; columns still
//                wrap over my. HaloNbh = Halo<FullNbh> (MODE 0, B7a/B7b),
//                HaloSampledNbh = Halo<SampledNbh> (MODE 1..8, B5h/B6h)
// Each entry point (vil_attention_*.cu, vil_mode_attention_*.cu) wraps these
// bodies in __global__ kernels of its own name.
#pragma once

#include <type_traits>

#include "attention_common.cuh"

namespace vil {

struct FullNbh {
  static constexpr int kCount = 9;
  __device__ __forceinline__ int dx(int n) const { return n / 3 - 1; }
  __device__ __forceinline__ int dy(int n) const { return n % 3 - 1; }
};

struct SampledNbh {
  static constexpr int kCount = 2;
  int sdx, sdy;  // offset of the sampled chunk, each in {-1, 0, 1}
  __device__ __forceinline__ int dx(int n) const { return n == 0 ? 0 : sdx; }
  __device__ __forceinline__ int dy(int n) const { return n == 0 ? 0 : sdy; }
};

struct SelfNbh {
  static constexpr int kCount = 1;
  __device__ __forceinline__ int dx(int) const { return 0; }
  __device__ __forceinline__ int dy(int) const { return 0; }
};

template <typename Base>
struct Halo : Base {};
using HaloNbh = Halo<FullNbh>;
using HaloSampledNbh = Halo<SampledNbh>;

// Row addressing. A cyclic neighbourhood reads K/V of q's mx rows and wraps
// the row index; a Halo one reads mx + 2 rows and does not wrap.
template <typename Nbh>
__host__ __device__ __forceinline__ int kv_rows(const Nbh&, int mx) { return mx; }
// the K/V row of neighbour n of query row i
template <typename Nbh>
__device__ __forceinline__ int key_row(const Nbh& nbh, int i, int n, int mx) {
  return (i + nbh.dx(n) + mx) % mx;
}
// the query row whose neighbour n is K/V row r, or -1 when there is none
template <typename Nbh>
__device__ __forceinline__ int query_row(const Nbh& nbh, int r, int n, int mx) {
  return (r - nbh.dx(n) + mx) % mx;
}

template <typename Base>
__host__ __device__ __forceinline__ int kv_rows(const Halo<Base>&, int mx) { return mx + 2; }
template <typename Base>
__device__ __forceinline__ int key_row(const Halo<Base>& nbh, int i, int n, int) {
  return i + nbh.dx(n) + 1;
}
// the halo row 0 (mx + 1) is seen by query row 0 (mx - 1) alone, through
// the neighbours with dx = -1 (+1); a neighbourhood without such a
// neighbour (the sampled chunk of a mode with dx = 0) never reads it
template <typename Base>
__device__ __forceinline__ int query_row(const Halo<Base>& nbh, int r, int n, int mx) {
  const int i = r - 1 - nbh.dx(n);
  return i >= 0 && i < mx ? i : -1;
}

// Forward, one block per (query chunk, head, image): an online softmax over
// the column tiles (the global keys w2 at a time, then the kCount neighbour
// chunks), scores in registers, q, one K/V tile and the f32 accumulator in
// shared memory (w2 (4M + 3) floats). Writes out and, when lse is not null,
// the per-row log-sum-exp (B, H, mx, my, w2).
template <typename T, int M, typename Nbh>
__device__ __forceinline__ void sliding_chunk_fwd(
    Nbh nbh, const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ k_glo, const T* __restrict__ v_glo, const float* __restrict__ bias,
    const float* __restrict__ mask, T* __restrict__ out, float* __restrict__ lse, int mx,
    int my, int w2, int C, int nglo, int wq) {
  extern __shared__ float smem[];
  const int chunk = blockIdx.x;  // i * my + j
  const int h = blockIdx.y, b = blockIdx.z;
  const int i = chunk / my, j = chunk % my;
  const int cols = nglo + Nbh::kCount * w2;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, nwarps = blockDim.x / 32;

  float* q_s = smem;                  // w2 x M
  float* k_s = q_s + w2 * M;          // w2 x (M + 1)
  float* v_s = k_s + w2 * (M + 1);    // w2 x M
  float* acc_s = v_s + w2 * M;        // w2 x M
  float* m_s = acc_s + w2 * M;        // w2
  float* l_s = m_s + w2;              // w2

  // head h of chunk (ci, cj) of q's grid, or of the K/V grid of mxk rows:
  // w2 rows of M elements, C apart
  const int mxk = kv_rows(nbh, mx);
  auto chunk_ptr = [&](auto* base, int ci, int cj) {
    return base + (((long)b * mx + ci) * my + cj) * w2 * C + h * M;
  };
  auto kv_ptr = [&](auto* base, int ci, int cj) {
    return base + (((long)b * mxk + ci) * my + cj) * w2 * C + h * M;
  };
  load_rows<M>(q_s, M, chunk_ptr(q, i, j), C, w2);
  for (int idx = threadIdx.x; idx < w2 * M; idx += blockDim.x) acc_s[idx] = 0.f;
  for (int idx = threadIdx.x; idx < w2; idx += blockDim.x) {
    m_s[idx] = -INFINITY;
    l_s[idx] = 0.f;
  }

  const float* bias_h = bias != nullptr ? bias + (long)h * w2 * cols : nullptr;
  const float* mask_c = mask + (long)chunk * wq * cols;
  const int n_glo_tiles = (nglo + w2 - 1) / w2;
  for (int tile = 0; tile < n_glo_tiles + Nbh::kCount; ++tile) {
    int col0, nkeys;
    const T *ksrc, *vsrc;
    if (tile < n_glo_tiles) {
      col0 = tile * w2;
      nkeys = min(w2, nglo - col0);
      ksrc = k_glo + ((long)b * nglo + col0) * C + h * M;
      vsrc = v_glo + ((long)b * nglo + col0) * C + h * M;
    } else {
      const int n = tile - n_glo_tiles;
      const int ci = key_row(nbh, i, n, mx), cj = (j + nbh.dy(n) + my) % my;
      col0 = nglo + n * w2;
      nkeys = w2;
      ksrc = kv_ptr(k, ci, cj);
      vsrc = kv_ptr(v, ci, cj);
    }
    __syncthreads();  // the previous tile is consumed; q and the state are set
    load_rows<M>(k_s, M + 1, ksrc, C, nkeys);
    load_rows<M>(v_s, M, vsrc, C, nkeys);
    __syncthreads();
    for (int r = warp; r < w2; r += nwarps) {
      RowState<M> st;
      load_state(st, m_s, l_s, acc_s, r, lane);
      const float* bias_r = bias_h != nullptr ? bias_h + (long)r * cols + col0 : nullptr;
      const float* mask_r = mask_c + (long)(wq == 1 ? 0 : r) * cols + col0;
      fold_keys(st, q_s + r * M, k_s, v_s, nkeys, bias_r, mask_r, lane);
      store_state(st, m_s, l_s, acc_s, r, lane);
    }
  }
  __syncthreads();
  T* out_c = chunk_ptr(out, i, j);
  for (int r = warp; r < w2; r += nwarps) store_row<M>(out_c + (long)r * C, acc_s, l_s, r, lane);
  if (lse != nullptr) {  // (B, H, mx, my, w2): m + log l of the online softmax
    float* lse_c = lse + (((long)b * gridDim.y + h) * mx * my + chunk) * w2;
    for (int r = threadIdx.x; r < w2; r += blockDim.x) lse_c[r] = m_s[r] + logf(l_s[r]);
  }
}

constexpr size_t fwd_smem_bytes(int w2, int M) { return sizeof(float) * (size_t)w2 * (4 * M + 3); }

// Backward pass 1, one block per (query chunk, head, image), or per (chunk
// group, head, image) walking chunks_per_block chunks when a bias is given
// (then each dbias partial has one writer). grid (groups, H, B), groups =
// ceil(mx · my / chunks_per_block). Two sweeps over the column tiles: the
// first sums δ = rowsum(P ∘ dP), the second forms dS = P ∘ (dP - δ) and
// dQ = dS · K. Writes δ, dQ, the global columns P_glo and dS_glo, and adds
// into the dbias partials (B, groups, H, w2, cols), zero on entry.
template <typename T, int M, typename Nbh>
__device__ __forceinline__ void sliding_chunk_bwd_pass1(
    Nbh nbh, const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ k_glo, const T* __restrict__ v_glo, const T* __restrict__ g,
    const float* __restrict__ bias, const float* __restrict__ mask,
    const float* __restrict__ lse, float* __restrict__ delta, T* __restrict__ dq,
    float* __restrict__ p_glo, float* __restrict__ ds_glo, float* __restrict__ dbias_part,
    int mx, int my, int w2, int C, int nglo, int wq, int chunks_per_block) {
  extern __shared__ float smem[];
  const int h = blockIdx.y, b = blockIdx.z, H = gridDim.y;
  const int cols = nglo + Nbh::kCount * w2;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, nwarps = blockDim.x / 32;

  float* q_s = smem;                  // w2 x M
  float* g_s = q_s + w2 * M;          // w2 x M
  float* k_s = g_s + w2 * M;          // w2 x (M + 1)
  float* v_s = k_s + w2 * (M + 1);    // w2 x (M + 1)
  float* dq_s = v_s + w2 * (M + 1);   // w2 x M
  float* lse_s = dq_s + w2 * M;       // w2
  float* delta_s = lse_s + w2;        // w2

  const int mxk = kv_rows(nbh, mx);
  auto chunk_ptr = [&](auto* base, int ci, int cj) {
    return base + (((long)b * mx + ci) * my + cj) * w2 * C + h * M;
  };
  auto kv_ptr = [&](auto* base, int ci, int cj) {
    return base + (((long)b * mxk + ci) * my + cj) * w2 * C + h * M;
  };
  const float* bias_h = bias != nullptr ? bias + (long)h * w2 * cols : nullptr;
  const int n_glo_tiles = (nglo + w2 - 1) / w2;
  // (b, group, h, row 0) of this block's dbias partial
  float* db_h = dbias_part != nullptr
                    ? dbias_part + (((long)b * gridDim.x + blockIdx.x) * H + h) * w2 * cols
                    : nullptr;

  for (int c = 0; c < chunks_per_block; ++c) {
    const int chunk = blockIdx.x * chunks_per_block + c;  // i * my + j
    if (chunk >= mx * my) break;                          // the last group's ragged end
    const int i = chunk / my, j = chunk % my;
    const long row0 = (((long)b * H + h) * mx * my + chunk) * w2;  // (b, h, i, j, 0)
    __syncthreads();  // the previous chunk is done with shared memory
    load_rows<M>(q_s, M, chunk_ptr(q, i, j), C, w2);
    load_rows<M>(g_s, M, chunk_ptr(g, i, j), C, w2);
    for (int idx = threadIdx.x; idx < w2 * M; idx += blockDim.x) dq_s[idx] = 0.f;
    for (int idx = threadIdx.x; idx < w2; idx += blockDim.x) {
      lse_s[idx] = lse[row0 + idx];
      delta_s[idx] = 0.f;
    }
    const float* mask_c = mask + (long)chunk * wq * cols;

    for (int sweep = 0; sweep < 2; ++sweep) {
      for (int tile = 0; tile < n_glo_tiles + Nbh::kCount; ++tile) {
        int col0, nkeys;
        const T *ksrc, *vsrc;
        if (tile < n_glo_tiles) {
          col0 = tile * w2;
          nkeys = min(w2, nglo - col0);
          ksrc = k_glo + ((long)b * nglo + col0) * C + h * M;
          vsrc = v_glo + ((long)b * nglo + col0) * C + h * M;
        } else {
          const int n = tile - n_glo_tiles;
          const int ci = key_row(nbh, i, n, mx), cj = (j + nbh.dy(n) + my) % my;
          col0 = nglo + n * w2;
          nkeys = w2;
          ksrc = kv_ptr(k, ci, cj);
          vsrc = kv_ptr(v, ci, cj);
        }
        __syncthreads();  // the previous tile is consumed; rows and sums are set
        load_rows<M>(k_s, M + 1, ksrc, C, nkeys);
        load_rows<M>(v_s, M + 1, vsrc, C, nkeys);
        __syncthreads();
        for (int r = warp; r < w2; r += nwarps) {
          const float* bias_r = bias_h != nullptr ? bias_h + (long)r * cols + col0 : nullptr;
          const float* mask_r = mask_c + (long)(wq == 1 ? 0 : r) * cols + col0;
          if (sweep == 0) {
            const float d = row_delta<M>(q_s + r * M, g_s + r * M, k_s, v_s, nkeys, bias_r,
                                         mask_r, lse_s[r], lane);
            if (lane == 0) delta_s[r] += d;
          } else {
            float *p_out = nullptr, *ds_out = nullptr, *db = nullptr;
            if (tile < n_glo_tiles) {  // (b, h, i, j, r, glo column)
              p_out = p_glo + (row0 + r) * nglo + col0;
              ds_out = ds_glo + (row0 + r) * nglo + col0;
            }
            if (db_h != nullptr)  // (r, column) of the block's partial
              db = db_h + (long)r * cols + col0;
            LaneVec<M> acc;
            acc.load(dq_s + r * M, lane);
            row_dq<M>(acc, q_s + r * M, g_s + r * M, k_s, v_s, nkeys, bias_r, mask_r,
                      lse_s[r], delta_s[r], p_out, ds_out, db, lane);
            acc.store(dq_s + r * M, lane);
          }
        }
      }
    }
    __syncthreads();
    store_rows<M>(chunk_ptr(dq, i, j), C, dq_s, w2);
    for (int idx = threadIdx.x; idx < w2; idx += blockDim.x) delta[row0 + idx] = delta_s[idx];
  }
}

constexpr size_t pass1_smem_bytes(int w2, int M) {
  return sizeof(float) * (size_t)w2 * (5 * M + 4);
}

// Backward pass 2, one block per (key chunk (r, c) of the K/V grid, head,
// image): for each neighbour n it stages the query chunk that sees this key
// chunk as its neighbour n, (query_row(nbh, r, n, mx), (c - dy(n)) mod my),
// if there is one, recomputes P and dS against it from the stored L and δ,
// and accumulates dK += dSᵀ · q and dV += Pᵀ · g. A key chunk that is
// several neighbours of one query chunk (cyclic grids with mx or my ≤ 2, a
// halo shard of one row) adds each occurrence, as the forward visits each
// one.
template <typename T, int M, typename Nbh>
__device__ __forceinline__ void sliding_chunk_bwd_pass2(
    Nbh nbh, const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ g, const float* __restrict__ bias, const float* __restrict__ mask,
    const float* __restrict__ lse, const float* __restrict__ delta, T* __restrict__ dk,
    T* __restrict__ dv, int mx, int my, int w2, int C, int nglo, int wq) {
  extern __shared__ float smem[];
  const int chunk = blockIdx.x;  // the key chunk r * my + c of the K/V grid
  const int h = blockIdx.y, b = blockIdx.z, H = gridDim.y;
  const int r = chunk / my, c = chunk % my;
  const int mxk = kv_rows(nbh, mx);
  const int cols = nglo + Nbh::kCount * w2;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, nwarps = blockDim.x / 32;

  float* k_s = smem;                  // w2 x M
  float* v_s = k_s + w2 * M;          // w2 x M
  float* q_s = v_s + w2 * M;          // w2 x (M + 1)
  float* g_s = q_s + w2 * (M + 1);    // w2 x (M + 1)
  float* dk_s = g_s + w2 * (M + 1);   // w2 x M
  float* dv_s = dk_s + w2 * M;        // w2 x M
  float* lse_s = dv_s + w2 * M;       // w2
  float* delta_s = lse_s + w2;        // w2

  auto chunk_ptr = [&](auto* base, int ci, int cj) {
    return base + (((long)b * mx + ci) * my + cj) * w2 * C + h * M;
  };
  auto kv_ptr = [&](auto* base, int ci, int cj) {
    return base + (((long)b * mxk + ci) * my + cj) * w2 * C + h * M;
  };
  load_rows<M>(k_s, M, kv_ptr(k, r, c), C, w2);
  load_rows<M>(v_s, M, kv_ptr(v, r, c), C, w2);
  for (int idx = threadIdx.x; idx < w2 * M; idx += blockDim.x) {
    dk_s[idx] = 0.f;
    dv_s[idx] = 0.f;
  }
  const float* bias_h = bias != nullptr ? bias + (long)h * w2 * cols : nullptr;

  for (int n = 0; n < Nbh::kCount; ++n) {
    // this key chunk is neighbour n of query chunk (r - dx, c - dy), at its
    // columns nglo + n * w2 ...
    const int qi = query_row(nbh, r, n, mx), qj = (c - nbh.dy(n) + my) % my;
    if (qi < 0) continue;  // the same for the whole block
    const int qchunk = qi * my + qj;
    const long row0 = (((long)b * H + h) * mx * my + qchunk) * w2;
    __syncthreads();  // the previous query chunk is consumed
    load_rows<M>(q_s, M + 1, chunk_ptr(q, qi, qj), C, w2);
    load_rows<M>(g_s, M + 1, chunk_ptr(g, qi, qj), C, w2);
    for (int idx = threadIdx.x; idx < w2; idx += blockDim.x) {
      lse_s[idx] = lse[row0 + idx];
      delta_s[idx] = delta[row0 + idx];
    }
    __syncthreads();
    const int col0 = nglo + n * w2;
    const float* mask_q = mask + (long)qchunk * wq * cols + col0;
    for (int t = warp; t < w2; t += nwarps) {
      LaneVec<M> dk_acc, dv_acc;
      dk_acc.load(dk_s + t * M, lane);
      dv_acc.load(dv_s + t * M, lane);
      col_dkdv<M>(dk_acc, dv_acc, k_s + t * M, v_s + t * M, q_s, g_s, lse_s, delta_s, w2,
                  bias_h != nullptr ? bias_h + col0 + t : nullptr, cols, mask_q + t,
                  wq == 1 ? 0 : cols, lane);
      dk_acc.store(dk_s + t * M, lane);
      dv_acc.store(dv_s + t * M, lane);
    }
  }
  __syncthreads();
  store_rows<M>(kv_ptr(dk, r, c), C, dk_s, w2);
  store_rows<M>(kv_ptr(dv, r, c), C, dv_s, w2);
}

constexpr size_t pass2_smem_bytes(int w2, int M) {
  return sizeof(float) * (size_t)w2 * (6 * M + 4);
}

// f(std::integral_constant<int, M>{}) for the head dims the kernels are
// compiled for; cudaErrorInvalidValue for any other.
template <typename F>
cudaError_t dispatch_head_dim(int M, F&& f) {
  switch (M) {
    case 8: return f(std::integral_constant<int, 8>{});
    case 16: return f(std::integral_constant<int, 16>{});
    case 32: return f(std::integral_constant<int, 32>{});
    case 64: return f(std::integral_constant<int, 64>{});
    case 128: return f(std::integral_constant<int, 128>{});
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace vil
