// Dense multi-head attention backward for Hopper (sm_90a).
//
// Replaces the TPU kernels vil_tpu/ops/pallas/full_attention.py::_pallas_backward
// (Pallas body _bwd_kernel) and its q-tiled tier _pallas_backward_tiled
// (_tiled_bwd_kernel). For every image b and head h, given the forward's
// output, its per-row log-sum-exp L and the upstream gradient g:
//
//   P  = exp(q · kᵀ + bias - L),   dP = g · vᵀ,   δ = rowsum(g ∘ out)
//   dS = P ∘ (dP - δ)
//   dQ = dS · k,   dK = dSᵀ · q,   dV = Pᵀ · g,   dbias = Σ_b dS
//
// q, k, v, g, out and the gradients are (B, N, C) with the heads packed in
// C; q arrives scaled by M^-1/2 and dQ is with respect to that scaled q.
// (δ = rowsum(P ∘ dP) = rowsum(g ∘ out), the identity full_attention.py:592
// states.)
//
// What bounds it on an H100. ViL-Small stage 3 per image: the five products
// are 5 x 2 x 197² x 384 = 0.15 GFLOP over 1.06 MB of q, k, v, g, dq, dk,
// dv in bf16, ~140 FLOP/B, under the bf16 tensor-core ridge (~295 FLOP/B) and
// far above the f32 CUDA-core ridge (~20 FLOP/B): the products go to the
// tensor cores.
//
// FlashAttention-2 in shape, without atomics (two launches on the same
// inputs give bitwise-equal gradients):
//   pass 1, one block per (64-row q tile, head, image): δ of the tile's rows
//     (written for pass 2), then one sweep over the 64-row key tiles forming
//     S, P, dP, dS and dQ. With a bias, one block per (q tile, head, image
//     group): it walks the group's images in order, and its rows of the
//     group's (H, N, N) dbias partial take the first image's dS and then add
//     each later one's, so dbias is summed over images in the kernel, with
//     no zero fill and no atomics (the wrapper sums the few groups, or takes
//     the one). The group is as many images as keep two blocks an SM busy
//     (ops/kernels/full_attention.py::image_group).
//   pass 2, one block per (64-row key tile, head, image): one sweep over the
//     q tiles in the transposed form, recomputing P and dS from L and δ and
//     accumulating dK and dV.
//
// The kernel is chosen by the operand dtype:
//
// bf16 (full_attention_bwd_wgmma_pass1/2, the main path: the bf16 training
// step). One warpgroup (128 threads) a block, seven products per key/q tile
// pair, all by wgmma: pass 1 S = Q·Kᵀ and dP = g·Vᵀ (m64n64k16, operands from
// shared memory) and dQ += dS·K (dS as the register A operand, K read
// MN-major); pass 2 Sᵀ = K·Qᵀ and dPᵀ = V·gᵀ (keys as wgmma's 64 rows, L and
// δ indexing columns), dV += Pᵀ·g and dK += dSᵀ·Q (Pᵀ, dSᵀ in registers, g
// and Q read MN-major). P is rounded to bf16 before dS and the products, dS
// after the dbias partial and before the products, where the TPU kernel
// rounds them (full_attention.py:631, :649). With a bias (the kBiased
// instances; the unbiased ones keep their registers), each thread loads
// its 32 bias values of a tile pair (and in pass 1 its dbias partial's, from
// the group's second image on) into registers before the tile's products,
// so that those loads (the bias is 403 MB at N 4097, past the 50 MB L2) run under the products
// instead of after them. Tiles come by cp.async into a
// two-stage ring, rows >= N zero-filled per row (no read across images);
// keys (pass 1) and q rows (pass 2) >= N get P = 0; rows >= N are never
// stored. Layouts and instructions: tensor_core.cuh.
//
// f32 (full_attention_bwd_pass1/2). The tensor cores take no f32 operands, and
// the f32 inputs are the parity checks' (one training step's gradients within
// 1e-4 of the plain version), which need f32 arithmetic. So f32 keeps the
// CUDA-core bodies (256 threads, one warp per row, δ by a first sweep
// of pass 1; `out` is not read), which recompute S with the forward's fmaf
// chain so that P = exp(S - L) uses the very S whose L the forward stored.
#include "attention_common.cuh"
#include "tensor_core.cuh"

namespace vil {

constexpr int kBwdTile = 64;  // q rows (pass 1) or key rows (pass 2) per block

template <typename T, int M>
__global__ void __launch_bounds__(kThreads)
full_attention_bwd_pass1(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ g,
                         const float* __restrict__ bias, const float* __restrict__ lse,
                         float* __restrict__ delta, T* __restrict__ dq,
                         float* __restrict__ dbias_part, int N, int C, int per_group) {
  extern __shared__ float smem[];
  const int h = blockIdx.y, H = gridDim.y;
  const int q0 = blockIdx.x * kBwdTile;
  const int nq = min(kBwdTile, N - q0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, nwarps = blockDim.x / 32;

  float* q_s = smem;                        // kBwdTile x M
  float* g_s = q_s + kBwdTile * M;          // kBwdTile x M
  float* k_s = g_s + kBwdTile * M;          // kBwdTile x (M + 1)
  float* v_s = k_s + kBwdTile * (M + 1);    // kBwdTile x (M + 1)
  float* dq_s = v_s + kBwdTile * (M + 1);   // kBwdTile x M
  float* lse_s = dq_s + kBwdTile * M;       // kBwdTile
  float* delta_s = lse_s + kBwdTile;        // kBwdTile
  // (group, h, q0) of the dbias partial: 64-bit, past 2^31 at N 4097
  const long db_row0 = ((long)blockIdx.z * H + h) * N + q0;

  for (int img = 0; img < per_group; ++img) {  // the group's images, in order
    const int b = blockIdx.z * per_group + img;
    auto row_ptr = [&](auto* base, int n) { return base + ((long)b * N + n) * C + h * M; };
    const long row0 = ((long)b * H + h) * N + q0;  // (b, h, q0)
    __syncthreads();  // the previous image is done with shared memory
    load_rows<M>(q_s, M, row_ptr(q, q0), C, nq);
    load_rows<M>(g_s, M, row_ptr(g, q0), C, nq);
    for (int idx = threadIdx.x; idx < nq * M; idx += blockDim.x) dq_s[idx] = 0.f;
    for (int idx = threadIdx.x; idx < nq; idx += blockDim.x) {
      lse_s[idx] = lse[row0 + idx];
      delta_s[idx] = 0.f;
    }

    for (int sweep = 0; sweep < 2; ++sweep) {
      for (int k0 = 0; k0 < N; k0 += kBwdTile) {
        const int nk = min(kBwdTile, N - k0);
        __syncthreads();  // the previous tile is consumed; rows and sums are set
        load_rows<M>(k_s, M + 1, row_ptr(k, k0), C, nk);
        load_rows<M>(v_s, M + 1, row_ptr(v, k0), C, nk);
        __syncthreads();
        for (int r = warp; r < nq; r += nwarps) {
          const float* bias_r =
              bias != nullptr ? bias + ((long)h * N + q0 + r) * N + k0 : nullptr;
          if (sweep == 0) {
            const float d = row_delta<M>(q_s + r * M, g_s + r * M, k_s, v_s, nk, bias_r, nullptr,
                                         lse_s[r], lane);
            if (lane == 0) delta_s[r] += d;
          } else {
            float* db = dbias_part != nullptr ? dbias_part + (db_row0 + r) * N + k0 : nullptr;
            LaneVec<M> acc;
            acc.load(dq_s + r * M, lane);
            row_dq<M>(acc, q_s + r * M, g_s + r * M, k_s, v_s, nk, bias_r, nullptr, lse_s[r],
                      delta_s[r], nullptr, nullptr, db, lane, img > 0);
            acc.store(dq_s + r * M, lane);
          }
        }
      }
    }
    __syncthreads();
    store_rows<M>(row_ptr(dq, q0), C, dq_s, nq);
    for (int idx = threadIdx.x; idx < nq; idx += blockDim.x) delta[row0 + idx] = delta_s[idx];
  }
}

template <typename T, int M>
__global__ void __launch_bounds__(kThreads)
full_attention_bwd_pass2(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ g,
                         const float* __restrict__ bias, const float* __restrict__ lse,
                         const float* __restrict__ delta, T* __restrict__ dk,
                         T* __restrict__ dv, int N, int C) {
  extern __shared__ float smem[];
  const int h = blockIdx.y, b = blockIdx.z, H = gridDim.y;
  const int k0 = blockIdx.x * kBwdTile;
  const int nk = min(kBwdTile, N - k0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, nwarps = blockDim.x / 32;

  float* k_s = smem;                        // kBwdTile x M
  float* v_s = k_s + kBwdTile * M;          // kBwdTile x M
  float* q_s = v_s + kBwdTile * M;          // kBwdTile x (M + 1)
  float* g_s = q_s + kBwdTile * (M + 1);    // kBwdTile x (M + 1)
  float* dk_s = g_s + kBwdTile * (M + 1);   // kBwdTile x M
  float* dv_s = dk_s + kBwdTile * M;        // kBwdTile x M
  float* lse_s = dv_s + kBwdTile * M;       // kBwdTile
  float* delta_s = lse_s + kBwdTile;        // kBwdTile

  auto row_ptr = [&](auto* base, int n) { return base + ((long)b * N + n) * C + h * M; };
  load_rows<M>(k_s, M, row_ptr(k, k0), C, nk);
  load_rows<M>(v_s, M, row_ptr(v, k0), C, nk);
  for (int idx = threadIdx.x; idx < nk * M; idx += blockDim.x) {
    dk_s[idx] = 0.f;
    dv_s[idx] = 0.f;
  }
  const float* bias_h = bias != nullptr ? bias + (long)h * N * N : nullptr;

  for (int q0 = 0; q0 < N; q0 += kBwdTile) {
    const int nq = min(kBwdTile, N - q0);
    const long row0 = ((long)b * H + h) * N + q0;
    __syncthreads();  // the previous q tile is consumed
    load_rows<M>(q_s, M + 1, row_ptr(q, q0), C, nq);
    load_rows<M>(g_s, M + 1, row_ptr(g, q0), C, nq);
    for (int idx = threadIdx.x; idx < nq; idx += blockDim.x) {
      lse_s[idx] = lse[row0 + idx];
      delta_s[idx] = delta[row0 + idx];
    }
    __syncthreads();
    for (int t = warp; t < nk; t += nwarps) {
      LaneVec<M> dk_acc, dv_acc;
      dk_acc.load(dk_s + t * M, lane);
      dv_acc.load(dv_s + t * M, lane);
      col_dkdv<M>(dk_acc, dv_acc, k_s + t * M, v_s + t * M, q_s, g_s, lse_s, delta_s, nq,
                  bias_h != nullptr ? bias_h + (long)q0 * N + k0 + t : nullptr, N, nullptr, 0,
                  lane);
      dk_acc.store(dk_s + t * M, lane);
      dv_acc.store(dv_s + t * M, lane);
    }
  }
  __syncthreads();
  store_rows<M>(row_ptr(dk, k0), C, dk_s, nk);
  store_rows<M>(row_ptr(dv, k0), C, dv_s, nk);
}

// The bf16 pass 1 on the tensor cores (the note at the top): δ, dQ and the
// dbias partial of one 64-row q tile, for each image of its group in turn.
// Scores in base 2 (s · log2 e).
template <int M, bool kBiased>
__global__ void __launch_bounds__(kTcThreads)
full_attention_bwd_wgmma_pass1(const __nv_bfloat16* __restrict__ q,
                               const __nv_bfloat16* __restrict__ k,
                               const __nv_bfloat16* __restrict__ v,
                               const __nv_bfloat16* __restrict__ g,
                               const __nv_bfloat16* __restrict__ out,
                               const float* __restrict__ bias, const float* __restrict__ lse,
                               float* __restrict__ delta, __nv_bfloat16* __restrict__ dq,
                               float* __restrict__ dbias_part, int N, int C, int per_group) {
  constexpr int DP = M < 16 ? 16 : M, TILE = kTcRows * DP;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* g_s = q_s + TILE;
  __nv_bfloat16* kv_s = g_s + TILE;  // stage s: the K tile at kv_s + 2 s TILE, V after it
  float* delta_s = reinterpret_cast<float*>(kv_s + 4 * TILE);  // kTcRows
  const int h = blockIdx.y, H = gridDim.y;
  const int q0 = blockIdx.x * kTcRows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // (group, h, q0) of the dbias partial: 64-bit, past 2^31 at N 4097
  const long db_row0 = ((long)blockIdx.z * H + h) * N + q0;

  for (int img = 0; img < per_group; ++img) {  // the group's images, in order
    const int b = blockIdx.z * per_group + img;
    const long head = (long)b * N * C + h * M;     // row 0, head h, image b
    const long row0 = ((long)b * H + h) * N + q0;  // (b, h, q0) of lse and delta
    __syncthreads();  // the previous image is done with shared memory

    stage_tile<M>(q_s, q + head + (long)q0 * C, C, N - q0);
    stage_tile<M>(g_s, g + head + (long)q0 * C, C, N - q0);
    stage_tile<M>(kv_s, k + head, C, N);
    stage_tile<M>(kv_s + TILE, v + head, C, N);
    cp_async_commit();

    {  // δ = rowsum(g ∘ out) in f32, two threads a row, while the copies fly
      const int r = threadIdx.x / 2, half = threadIdx.x % 2;
      float d = 0.f;
      if (q0 + r < N) {
        const long at = head + (long)(q0 + r) * C + half * (M / 2);
#pragma unroll
        for (int e = 0; e < M / 2; e += 2) {
          const float2 gg =
              __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(g + at + e));
          const float2 oo =
              __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(out + at + e));
          d = fmaf(gg.x, oo.x, fmaf(gg.y, oo.y, d));
        }
      }
      d += __shfl_xor_sync(kFullMask, d, 1);
      if (half == 0) {
        delta_s[r] = d;  // 0 past N
        if (q0 + r < N) delta[row0 + r] = d;
      }
    }
    __syncthreads();
    float lse2[2], dl[2];  // L (base 2) and δ of this thread's two rows; 0 past N
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = 16 * warp + lane / 4 + 8 * i;
      lse2[i] = q0 + r < N ? lse[row0 + r] * kLog2e : 0.f;
      dl[i] = delta_s[r];
    }

    float acc[M / 2];  // dQ
#pragma unroll
    for (int i = 0; i < M / 2; ++i) acc[i] = 0.f;
    const int tiles = (N + kTcRows - 1) / kTcRows;
    for (int t = 0; t < tiles; ++t) {
      const __nv_bfloat16* k_t = kv_s + (t & 1) * 2 * TILE;
      const __nv_bfloat16* v_t = k_t + TILE;
      if (t + 1 < tiles) {  // tile t + 1 into the other stage, in flight during tile t
        __nv_bfloat16* next = kv_s + ((t + 1) & 1) * 2 * TILE;
        const int k1 = (t + 1) * kTcRows;
        stage_tile<M>(next, k + head + (long)k1 * C, C, N - k1);
        stage_tile<M>(next + TILE, v + head + (long)k1 * C, C, N - k1);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();

      // this thread's 32 bias values of the tile and, from the group's
      // second image on, its dbias partial's: loads in flight while the
      // products run (the element of accumulator slot e is (row r, key))
      const int k0 = t * kTcRows;
      float bv[32], ov[32];
      if constexpr (kBiased) {
#pragma unroll
        for (int e = 0; e < 32; ++e) {
          const int key = k0 + 8 * (e / 4) + 2 * (lane % 4) + e % 2;
          const int r = 16 * warp + lane / 4 + 8 * (e / 2 % 2);
          const bool inside = q0 + r < N && key < N;
          bv[e] = inside ? bias[((long)h * N + q0 + r) * N + key] : 0.f;
          ov[e] = inside && img > 0 ? dbias_part[(db_row0 + r) * N + key] : 0.f;
        }
      }

      float s[32], dp[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk)
        wgmma_ss_n64(s, k_major<DP>(q_s) + 16 * kk, k_major<DP>(k_t) + 16 * kk, kk > 0);
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk)
        wgmma_ss_n64(dp, k_major<DP>(g_s) + 16 * kk, k_major<DP>(v_t) + 16 * kk, kk > 0);
      wgmma_commit();
      wgmma_wait_all();
      fence_operand(s);
      fence_operand(dp);

#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int e = 4 * j + 2 * i + c;
            const int key = k0 + 8 * j + 2 * (lane % 4) + c;
            const int r = 16 * warp + lane / 4 + 8 * i;
            const bool inside = q0 + r < N && key < N;
            float x = s[e];
            if (kBiased && inside) x += bv[e];
            // P rounded to bf16, as the TPU kernel rounds it; 0 for keys >= N
            const float p =
                key < N ? __bfloat162float(__float2bfloat16(exp2f(x * kLog2e - lse2[i]))) : 0.f;
            const float ds = p * (dp[e] - dl[i]);
            // this thread's alone: the group's first image sets, later ones add
            if (kBiased && inside)
              dbias_part[(db_row0 + r) * N + key] = img == 0 ? ds : ov[e] + ds;
            s[e] = ds;
          }
      uint32_t a[4][4];  // dS in bf16, the A operand of dS·K
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) a_frag(a[kk], s, kk);
      wgmma_fence();
      fence_operand(acc);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)  // a k-step is 16 K rows: 32 DP bytes
        wgmma_rs<M>(acc, a[kk], mn_major<DP>(k_t) + 2 * DP * kk, 1);
      wgmma_commit();
      wgmma_wait_all();
      fence_operand(acc);
      __syncthreads();  // this stage is read before the next iteration refills it
    }
    store_acc_rows<M>(dq + head, C, acc, q0, N);
  }
}

// The bf16 pass 2 on the tensor cores: dK and dV of one 64-row key tile, in
// the transposed form (keys are wgmma's rows, q rows its columns).
template <int M, bool kBiased>
__global__ void __launch_bounds__(kTcThreads)
full_attention_bwd_wgmma_pass2(const __nv_bfloat16* __restrict__ q,
                               const __nv_bfloat16* __restrict__ k,
                               const __nv_bfloat16* __restrict__ v,
                               const __nv_bfloat16* __restrict__ g,
                               const float* __restrict__ bias, const float* __restrict__ lse,
                               const float* __restrict__ delta, __nv_bfloat16* __restrict__ dk,
                               __nv_bfloat16* __restrict__ dv, int N, int C) {
  constexpr int DP = M < 16 ? 16 : M, TILE = kTcRows * DP;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* k_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* v_s = k_s + TILE;
  __nv_bfloat16* qg_s = v_s + TILE;  // stage s: the Q tile at qg_s + 2 s TILE, g after it
  float* ld_s = reinterpret_cast<float*>(qg_s + 4 * TILE);  // stage s: L at 2 s kTcRows, δ after
  const int h = blockIdx.y, b = blockIdx.z, H = gridDim.y;
  const int k0 = blockIdx.x * kTcRows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long head = (long)b * N * C + h * M;
  const long bh = ((long)b * H + h) * N;  // (b, h, 0) of lse and delta

  auto stage_q_tile = [&](int u) {  // Q, g, L and δ of q tile u into stage u & 1
    __nv_bfloat16* dst = qg_s + (u & 1) * 2 * TILE;
    float* ld = ld_s + (u & 1) * 2 * kTcRows;
    const int r0 = u * kTcRows;
    stage_tile<M>(dst, q + head + (long)r0 * C, C, N - r0);
    stage_tile<M>(dst + TILE, g + head + (long)r0 * C, C, N - r0);
    stage_row_values(ld, lse + bh + r0, N - r0, 0);
    stage_row_values(ld + kTcRows, delta + bh + r0, N - r0, kTcRows);
  };
  stage_tile<M>(k_s, k + head + (long)k0 * C, C, N - k0);
  stage_tile<M>(v_s, v + head + (long)k0 * C, C, N - k0);
  stage_q_tile(0);
  cp_async_commit();

  float acc_k[M / 2], acc_v[M / 2];  // dK, dV
#pragma unroll
  for (int i = 0; i < M / 2; ++i) acc_k[i] = acc_v[i] = 0.f;
  const int tiles = (N + kTcRows - 1) / kTcRows;
  for (int u = 0; u < tiles; ++u) {
    const __nv_bfloat16* q_u = qg_s + (u & 1) * 2 * TILE;
    const __nv_bfloat16* g_u = q_u + TILE;
    const float* lse_u = ld_s + (u & 1) * 2 * kTcRows;
    const float* delta_u = lse_u + kTcRows;
    if (u + 1 < tiles) {
      stage_q_tile(u + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    const int r0 = u * kTcRows;
    float bv[32];  // this thread's bias values of the tile, loaded while the products run
    if constexpr (kBiased) {
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int col = 8 * (e / 4) + 2 * (lane % 4) + e % 2;
        const int key = k0 + 16 * warp + lane / 4 + 8 * (e / 2 % 2);
        bv[e] = r0 + col < N && key < N ? bias[((long)h * N + r0 + col) * N + key] : 0.f;
      }
    }

    float s[32], dp[32];  // Sᵀ and dPᵀ: row = key, column = q row
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
      wgmma_ss_n64(s, k_major<DP>(k_s) + 16 * kk, k_major<DP>(q_u) + 16 * kk, kk > 0);
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
      wgmma_ss_n64(dp, k_major<DP>(v_s) + 16 * kk, k_major<DP>(g_u) + 16 * kk, kk > 0);
    wgmma_commit();
    wgmma_wait_all();
    fence_operand(s);
    fence_operand(dp);

#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int e = 4 * j + 2 * i + c;
          const int col = 8 * j + 2 * (lane % 4) + c;
          const int key = k0 + 16 * warp + lane / 4 + 8 * i;
          const bool valid = r0 + col < N;
          float x = s[e];
          if (kBiased && valid && key < N) x += bv[e];
          const float p = valid ? __bfloat162float(__float2bfloat16(
                                      exp2f((x - lse_u[col]) * kLog2e)))
                                : 0.f;
          s[e] = p;
          dp[e] = p * (dp[e] - delta_u[col]);
        }
    uint32_t pa[4][4], sa[4][4];  // Pᵀ and dSᵀ in bf16, the A operands
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      a_frag(pa[kk], s, kk);
      a_frag(sa[kk], dp, kk);
    }
    wgmma_fence();
    fence_operand(acc_v);
    fence_operand(acc_k);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)  // a k-step is 16 q rows: 32 DP bytes
      wgmma_rs<M>(acc_v, pa[kk], mn_major<DP>(g_u) + 2 * DP * kk, 1);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs<M>(acc_k, sa[kk], mn_major<DP>(q_u) + 2 * DP * kk, 1);
    wgmma_commit();
    wgmma_wait_all();
    fence_operand(acc_v);
    fence_operand(acc_k);
    __syncthreads();  // this stage is read before the next iteration refills it
  }
  store_acc_rows<M>(dk + head, C, acc_k, k0, N);
  store_acc_rows<M>(dv + head, C, acc_v, k0, N);
}

template <typename T, int M>
cudaError_t launch_full_bwd(const void* q, const void* k, const void* v, const void* g,
                            const void* out, const float* bias, const float* lse, float* delta,
                            void* dq, void* dk, void* dv, float* dbias_part, int B, int N, int C,
                            int H, int per_group, cudaStream_t stream) {
  const dim3 grid((N + kBwdTile - 1) / kBwdTile, H, B);
  const dim3 grid1(grid.x, H, B / per_group);  // pass 1: a block per image group
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    constexpr int DP = M < 16 ? 16 : M;
    // Q, g and two stages of K, V (pass 1); K, V and two stages of Q, g (pass
    // 2); then δ (pass 1) or two stages of L and δ (pass 2)
    const size_t tiles = sizeof(T) * 6 * kTcRows * DP;
    auto passes = [&](auto pass1, auto pass2) {
      cudaError_t err = launch_with(
          pass1, grid1, kTcThreads, tiles + sizeof(float) * kTcRows, stream, (const T*)q,
          (const T*)k, (const T*)v, (const T*)g, (const T*)out, bias, lse, delta, (T*)dq,
          dbias_part, N, C, per_group);
      if (err != cudaSuccess) return err;
      return launch_with(pass2, grid, kTcThreads, tiles + sizeof(float) * 4 * kTcRows, stream,
                         (const T*)q, (const T*)k, (const T*)v, (const T*)g, bias, lse,
                         (const float*)delta, (T*)dk, (T*)dv, N, C);
    };
    // the biased instances load their bias (and dbias) values before the
    // products; the unbiased ones keep their registers
    return bias != nullptr ? passes(full_attention_bwd_wgmma_pass1<M, true>,
                                    full_attention_bwd_wgmma_pass2<M, true>)
                           : passes(full_attention_bwd_wgmma_pass1<M, false>,
                                    full_attention_bwd_wgmma_pass2<M, false>);
  } else {
    const size_t smem1 = sizeof(float) * (size_t)kBwdTile * (5 * M + 4);
    cudaError_t err = launch(full_attention_bwd_pass1<T, M>, grid1, smem1, stream, (const T*)q,
                             (const T*)k, (const T*)v, (const T*)g, bias, lse, delta, (T*)dq,
                             dbias_part, N, C, per_group);
    if (err != cudaSuccess) return err;
    const size_t smem2 = sizeof(float) * (size_t)kBwdTile * (6 * M + 4);
    return launch(full_attention_bwd_pass2<T, M>, grid, smem2, stream, (const T*)q, (const T*)k,
                  (const T*)v, (const T*)g, bias, lse, (const float*)delta, (T*)dk, (T*)dv, N,
                  C);
  }
}

template <typename T>
cudaError_t dispatch_full_bwd(const void* q, const void* k, const void* v, const void* g,
                              const void* out, const float* bias, const float* lse, float* delta,
                              void* dq, void* dk, void* dv, float* dbias_part, int B, int N,
                              int C, int H, int per_group, cudaStream_t stream) {
  switch (C / H) {
#define FULL_BWD_CASE(M)                                                                  \
  case M:                                                                                 \
    return launch_full_bwd<T, M>(q, k, v, g, out, bias, lse, delta, dq, dk, dv, dbias_part, \
                                 B, N, C, H, per_group, stream);
    FULL_BWD_CASE(8)
    FULL_BWD_CASE(16)
    FULL_BWD_CASE(32)
    FULL_BWD_CASE(64)
    FULL_BWD_CASE(128)
#undef FULL_BWD_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace vil

// q, k, v, g, out, dq, dk, dv (B, N, C); bias (H, N, N) f32 or null; lse and
// delta (B, H, N) f32; dbias_part (B / per_group, H, N, N) f32, any contents
// (each group's sum of its images' dS is written over them), or null without
// a bias; per_group divides B (1 without a bias). All contiguous. `out` is
// the forward's output (read by the bf16 kernels for δ). Launches both passes
// on `stream`; returns the first launch error.
extern "C" int full_attention_bwd(const void* q, const void* k, const void* v, const void* g,
                                  const void* out, const void* bias, const void* lse,
                                  void* delta, void* dq, void* dk, void* dv, void* dbias_part,
                                  int B, int N, int C, int H, int per_group, int is_bf16,
                                  void* stream) {
  if (per_group < 1 || B % per_group != 0) return cudaErrorInvalidValue;
  auto* s = static_cast<cudaStream_t>(stream);
  auto* bias_f = static_cast<const float*>(bias);
  auto* lse_f = static_cast<const float*>(lse);
  auto* delta_f = static_cast<float*>(delta);
  auto* db = static_cast<float*>(dbias_part);
  if (is_bf16)
    return vil::dispatch_full_bwd<__nv_bfloat16>(q, k, v, g, out, bias_f, lse_f, delta_f, dq, dk,
                                                 dv, db, B, N, C, H, per_group, s);
  return vil::dispatch_full_bwd<float>(q, k, v, g, out, bias_f, lse_f, delta_f, dq, dk, dv, db,
                                       B, N, C, H, per_group, s);
}
