// Sliding-chunk attention on Hopper's tensor cores (sm_90a), bf16: the
// bodies of the forward B1 (vil_attention_fwd.cu, over FullNbh), of the
// fused block forward B9a's attention (vil_block_fwd.cu, over FullNbh, by
// B1's launch), of the halo form B7a (vil_attention_halo_fwd.cu, over
// HaloNbh), of the sampled-neighbour forward B5 (vil_mode_attention_fwd.cu,
// over SampledNbh), of the backward B2 (vil_attention_bwd.cu, over FullNbh)
// and B9b's attention (vil_block_bwd.cu), of its halo form B7b
// (vil_attention_halo_bwd.cu, over HaloNbh) and of the sampled-neighbour
// backward B6 (vil_mode_attention_bwd.cu, over SampledNbh). The f32 kernels
// keep the CUDA-core bodies of sliding_chunk.cuh.
//
// The forward (sliding_chunk_fwd_tc) is a flash forward over the same
// concatenated key tiles as pass 1 below: one warpgroup per (64-row slice of
// a query chunk, head, image), S = Q·Kᵀ and O += P·V by wgmma, the online
// softmax in the accumulator's registers (the note at the top of
// full_attention_fwd.cu), P rounded to bf16 as the A operand of P·V.
//
// The backward:
//
// The work per (image, head), in the neighbourhood and column order of
// sliding_chunk.cuh ([glo ‖ nbh 0 ‖ ... ‖ nbh kCount-1], cols = nglo + kCount W²):
//
//   P  = exp(S + bias + mask - L),   dP = g · Vᵀ,   δ = rowsum(g ∘ out)
//   dS = P ∘ (dP - δ)
//   dQ = dS · K;  dK, dV of each key chunk = Σ over the query chunks that see
//   it of dSᵀ · q and Pᵀ · g
//
// (δ = rowsum(P ∘ dP) = rowsum(g ∘ out): the identity full_attention.py:592
// states; the TPU kernel sums rowsum(P ∘ dP), vil_backward.py:374.)
//
// The products are too small for the tensor cores chunk by chunk (W² = 49
// query rows, head dim 32 at ViL-Small's stage 1), and padding each 49-row
// chunk to wgmma's 64 rows would waste 23% of every product. So both passes
// concatenate rows across chunks:
//   pass 1, one warpgroup per (64-row slice of a query chunk, head, image):
//     the chunk's W² query rows (zero-filled to 64) against the column tiles
//     of 64 keys each, cut from the concatenated [glo ‖ 9 neighbour chunks]
//     keys (442 at nglo 1: 7 tiles, 1% of the columns wasted); each staged
//     key row's address comes from its column. δ in the prologue, then per
//     tile S = Q·Kᵀ and dP = g·Vᵀ (operands from shared memory), P and dS in
//     the accumulators, dQ += dS·K (dS as the register operand). Writes δ
//     for pass 2, dQ, P_glo and dS_glo of the global columns, and the dbias
//     partials: with a bias the block walks a group of chunks_per_block
//     chunks of its image, and adds into its own slice of the (B, groups, H,
//     W², cols) partial, which no other block writes (B2 takes a few chunks
//     a group; B6, B7b and B9b's attention the whole image as one group).
//   pass 2, one warpgroup per (64-key slice of a chunk of the K/V grid, head,
//     image): its W² keys (zero-filled to 64) against the query rows of every
//     (neighbour n, query chunk) that sees it, concatenated into 64-row tiles
//     (441 rows in 7 tiles for FullNbh). Each staged query row carries its
//     own L, δ and mask and bias offsets (column nglo + n W² + key), so Sᵀ =
//     K·Qᵀ and dPᵀ = V·gᵀ form Pᵀ and dSᵀ, and dV += Pᵀ·g, dK += dSᵀ·Q. The
//     list holds only the neighbours that exist: HaloNbh's halo rows are seen
//     by 3 of the 9, and their list is 3 W² rows long, with no branch per
//     row. On cyclic grids with mx or my ≤ 2 a query chunk is in the list
//     once per neighbour it sees this chunk as; each occurrence adds.
// No atomics: two launches on the same inputs give bitwise-equal gradients.
//
// P is rounded to bf16 before dS and the products, dS after the dbias
// partial and before the products, where the TPU kernel rounds them
// (vil_backward.py:376, :393). Every body takes bf16_exp, vil_tpu's
// BF16_EXP (vil_kernel.py:71, on by default there and in the wrappers):
// with it the exponent's input, S − m in the forward (against the running
// maximum) and S − L in both passes, is rounded to bf16 before exp, as
// vil_kernel.py:388-389 and vil_backward.py's _probs_lse round it; without
// it the exponent takes the f32 difference. The forward's denominator and
// its LSE, log Σ P, sum the P it multiplies V by, as vil_kernel.py's do, so
// under BF16_EXP the LSE moves off the scores' own log Σ exp(S) by the
// exponents' rounding (≈ 4e-4 rms at unit scale). Tiles come by cp.async
// into a two-stage ring, one row at a time with a zero fill (no read across
// images or chunks);
// keys (pass 1) and query rows (pass 2) past the list get P = 0 and are never
// stored. Layouts and instructions: tensor_core.cuh.
#pragma once

#include "sliding_chunk.cuh"
#include "tensor_core.cuh"

namespace vil {

using bf16 = __nv_bfloat16;

// x rounded to bf16 (round to nearest even), back in f32.
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// P = exp(x - L) rounded to bf16, as the TPU kernel rounds it: one rounding
// of one expression in both passes, so that dQ and dK/dV see the same P.
// With bf16_exp (vil_tpu's BF16_EXP, its default) the exponent's input
// x - L is rounded to bf16 first, as vil_backward.py's _probs_lse rounds it:
// P = bf16(exp(bf16(x - L))).
__device__ __forceinline__ float prob_bf16(float x, float lse, bool bf16_exp) {
  if (bf16_exp) return round_bf16(exp2f(round_bf16(x - lse) * kLog2e));
  return round_bf16(exp2f(__fmaf_rn(x, kLog2e, -__fmul_rn(lse, kLog2e))));
}

// The concatenated [glo ‖ neighbour 0 ‖ ... ‖ neighbour kCount-1] key (or
// value) rows of query chunk (i, j), head h, image b: row `col` of them, in
// the score columns' order, read in place from k or v (K/V grid of
// kv_rows(nbh, mx) x my chunks) and k_glo or v_glo; null past the columns.
// The forward and pass 1 stage their 64-key tiles through it, so that a tile
// crosses chunk boundaries.
template <typename Nbh>
struct ConcatKeys {
  Nbh nbh;
  int b, i, j, mx, my, w2, C, nglo, cols;
  int hm;  // h * M: the head's first channel
  __device__ __forceinline__ const bf16* operator()(const bf16* base, const bf16* glo,
                                                    int col) const {
    if (col >= cols) return nullptr;
    if (col < nglo) return glo + ((long)b * nglo + col) * C + hm;
    const int n = (col - nglo) / w2, t = col - nglo - n * w2;
    const int ci = key_row(nbh, i, n, mx), cj = (j + nbh.dy(n) + my) % my;
    return base + ((((long)b * kv_rows(nbh, mx) + ci) * my + cj) * w2 + t) * C + hm;
  }
  // key tile t (columns 64 t .. 64 t + 63) of k and of v into dst and
  // dst + 64 DP, by cp.async (uncommitted); rows past the columns are zeros
  template <int M>
  __device__ __forceinline__ void stage(bf16* dst, const bf16* k, const bf16* k_glo,
                                        const bf16* v, const bf16* v_glo, int t) const {
    constexpr int DP = M < 16 ? 16 : M;
    stage_rows<M>(dst, k, [&](int r) { return (*this)(k, k_glo, t * kTcRows + r); });
    stage_rows<M>(dst + kTcRows * DP, k,
                  [&](int r) { return (*this)(v, v_glo, t * kTcRows + r); });
  }
};

// Depth of the forward's ring of K/V tiles (the note in vil_attention_fwd.cu)
constexpr int kFwdStages = 3;

// The forward (the note at the top). grid (slices · mx · my, H, B), slices =
// ceil(W² / 64): block x is slice x % slices of query chunk x / slices.
// Writes out and, when lse is not null, the per-row natural log-sum-exp
// (B, H, mx, my, W²) in f32. Shared memory: tc_fwd_smem_bytes.
template <int M, typename Nbh>
__device__ __forceinline__ void sliding_chunk_fwd_tc(
    Nbh nbh, const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ k_glo, const bf16* __restrict__ v_glo,
    const float* __restrict__ bias, const float* __restrict__ mask, bf16* __restrict__ out,
    float* __restrict__ lse, int mx, int my, int w2, int C, int nglo, int wq,
    bool bf16_exp) {
  constexpr int DP = M < 16 ? 16 : M, TILE = kTcRows * DP;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* kv_s = q_s + TILE;  // stage s: the K tile at kv_s + 2 s TILE, V after it
  // Wq = 1: the chunk's mask row, -inf past the columns
  float* mask_s = reinterpret_cast<float*>(kv_s + 2 * kFwdStages * TILE);
  const int h = blockIdx.y, b = blockIdx.z, H = gridDim.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int slices = (w2 + kTcRows - 1) / kTcRows;
  const int chunk = blockIdx.x / slices, r0 = blockIdx.x % slices * kTcRows;  // i * my + j
  const int nr = min(kTcRows, w2 - r0);  // query rows of this slice
  const int i = chunk / my, j = chunk % my;
  const int cols = nglo + Nbh::kCount * w2;
  const int tiles = (cols + kTcRows - 1) / kTcRows;
  const long head = (((long)b * mx + i) * my + j) * w2 * C + h * M;  // row 0 of the chunk
  const float* mask_c = mask + (long)chunk * wq * cols;
  const float* bias_h = bias != nullptr ? bias + (long)h * w2 * cols : nullptr;
  const ConcatKeys<Nbh> keys{nbh, b, i, j, mx, my, w2, C, nglo, cols, h * M};

  // the ring: tiles 0 .. kFwdStages - 2 in flight (Q with tile 0), one
  // commit group per tile, empty past the last
  stage_tile<M>(q_s, q + head + (long)r0 * C, C, nr);
#pragma unroll
  for (int t = 0; t < kFwdStages - 1; ++t) {
    if (t < tiles) keys.template stage<M>(kv_s + 2 * t * TILE, k, k_glo, v, v_glo, t);
    cp_async_commit();
  }
  if (wq == 1)
    for (int c = threadIdx.x; c < tiles * kTcRows; c += kTcThreads)
      mask_s[c] = c < cols ? mask_c[c] : -INFINITY;

  float o[M / 2];
#pragma unroll
  for (int x = 0; x < M / 2; ++x) o[x] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};  // l: this thread's columns
  for (int t = 0; t < tiles; ++t) {
    cp_async_wait<kFwdStages - 2>();  // tile t has landed (this thread's copies)
    __syncthreads();  // everyone's copies; tile t - 1's stage is no longer read
    if (t + kFwdStages - 1 < tiles) {
      const int t1 = t + kFwdStages - 1;
      keys.template stage<M>(kv_s + 2 * (t1 % kFwdStages) * TILE, k, k_glo, v, v_glo, t1);
    }
    cp_async_commit();
    const bf16* k_t = kv_s + 2 * (t % kFwdStages) * TILE;
    const bf16* v_t = k_t + TILE;

    float s[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)  // a k-step is 256 bytes: 16 descriptor units
      wgmma_ss_n64(s, k_major<DP>(q_s) + 16 * kk, k_major<DP>(k_t) + 16 * kk, kk > 0);
    wgmma_commit();
    wgmma_wait_all();
    fence_operand(s);

    // S + bias + mask; -inf past the columns, so padded keys get P = 0.
    // The mask's own fill is finite, so a row whose keys are all masked
    // stays finite, and the max stays in natural units (log2 e scales only
    // the exponents): such a row's x - m is exactly 0 and its LSE the
    // reference's, where a max in base 2 would move it by an ulp of 1.7e38.
    float mx_t[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int jj = 0; jj < 8; ++jj)
#pragma unroll
      for (int x = 0; x < 2; ++x)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int e = 4 * jj + 2 * x + c;
          const int col = t * kTcRows + 8 * jj + 2 * (lane % 4) + c;
          const int r = 16 * warp + lane / 4 + 8 * x;  // the slice's row
          const bool inside = r < nr && col < cols;
          float xs = s[e];
          if (bias_h != nullptr && inside) xs += bias_h[(long)(r0 + r) * cols + col];
          xs += wq == 1 ? mask_s[col]
                : col >= cols ? -INFINITY
                : inside ? mask_c[(long)(r0 + r) * cols + col]
                         : 0.f;
          s[e] = xs;
          mx_t[x] = fmaxf(mx_t[x], xs);
        }
    float alpha[2];
#pragma unroll
    for (int x = 0; x < 2; ++x) {  // a row's max over its quad
      mx_t[x] = fmaxf(mx_t[x], __shfl_xor_sync(kFullMask, mx_t[x], 1));
      mx_t[x] = fmaxf(mx_t[x], __shfl_xor_sync(kFullMask, mx_t[x], 2));
      const float m_new = fmaxf(m[x], mx_t[x]);  // finite: tile 0 holds column 0 < cols
      alpha[x] = exp2f((m[x] - m_new) * kLog2e);  // 0 on the first tile
      m[x] = m_new;
      l[x] *= alpha[x];
    }
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      // vil_kernel.py's BF16_EXP: the shifted score rounded to bf16
      const float z = s[e] - m[(e / 2) % 2];
      const float p = exp2f((bf16_exp ? round_bf16(z) : z) * kLog2e);
      s[e] = p;
      l[(e / 2) % 2] += p;  // the unrounded probability
    }
#pragma unroll
    for (int jj = 0; jj < M / 8; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[4 * jj + e] *= alpha[e / 2];

    uint32_t a[4][4];  // P in bf16, the A operand of P·V
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) a_frag(a[kk], s, kk);
    wgmma_fence();
    fence_operand(o);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)  // a k-step is 16 V rows: 32 DP bytes
      wgmma_rs<M>(o, a[kk], mn_major<DP>(v_t) + 2 * DP * kk, 1);
    wgmma_commit();
    wgmma_wait_all();
    fence_operand(o);
  }
  cp_async_wait<0>();  // no copy outlives the block (the empty groups)

  float inv[2];
#pragma unroll
  for (int x = 0; x < 2; ++x) {
    l[x] += __shfl_xor_sync(kFullMask, l[x], 1);
    l[x] += __shfl_xor_sync(kFullMask, l[x], 2);
    inv[x] = 1.f / l[x];
    const int r = 16 * warp + lane / 4 + 8 * x;
    if (lse != nullptr && lane % 4 == 0 && r < nr)  // (B, H, mx, my, W²), natural log
      lse[(((long)b * H + h) * mx * my + chunk) * w2 + r0 + r] = m[x] + logf(l[x]);
  }
#pragma unroll
  for (int jj = 0; jj < M / 8; ++jj)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[4 * jj + e] *= inv[e / 2];
  store_acc_rows<M>(out + head, C, o, r0, r0 + nr);
}

// Shared memory of the forward: Q, kFwdStages stages of K and V, and the
// mask row of `cols` columns rounded up to whole tiles.
constexpr size_t tc_fwd_smem_bytes(int M, int cols) {
  return sizeof(bf16) * (1 + 2 * kFwdStages) * kTcRows * (M < 16 ? 16 : M) +
         sizeof(float) * ((cols + kTcRows - 1) / kTcRows) * kTcRows;
}

// Launch a kernel whose body is sliding_chunk_fwd_tc over FullNbh (B1's
// vil_attention_fwd_wgmma and B9a's vil_block_fwd_attn_wgmma), where
// kernel_for(std::integral_constant<int, M>{}) is its instance for head dim
// M = C / H: grid (slices · mx · my, H, B), one warpgroup a block. Returns
// the launch's error.
template <typename KernelFor>
cudaError_t launch_full_fwd_tc(KernelFor kernel_for, const bf16* q, const bf16* k,
                               const bf16* v, const bf16* k_glo, const bf16* v_glo,
                               const float* bias, const float* mask, bf16* out, float* lse,
                               int B, int mx, int my, int w2, int C, int H, int nglo, int wq,
                               bool bf16_exp, cudaStream_t stream) {
  return dispatch_head_dim(C / H, [&](auto m) {
    constexpr int M = decltype(m)::value;
    const int slices = (w2 + kTcRows - 1) / kTcRows;  // 64-row slices of a chunk
    return launch_with(kernel_for(m), dim3(slices * mx * my, H, B), kTcThreads,
                       tc_fwd_smem_bytes(M, nglo + FullNbh::kCount * w2), stream, q, k, v,
                       k_glo, v_glo, bias, mask, out, lse, mx, my, w2, C, nglo, wq, bf16_exp);
  });
}

// Pass 1 (the note at the top). grid (slices · groups, H, B), slices =
// ceil(W² / 64), groups = ceil(mx · my / chunks_per_block): block x is slice
// x % slices of chunk group x / slices, and dbias_part (zero on entry) is
// (B, groups, H, W², cols). kPrefetch (B2's biased instance; bias and
// dbias_part given) loads each tile's bias and dbias values into registers
// before its products, so that the loads run under them; the others read
// them after the products, keeping their registers.
template <int M, typename Nbh, bool kPrefetch = false>
__device__ __forceinline__ void sliding_chunk_bwd_tc_pass1(
    Nbh nbh, const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ k_glo, const bf16* __restrict__ v_glo, const bf16* __restrict__ g,
    const bf16* __restrict__ out, const float* __restrict__ bias, const float* __restrict__ mask,
    const float* __restrict__ lse, float* __restrict__ delta, bf16* __restrict__ dq,
    float* __restrict__ p_glo, float* __restrict__ ds_glo, float* __restrict__ dbias_part,
    int mx, int my, int w2, int C, int nglo, int wq, int chunks_per_block, bool bf16_exp) {
  constexpr int DP = M < 16 ? 16 : M, TILE = kTcRows * DP;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* g_s = q_s + TILE;
  bf16* kv_s = g_s + TILE;  // stage s: the K tile at kv_s + 2 s TILE, V after it
  float* delta_s = reinterpret_cast<float*>(kv_s + 4 * TILE);  // kTcRows
  const int h = blockIdx.y, b = blockIdx.z, H = gridDim.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int slices = (w2 + kTcRows - 1) / kTcRows;
  const int slice = blockIdx.x % slices, r0 = slice * kTcRows;
  const int group = blockIdx.x / slices, groups = gridDim.x / slices;
  const int nr = min(kTcRows, w2 - r0);  // query rows of this slice
  const int cols = nglo + Nbh::kCount * w2;
  const int tiles = (cols + kTcRows - 1) / kTcRows;
  const float* bias_h = bias != nullptr ? bias + (long)h * w2 * cols : nullptr;
  // (b, group, h, row 0) of this block's dbias partial
  float* db = dbias_part != nullptr
                  ? dbias_part + (((long)b * groups + group) * H + h) * w2 * cols
                  : nullptr;

  for (int cc = 0; cc < chunks_per_block; ++cc) {
    const int chunk = group * chunks_per_block + cc;  // i * my + j
    if (chunk >= mx * my) break;                      // the last group's ragged end
    const int i = chunk / my, j = chunk % my;
    const long head = (((long)b * mx + i) * my + j) * w2 * C + h * M;  // row 0 of the chunk
    const long row0 = (((long)b * H + h) * mx * my + chunk) * w2;      // (b, h, i, j, 0)
    const float* mask_c = mask + (long)chunk * wq * cols;
    const ConcatKeys<Nbh> keys{nbh, b, i, j, mx, my, w2, C, nglo, cols, h * M};
    auto stage_keys = [&](int t) {  // key tile t into stage t & 1
      keys.template stage<M>(kv_s + (t & 1) * 2 * TILE, k, k_glo, v, v_glo, t);
    };

    __syncthreads();  // the previous chunk is done with shared memory
    stage_tile<M>(q_s, q + head + (long)r0 * C, C, nr);
    stage_tile<M>(g_s, g + head + (long)r0 * C, C, nr);
    stage_keys(0);
    cp_async_commit();

    {  // δ = rowsum(g ∘ out) in f32, two threads a row, while the copies fly
      const int r = threadIdx.x / 2, half = threadIdx.x % 2;
      float d = 0.f;
      if (r < nr) {
        const long at = head + (long)(r0 + r) * C + half * (M / 2);
#pragma unroll
        for (int e = 0; e < M / 2; e += 2) {
          const float2 gg = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(g + at + e));
          const float2 oo =
              __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(out + at + e));
          d = fmaf(gg.x, oo.x, fmaf(gg.y, oo.y, d));
        }
      }
      d += __shfl_xor_sync(kFullMask, d, 1);
      if (half == 0) {
        delta_s[r] = d;  // 0 past the slice's rows
        if (r < nr) delta[row0 + r0 + r] = d;
      }
    }
    __syncthreads();
    float lr[2], dl[2];  // L and δ of this thread's two rows; 0 past nr
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      const int r = 16 * warp + lane / 4 + 8 * x;
      lr[x] = r < nr ? lse[row0 + r0 + r] : 0.f;
      dl[x] = delta_s[r];
    }

    float acc[M / 2];  // dQ
#pragma unroll
    for (int x = 0; x < M / 2; ++x) acc[x] = 0.f;
    for (int t = 0; t < tiles; ++t) {
      const bf16* k_t = kv_s + (t & 1) * 2 * TILE;
      const bf16* v_t = k_t + TILE;
      if (t + 1 < tiles) {  // tile t + 1 into the other stage, in flight during tile t
        stage_keys(t + 1);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();

      float bv[32], ov[32];  // kPrefetch: the bias and dbias values of slot e
      if constexpr (kPrefetch) {
#pragma unroll
        for (int e = 0; e < 32; ++e) {
          const int col = t * kTcRows + 8 * (e / 4) + 2 * (lane % 4) + e % 2;
          const int r = 16 * warp + lane / 4 + 8 * (e / 2 % 2);
          const bool inside = r < nr && col < cols;
          bv[e] = inside ? bias_h[(long)(r0 + r) * cols + col] : 0.f;
          ov[e] = inside ? db[(long)(r0 + r) * cols + col] : 0.f;
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
      for (int jj = 0; jj < 8; ++jj)
#pragma unroll
        for (int x = 0; x < 2; ++x)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int e = 4 * jj + 2 * x + c;
            const int col = t * kTcRows + 8 * jj + 2 * (lane % 4) + c;
            const int r = 16 * warp + lane / 4 + 8 * x, qr = r0 + r;  // the chunk's row
            const bool inside = r < nr && col < cols;
            float xs = s[e];
            if (inside) {
              xs += mask_c[(long)(wq == 1 ? 0 : qr) * cols + col];
              if constexpr (kPrefetch)
                xs += bv[e];
              else if (bias_h != nullptr)
                xs += bias_h[(long)qr * cols + col];
            }
            const float p = inside ? prob_bf16(xs, lr[x], bf16_exp) : 0.f;  // 0 past the columns
            const float ds = p * (dp[e] - dl[x]);
            if (inside && col < nglo) {  // (b, h, i, j, row, glo column)
              p_glo[(row0 + qr) * nglo + col] = p;
              ds_glo[(row0 + qr) * nglo + col] = ds;
            }
            if constexpr (kPrefetch) {  // (row, column) of the slice: this thread's alone
              if (inside) db[(long)qr * cols + col] = ov[e] + ds;
            } else if (db != nullptr && inside) {
              db[(long)qr * cols + col] += ds;
            }
            s[e] = ds;
          }
      uint32_t a[4][4];  // dS in bf16, the A operand of dS·K
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) a_frag(a[kk], s, kk);
      wgmma_fence();
      fence_operand(acc);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)  // a k-step is 16 key rows: 32 DP bytes
        wgmma_rs<M>(acc, a[kk], mn_major<DP>(k_t) + 2 * DP * kk, 1);
      wgmma_commit();
      wgmma_wait_all();
      fence_operand(acc);
      __syncthreads();  // this stage is read before the next iteration refills it
    }
    store_acc_rows<M>(dq + head, C, acc, r0, r0 + nr);
  }
}

// Pass 2 (the note at the top). grid (slices · kv_rows · my, H, B),
// slices = ceil(W² / 64).
template <int M, typename Nbh>
__device__ __forceinline__ void sliding_chunk_bwd_tc_pass2(
    Nbh nbh, const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ g, const float* __restrict__ bias, const float* __restrict__ mask,
    const float* __restrict__ lse, const float* __restrict__ delta, bf16* __restrict__ dk,
    bf16* __restrict__ dv, int mx, int my, int w2, int C, int nglo, int wq, bool bf16_exp) {
  constexpr int DP = M < 16 ? 16 : M, TILE = kTcRows * DP;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* k_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* v_s = k_s + TILE;
  bf16* qg_s = v_s + TILE;  // stage s: the Q tile at qg_s + 2 s TILE, g after it
  // stage s of the query rows' L and δ (ld_s + 2 s kTcRows, δ after L) and of
  // their mask and bias offsets (off_s + 2 s kTcRows, bias after mask; mask
  // -1 for a row past the list)
  float* ld_s = reinterpret_cast<float*>(qg_s + 4 * TILE);
  int* off_s = reinterpret_cast<int*>(ld_s + 4 * kTcRows);
  int* nbr_s = off_s + 4 * kTcRows;  // the neighbours that see this chunk, in order
  const int h = blockIdx.y, b = blockIdx.z, H = gridDim.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int slices = (w2 + kTcRows - 1) / kTcRows;
  const int chunk = blockIdx.x / slices;  // the key chunk r * my + c of the K/V grid
  const int k0 = blockIdx.x % slices * kTcRows, nk = min(kTcRows, w2 - k0);
  const int r = chunk / my, c = chunk % my;
  const int mxk = kv_rows(nbh, mx);
  const int cols = nglo + Nbh::kCount * w2;
  const long kbase = (((long)b * mxk + r) * my + c) * w2 * C + h * M;  // row 0 of the chunk

  int count = 0;  // neighbours n of some query chunk; the same in every thread
#pragma unroll
  for (int n = 0; n < Nbh::kCount; ++n) {
    if (query_row(nbh, r, n, mx) < 0) continue;
    if (threadIdx.x == 0) nbr_s[count] = n;
    ++count;
  }
  const int rows = count * w2;  // the query rows of the list
  const int tiles = max(1, (rows + kTcRows - 1) / kTcRows);
  __syncthreads();

  // the query chunk of list row u and its row t in it, or -1 past the list
  auto list_row = [&](int u, int& n, int& t) -> int {
    if (u >= rows) return -1;
    const int slot = u / w2;
    n = nbr_s[slot];
    t = u - slot * w2;
    return query_row(nbh, r, n, mx) * my + (c - nbh.dy(n) + my) % my;
  };
  auto stage_query_tile = [&](int tile) {  // Q, g, L, δ and offsets of tile into stage tile & 1
    bf16* dst = qg_s + (tile & 1) * 2 * TILE;
    auto src = [&](const bf16* base, int rr) -> const bf16* {
      int n, t;
      const int qc = list_row(tile * kTcRows + rr, n, t);
      return qc < 0 ? nullptr : base + (((long)b * mx * my + qc) * w2 + t) * C + h * M;
    };
    stage_rows<M>(dst, q, [&](int rr) { return src(q, rr); });
    stage_rows<M>(dst + TILE, q, [&](int rr) { return src(g, rr); });
    const int rr = threadIdx.x % kTcRows, which = threadIdx.x / kTcRows;  // 0: L, mask; 1: δ, bias
    int n = 0, t = 0;
    const int qc = list_row(tile * kTcRows + rr, n, t);
    const long at = (((long)b * H + h) * mx * my + (qc < 0 ? 0 : qc)) * w2 + t;
    const float* from = which == 0 ? lse : delta;
    cp_async4(smem_u32(ld_s + ((tile & 1) * 2 + which) * kTcRows + rr), from + at, qc < 0 ? 0 : 4);
    const int col0 = nglo + n * w2;  // this row's columns of the key chunk's row 0
    off_s[((tile & 1) * 2 + which) * kTcRows + rr] =
        qc < 0 ? -1
               : which == 0 ? (qc * wq + (wq == 1 ? 0 : t)) * cols + col0
                            : (h * w2 + t) * cols + col0;
  };

  stage_tile<M>(k_s, k + kbase + (long)k0 * C, C, nk);
  stage_tile<M>(v_s, v + kbase + (long)k0 * C, C, nk);
  stage_query_tile(0);
  cp_async_commit();

  float acc_k[M / 2], acc_v[M / 2];  // dK, dV
#pragma unroll
  for (int x = 0; x < M / 2; ++x) acc_k[x] = acc_v[x] = 0.f;
  for (int u = 0; u < tiles; ++u) {
    const bf16* q_u = qg_s + (u & 1) * 2 * TILE;
    const bf16* g_u = q_u + TILE;
    const float* lse_u = ld_s + (u & 1) * 2 * kTcRows;
    const float* delta_u = lse_u + kTcRows;
    const int* moff_u = off_s + (u & 1) * 2 * kTcRows;
    const int* boff_u = moff_u + kTcRows;
    if (u + 1 < tiles) {
      stage_query_tile(u + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    float s[32], dp[32];  // Sᵀ and dPᵀ: row = key, column = list row
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
    for (int jj = 0; jj < 8; ++jj)
#pragma unroll
      for (int x = 0; x < 2; ++x)
#pragma unroll
        for (int cc = 0; cc < 2; ++cc) {
          const int e = 4 * jj + 2 * x + cc;
          const int col = 8 * jj + 2 * (lane % 4) + cc;       // list row within the tile
          const int key = k0 + 16 * warp + lane / 4 + 8 * x;  // the chunk's key row
          const int moff = moff_u[col];
          const bool valid = moff >= 0 && key < k0 + nk;
          float xs = s[e];
          if (valid) {
            xs += mask[moff + key];
            if (bias != nullptr) xs += bias[boff_u[col] + key];
          }
          const float p = valid ? prob_bf16(xs, lse_u[col], bf16_exp) : 0.f;
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
    for (int kk = 0; kk < 4; ++kk)  // a k-step is 16 list rows: 32 DP bytes
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
  store_acc_rows<M>(dk + kbase, C, acc_k, k0, k0 + nk);
  store_acc_rows<M>(dv + kbase, C, acc_v, k0, k0 + nk);
}

// Shared memory of the two backward passes: Q, g and two stages of K, V (pass 1), or
// K, V and two stages of Q, g (pass 2), then δ (pass 1) or two stages of L, δ
// and the two offsets and the neighbour list (pass 2).
constexpr size_t tc_pass1_smem_bytes(int M) {
  return sizeof(bf16) * 6 * kTcRows * (M < 16 ? 16 : M) + sizeof(float) * kTcRows;
}
constexpr size_t tc_pass2_smem_bytes(int M) {
  return sizeof(bf16) * 6 * kTcRows * (M < 16 ? 16 : M) + sizeof(float) * 8 * kTcRows + 64;
}

}  // namespace vil
