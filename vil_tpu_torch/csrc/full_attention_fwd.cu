// Dense multi-head attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernels vil_tpu/ops/pallas/full_attention.py::_pallas_forward
// (Pallas body _kernel) and, for long sequences, _pallas_forward_tiled
// (_tiled_kernel). For every image b and head h:
//
//   out = softmax(q · kᵀ + bias) · v        (softmax in f32)
//   lse = log Σ exp(q · kᵀ + bias)  per query row, f32, when asked for
//
// q, k, v and out are (B, N, C) with the heads packed in C (head h is
// channels h*M .. h*M+M-1); q arrives scaled by M^-1/2. bias is an optional
// (H, N, N) f32 table.
//
// What bounds it on an H100. ViL-Small stage 3 per image: q, k, v and out
// are 4 x 197 x 384 bf16 = 0.61 MB, and 2 x 2 x 197² x 384 = 0.060 GFLOP,
// about 98 FLOP/B: under the bf16 tensor-core ridge (~295 FLOP/B), far above
// the f32 CUDA-core ridge (~20 FLOP/B). So both products go to the tensor
// cores.
//
// The kernel is chosen by the operand dtype:
//
// bf16 (full_attention_fwd_wgmma, the main path: serving and the bf16
// training step). One warpgroup (128 threads) per (64-row q tile, head,
// image), any N (49 at stage 4, 197 at stage 3, 4097 at 1024²):
//   - S = Q·Kᵀ by wgmma m64n64k16, Q and the K tile from shared memory;
//   - the online softmax in the accumulator's registers (a row spreads over a
//     quad: its max takes two shuffles, its sum is kept per thread and summed
//     once at the end); l is the f32 sum of the unrounded probabilities, so
//     LSE = m + log l holds in f32;
//   - O += P·V by wgmma m64nMk16, P rounded to bf16 in registers as the A
//     operand (where the TPU kernel rounds it, full_attention.py:114), V from
//     shared memory read MN-major, so no transposed copy exists.
//   The K/V tiles come by cp.async, 16 bytes a thread, into a ring of two
//   stages: tile t + 1 is in flight while tile t is multiplied. Rows are
//   addressed one by one and rows >= N are zero-filled by the copy itself,
//   so a ragged tile never reads the next image's rows; keys >= N are masked
//   to -inf before the max, rows >= N are never stored. (TMA would need a
//   tensor map encoded on the host for every call (cuTensorMapEncodeTiled);
//   cp.async keeps the plain C interface and the per-row zero fill.) Head
//   dims 8 and 16 pad the k-depth of Q·Kᵀ to 16 with zeros in shared memory.
//   Layouts and instructions: tensor_core.cuh.
//
// f32 (full_attention_fwd_kernel). The tensor cores take no f32 operands, and
// the f32 inputs are the parity checks' (whole-model logits within 1e-3 of
// the plain version), which need f32 arithmetic. So f32 keeps a body on the
// CUDA cores: one block of 256 threads per (64-row q tile, head, image),
// one warp per query row, an online softmax over 64-row key tiles, 64(4M+3)
// floats of shared memory.
#include "attention_common.cuh"
#include "tensor_core.cuh"

namespace vil {

constexpr int kTileQ = 64;
constexpr int kTileK = 64;

template <typename T, int M>
__global__ void __launch_bounds__(kThreads)
full_attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const float* __restrict__ bias,
                          T* __restrict__ out, float* __restrict__ lse, int N, int C) {
  extern __shared__ float smem[];
  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = blockIdx.x * kTileQ;
  const int nq = min(kTileQ, N - q0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, nwarps = blockDim.x / 32;

  float* q_s = smem;                     // kTileQ x M
  float* k_s = q_s + kTileQ * M;         // kTileK x (M + 1)
  float* v_s = k_s + kTileK * (M + 1);   // kTileK x M
  float* acc_s = v_s + kTileK * M;       // kTileQ x M
  float* m_s = acc_s + kTileQ * M;       // kTileQ
  float* l_s = m_s + kTileQ;             // kTileQ

  // row n of head h: M elements; rows are C apart
  auto row_ptr = [&](auto* base, int n) { return base + ((long)b * N + n) * C + h * M; };
  load_rows<M>(q_s, M, row_ptr(q, q0), C, nq);
  for (int idx = threadIdx.x; idx < nq * M; idx += blockDim.x) acc_s[idx] = 0.f;
  for (int idx = threadIdx.x; idx < nq; idx += blockDim.x) {
    m_s[idx] = -INFINITY;
    l_s[idx] = 0.f;
  }

  for (int k0 = 0; k0 < N; k0 += kTileK) {
    const int nk = min(kTileK, N - k0);
    __syncthreads();  // the previous tile is consumed; q and the state are set
    load_rows<M>(k_s, M + 1, row_ptr(k, k0), C, nk);
    load_rows<M>(v_s, M, row_ptr(v, k0), C, nk);
    __syncthreads();
    for (int r = warp; r < nq; r += nwarps) {
      RowState<M> st;
      load_state(st, m_s, l_s, acc_s, r, lane);
      const float* bias_r =
          bias != nullptr ? bias + ((long)h * N + q0 + r) * N + k0 : nullptr;
      fold_keys(st, q_s + r * M, k_s, v_s, nk, bias_r, nullptr, lane);
      store_state(st, m_s, l_s, acc_s, r, lane);
    }
  }
  __syncthreads();
  for (int r = warp; r < nq; r += nwarps) store_row<M>(row_ptr(out, q0 + r), acc_s, l_s, r, lane);
  if (lse != nullptr) {  // (B, H, N): m + log l of the online softmax
    float* lse_t = lse + ((long)b * gridDim.y + h) * N + q0;
    for (int r = threadIdx.x; r < nq; r += blockDim.x) lse_t[r] = m_s[r] + logf(l_s[r]);
  }
}

// The bf16 forward on the tensor cores (the note at the top). One warpgroup
// per (64-row q tile, head, image); scores are kept in base 2 (s · log2 e).
template <int M>
__global__ void __launch_bounds__(kTcThreads)
full_attention_fwd_wgmma(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v, const float* __restrict__ bias,
                         __nv_bfloat16* __restrict__ out, float* __restrict__ lse, int N, int C) {
  constexpr int DP = M < 16 ? 16 : M, TILE = kTcRows * DP;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* kv_s = q_s + TILE;  // stage s: the K tile at kv_s + 2 s TILE, V after it
  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = blockIdx.x * kTcRows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long head = (long)b * N * C + h * M;  // row 0, head h, image b

  stage_tile<M>(q_s, q + head + (long)q0 * C, C, N - q0);
  stage_tile<M>(kv_s, k + head, C, N);
  stage_tile<M>(kv_s + TILE, v + head, C, N);
  cp_async_commit();

  float o[M / 2];
#pragma unroll
  for (int i = 0; i < M / 2; ++i) o[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};  // l: this thread's columns
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

    float s[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)  // a k-step is 256 bytes: 16 descriptor units
      wgmma_ss_n64(s, k_major<DP>(q_s) + 16 * kk, k_major<DP>(k_t) + 16 * kk, kk > 0);
    wgmma_commit();
    wgmma_wait_all();
    fence_operand(s);

    const int k0 = t * kTcRows;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int key = k0 + 8 * j + 2 * (lane % 4) + c;
          const int row = q0 + 16 * warp + lane / 4 + 8 * i;
          float x = s[4 * j + 2 * i + c];
          if (bias != nullptr && row < N && key < N) x += bias[((long)h * N + row) * N + key];
          x = key < N ? x * kLog2e : -INFINITY;
          s[4 * j + 2 * i + c] = x;
          mx[i] = fmaxf(mx[i], x);
        }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {  // a row's max over its quad
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(kFullMask, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(kFullMask, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);  // finite: every tile holds a key < N
      alpha[i] = exp2f(m[i] - m_new);           // 0 on the first tile
      m[i] = m_new;
      l[i] *= alpha[i];
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float p = exp2f(s[4 * j + 2 * i + c] - m[i]);
          s[4 * j + 2 * i + c] = p;
          l[i] += p;  // the unrounded probability
        }
#pragma unroll
    for (int j = 0; j < M / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[4 * j + e] *= alpha[e / 2];

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
    __syncthreads();  // this stage is read before the next iteration refills it
  }

  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(kFullMask, l[i], 1);
    l[i] += __shfl_xor_sync(kFullMask, l[i], 2);
    inv[i] = 1.f / l[i];
    const int row = q0 + 16 * warp + lane / 4 + 8 * i;
    if (lse != nullptr && lane % 4 == 0 && row < N)  // (B, H, N), natural log
      lse[((long)b * gridDim.y + h) * N + row] = m[i] * kLn2 + logf(l[i]);
  }
#pragma unroll
  for (int j = 0; j < M / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[4 * j + e] *= inv[e / 2];
  store_acc_rows<M>(out + head, C, o, q0, N);
}

template <typename T, int M>
cudaError_t launch_full(const void* q, const void* k, const void* v, const float* bias, void* out,
                        float* lse, int B, int N, int C, int H, cudaStream_t stream) {
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    constexpr int DP = M < 16 ? 16 : M;
    const size_t smem = sizeof(T) * 5 * kTcRows * DP;  // Q, two stages of K and V
    const dim3 grid((N + kTcRows - 1) / kTcRows, H, B);
    return launch_with(full_attention_fwd_wgmma<M>, grid, kTcThreads, smem, stream,
                       (const T*)q, (const T*)k, (const T*)v, bias, (T*)out, lse, N, C);
  } else {
    // q_s, acc_s, m_s, l_s for kTileQ rows; k_s, v_s for kTileK rows
    const size_t smem = sizeof(float) * ((size_t)kTileQ * (2 * M + 2) + kTileK * (2 * M + 1));
    const dim3 grid((N + kTileQ - 1) / kTileQ, H, B);
    return launch(full_attention_fwd_kernel<T, M>, grid, smem, stream, (const T*)q, (const T*)k,
                  (const T*)v, bias, (T*)out, lse, N, C);
  }
}

template <typename T>
cudaError_t dispatch_full(const void* q, const void* k, const void* v, const float* bias,
                          void* out, float* lse, int B, int N, int C, int H,
                          cudaStream_t stream) {
  switch (C / H) {
#define FULL_CASE(M) \
  case M:            \
    return launch_full<T, M>(q, k, v, bias, out, lse, B, N, C, H, stream);
    FULL_CASE(8)
    FULL_CASE(16)
    FULL_CASE(32)
    FULL_CASE(64)
    FULL_CASE(128)
#undef FULL_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace vil

// q, k, v, out (B, N, C); bias (H, N, N) f32 or null; lse (B, H, N) f32 or
// null. All contiguous. Returns the launch's error.
extern "C" int full_attention_fwd(const void* q, const void* k, const void* v, const void* bias,
                                  void* out, void* lse, int B, int N, int C, int H, int is_bf16,
                                  void* stream) {
  auto* s = static_cast<cudaStream_t>(stream);
  auto* bias_f = static_cast<const float*>(bias);
  auto* lse_f = static_cast<float*>(lse);
  if (is_bf16)
    return vil::dispatch_full<__nv_bfloat16>(q, k, v, bias_f, out, lse_f, B, N, C, H, s);
  return vil::dispatch_full<float>(q, k, v, bias_f, out, lse_f, B, N, C, H, s);
}
