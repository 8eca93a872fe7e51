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
// about 98 FLOP/B: under the bf16 tensor-core ridge (~295 FLOP/B). This
// first version does its arithmetic in f32 on the CUDA cores (ridge
// ~20 FLOP/B), so it is bound by instruction throughput: f32 FMAs and their
// shared-memory reads.
//
// What the design does about it. One block per (b, h, 64-row q tile) walks
// the keys in 64-row tiles with an online softmax, so shared memory stays at
// 64(4M+3) floats for any N (N = 49 at stage 4, 4097 at 1024² stage 3) and no
// score matrix reaches device memory. The ragged last tile of q and of k is
// handled by row counts, not padding. Tensor cores (wgmma on the 64-row q
// tile) are the next step.
#include "attention_common.cuh"

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

template <typename T, int M>
cudaError_t launch_full(const void* q, const void* k, const void* v, const float* bias, void* out,
                        float* lse, int B, int N, int C, int H, cudaStream_t stream) {
  // q_s, acc_s, m_s, l_s for kTileQ rows; k_s, v_s for kTileK rows
  const size_t smem = sizeof(float) * ((size_t)kTileQ * (2 * M + 2) + kTileK * (2 * M + 1));
  const dim3 grid((N + kTileQ - 1) / kTileQ, H, B);
  return launch(full_attention_fwd_kernel<T, M>, grid, smem, stream, (const T*)q, (const T*)k,
                (const T*)v, bias, (T*)out, lse, N, C);
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
