// Sliding-chunk attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel vil_tpu/ops/pallas/vil_kernel.py::_pallas_forward_mh
// (Pallas bodies _mh_kernel_img, _mh_kernel_img_loop, _mh_kernel_kv_res,
// _mh_kernel). For every query chunk (i, j) of an mx x my grid of W x W
// chunks and every head h:
//
//   S   = q · [K_glo ‖ K of the 3x3 cyclic chunk neighbourhood]ᵀ + bias + mask
//   out = softmax(S) · [V_glo ‖ V_nbh]              (softmax in f32)
//
// Neighbour n = 0..8 is chunk ((i + dx) mod mx, (j + dy) mod my) with
// (dx, dy) = (n / 3 - 1, n % 3 - 1), the order of masks.NEIGHBOR_OFFSETS.
// Score columns are in front order [glo ‖ nbh 0 ‖ ... ‖ nbh 8], as the
// bias (H, W², Nglo+9W²) and mask (mx, my, Wq, Nglo+9W²) tables have them;
// Wq is 1 (one mask row per chunk) or W² (one per query pixel, SW_EXACT 1).
// q arrives scaled by M^-1/2; the kernel does not scale.
//
// What bounds it on an H100. ViL-Small stage 1 per image: q, k, v and out
// are 4 x 3136 x 96 bf16 = 2.41 MB, and 2 x 2 x 3136 x 442 x 96 = 0.53 GFLOP,
// about 220 FLOP/B: under the bf16 tensor-core ridge (~295 FLOP/B), so with
// tensor cores it would be bound by device memory. This first version does
// its arithmetic in f32 on the CUDA cores (ridge ~20 FLOP/B), so it is bound
// by instruction throughput: f32 FMAs and the shared-memory reads that feed
// them; PERF.md shows shared-memory bandwidth is the limit at stage 1.
//
// What the design does about it. One block per (b, chunk, head) reads each
// K/V chunk once per neighbour, from L2 after the first of its 9 readers, and
// keeps scores in registers: device memory sees only q, k, v and out. An
// online softmax over the 10 column tiles keeps shared memory at
// W²(4M+3) floats whatever the number of columns. Moving QKᵀ and P·V to
// tensor cores (mma.sync or wgmma, several chunks per block to fill 64-row
// tiles) is the next step.
#include "attention_common.cuh"

namespace vil {

template <typename T, int M>
__global__ void __launch_bounds__(kThreads)
vil_attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ k_glo,
                         const T* __restrict__ v_glo, const float* __restrict__ bias,
                         const float* __restrict__ mask, T* __restrict__ out, int mx, int my,
                         int w2, int C, int nglo, int wq) {
  extern __shared__ float smem[];
  const int chunk = blockIdx.x;  // i * my + j
  const int h = blockIdx.y, b = blockIdx.z;
  const int i = chunk / my, j = chunk % my;
  const int cols = nglo + 9 * w2;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, nwarps = blockDim.x / 32;

  float* q_s = smem;                  // w2 x M
  float* k_s = q_s + w2 * M;          // w2 x (M + 1)
  float* v_s = k_s + w2 * (M + 1);    // w2 x M
  float* acc_s = v_s + w2 * M;        // w2 x M
  float* m_s = acc_s + w2 * M;        // w2
  float* l_s = m_s + w2;              // w2

  // head h of chunk (ci, cj): w2 rows of M elements, C apart
  auto chunk_ptr = [&](auto* base, int ci, int cj) {
    return base + (((long)b * mx + ci) * my + cj) * w2 * C + h * M;
  };
  load_rows<M>(q_s, M, chunk_ptr(q, i, j), C, w2);
  for (int idx = threadIdx.x; idx < w2 * M; idx += blockDim.x) acc_s[idx] = 0.f;
  for (int idx = threadIdx.x; idx < w2; idx += blockDim.x) {
    m_s[idx] = -INFINITY;
    l_s[idx] = 0.f;
  }

  const float* bias_h = bias != nullptr ? bias + (long)h * w2 * cols : nullptr;
  const float* mask_c = mask + (long)chunk * wq * cols;
  // column tiles: the global keys, w2 at a time, then the 9 neighbour chunks
  const int n_glo_tiles = (nglo + w2 - 1) / w2;
  for (int tile = 0; tile < n_glo_tiles + 9; ++tile) {
    int col0, nkeys;
    const T *ksrc, *vsrc;
    if (tile < n_glo_tiles) {
      col0 = tile * w2;
      nkeys = min(w2, nglo - col0);
      ksrc = k_glo + ((long)b * nglo + col0) * C + h * M;
      vsrc = v_glo + ((long)b * nglo + col0) * C + h * M;
    } else {
      const int n = tile - n_glo_tiles;
      const int ci = (i + n / 3 - 1 + mx) % mx, cj = (j + n % 3 - 1 + my) % my;
      col0 = nglo + n * w2;
      nkeys = w2;
      ksrc = chunk_ptr(k, ci, cj);
      vsrc = chunk_ptr(v, ci, cj);
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
}

template <typename T, int M>
cudaError_t launch_vil(const void* q, const void* k, const void* v, const void* k_glo,
                       const void* v_glo, const float* bias, const float* mask, void* out, int B,
                       int mx, int my, int w2, int C, int H, int nglo, int wq,
                       cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)w2 * (4 * M + 3);
  return launch(vil_attention_fwd_kernel<T, M>, dim3(mx * my, H, B), smem, stream,
                (const T*)q, (const T*)k, (const T*)v, (const T*)k_glo, (const T*)v_glo, bias,
                mask, (T*)out, mx, my, w2, C, nglo, wq);
}

template <typename T>
cudaError_t dispatch_vil(const void* q, const void* k, const void* v, const void* k_glo,
                         const void* v_glo, const float* bias, const float* mask, void* out,
                         int B, int mx, int my, int w2, int C, int H, int nglo, int wq,
                         cudaStream_t stream) {
  switch (C / H) {
#define VIL_CASE(M)                                                                      \
  case M:                                                                                \
    return launch_vil<T, M>(q, k, v, k_glo, v_glo, bias, mask, out, B, mx, my, w2, C, H, \
                            nglo, wq, stream);
    VIL_CASE(8)
    VIL_CASE(16)
    VIL_CASE(32)
    VIL_CASE(64)
    VIL_CASE(128)
#undef VIL_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace vil

// q, k, v, out (B, mx, my, w2, C); k_glo, v_glo (B, nglo, C) or null when
// nglo is 0; bias (H, w2, nglo + 9 w2) f32 or null; mask
// (mx, my, wq, nglo + 9 w2) f32. All contiguous. Returns the launch's error.
extern "C" int vil_attention_fwd(const void* q, const void* k, const void* v, const void* k_glo,
                                 const void* v_glo, const void* bias, const void* mask,
                                 void* out, int B, int mx, int my, int w2, int C, int H,
                                 int nglo, int wq, int is_bf16, void* stream) {
  auto* s = static_cast<cudaStream_t>(stream);
  auto* bias_f = static_cast<const float*>(bias);
  auto* mask_f = static_cast<const float*>(mask);
  if (is_bf16)
    return vil::dispatch_vil<__nv_bfloat16>(q, k, v, k_glo, v_glo, bias_f, mask_f, out, B, mx,
                                            my, w2, C, H, nglo, wq, s);
  return vil::dispatch_vil<float>(q, k, v, k_glo, v_glo, bias_f, mask_f, out, B, mx, my, w2, C,
                                  H, nglo, wq, s);
}

extern "C" const char* vil_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
