// Tensor-core building blocks for Hopper (sm_90a): warpgroup matrix multiply
// (wgmma) on bf16 operands with f32 accumulators, and asynchronous copies
// (cp.async) of bf16 tiles into shared memory. Used by the bf16 dense
// attention kernels (full_attention_fwd.cu, full_attention_bwd.cu), the
// bf16 sliding-chunk forward and backward (sliding_chunk_tc.cuh) and the
// bf16 matrix products of the fused block (gemm_tc.cuh), and the 16-byte
// copies of the LayerNorm backward's rows (layer_norm.cu).
//
// Shared-memory layout. A tile is 64 rows of DP bf16 values, DP the head dim
// M rounded up to 16 (wgmma's k-depth; the pad is zero). It is stored in 8 x 8
// core matrices without swizzle: the 16 bytes of row r, values 8c .. 8c+7, lie
// at byte ((r / 8) * (DP / 8) + c) * 128 + (r % 8) * 16. One layout serves both
// ways wgmma reads a tile:
//   K-major (the rows are wgmma's M or N, the values its k):  LBO 128, SBO 16 DP
//   MN-major (the rows are wgmma's k, the values its M or N): LBO 16 DP, SBO 128
// (LBO: the byte step between core matrices along k; SBO: along M or N. This
// is CUTLASS's canonical INTERLEAVE layout in both majors.) A k-step of 16
// advances a K-major descriptor by 256 bytes and an MN-major one by 32 DP.
// The 128 contiguous bytes of a core matrix make wgmma's reads conflict-free,
// and 8 neighbouring threads of a copy fill one core matrix.
//
// Accumulator layout of m64nNk16 (f32): thread t of the warpgroup, warp
// w = t / 32, lane l, holds d[4j + 2i + c] = D[16w + l/4 + 8i][8j + 2(l%4) + c]
// for i, c in {0, 1} and j < N / 8. A row lives in the 4 threads of a quad.
// The register A operand (64 x 16) has the same row layout, so an f32
// accumulator over 64 columns is the A operand of the next product after a
// conversion to bf16 in place (a_frag).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace vil {

constexpr int kTcThreads = 128;  // one warpgroup
constexpr int kTcRows = 64;      // rows of a tile: wgmma's M
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte asynchronous copy global -> shared; bytes past src_bytes (0 or 16)
// are zero-filled.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}

// 4-byte asynchronous copy, zero-filled when src_bytes is 0.
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most `Pending` committed groups of this thread are in flight,
// then make the copies visible to wgmma's (async-proxy) reads. A barrier must
// follow before another thread's copies are read.
template <int Pending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(Pending) : "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Stage a 64-row tile whose row r is row_ptr(r) (M bf16 values, 16-byte
// aligned), or zeros where row_ptr(r) is null; values >= M are zeros. `any` is
// a valid device address, named by the zero-filling copies, which read none
// of it.
template <int M, typename RowPtr>
__device__ __forceinline__ void stage_rows(__nv_bfloat16* dst, const __nv_bfloat16* any,
                                           RowPtr row_ptr) {
  constexpr int DP = M < 16 ? 16 : M, CH = DP / 8;
  const uint32_t base = smem_u32(dst);
#pragma unroll
  for (int i = threadIdx.x; i < kTcRows * CH; i += kTcThreads) {
    const int r8 = i % 8, c = (i / 8) % CH, grp = i / (8 * CH);
    const __nv_bfloat16* src = row_ptr(grp * 8 + r8);
    const bool ok = src != nullptr && c * 8 < M;
    cp_async16(base + (grp * CH + c) * 128 + r8 * 16, ok ? src + c * 8 : any, ok ? 16 : 0);
  }
}

// Stage rows [0, rows) of a 64-row tile: row r of the tile is src + r * stride;
// rows >= rows are zeros.
template <int M>
__device__ __forceinline__ void stage_tile(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                           long stride, int rows) {
  stage_rows<M>(dst, src, [=](int r) { return r < rows ? src + r * stride : nullptr; });
}

// Stage 64 f32 values src[0 .. rows) (zeros past rows), one per thread of
// threads [first, first + 64).
__device__ __forceinline__ void stage_row_values(float* dst, const float* src, int rows,
                                                 int first) {
  const int i = threadIdx.x - first;
  if (i >= 0 && i < kTcRows) cp_async4(smem_u32(dst + i), i < rows ? src + i : src, i < rows ? 4 : 0);
}

// Matrix descriptor of a tile (layout above) without swizzle.
__device__ __forceinline__ uint64_t tile_desc(const void* tile, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((smem_u32(tile) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32);
}

template <int DP>
__device__ __forceinline__ uint64_t k_major(const void* tile) {
  return tile_desc(tile, 128, 16 * DP);
}

template <int DP>
__device__ __forceinline__ uint64_t mn_major(const void* tile) {
  return tile_desc(tile, 16 * DP, 128);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keep the compiler from moving reads or writes of an accumulator across a
// wgmma or its wait: the asm statements are ordered, the registers' other
// uses are tied to them here.
template <int K>
__device__ __forceinline__ void fence_operand(float (&d)[K]) {
#pragma unroll
  for (int i = 0; i < K; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Store a 64 x M accumulator as bf16 rows r0 .. min(r0 + 64, N) - 1 of a
// matrix whose row n starts at dst + n * stride.
template <int M>
__device__ __forceinline__ void store_acc_rows(__nv_bfloat16* dst, long stride,
                                               const float (&d)[M / 2], int r0, int N) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + 16 * warp + lane / 4 + 8 * i;
    if (row >= N) continue;
    __nv_bfloat16* p = dst + row * stride + 2 * (lane % 4);
#pragma unroll
    for (int j = 0; j < M / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(p + 8 * j) =
          __floats2bfloat162_rn(d[4 * j + 2 * i], d[4 * j + 2 * i + 1]);
  }
}

// The register A operand of k-step kk (columns 16kk .. 16kk+15) of a 64 x 64
// f32 accumulator, rounded to bf16.
__device__ __forceinline__ void a_frag(uint32_t (&a)[4], const float (&d)[32], int kk) {
#pragma unroll
  for (int r = 0; r < 4; ++r) a[r] = pack_bf16(d[8 * kk + 2 * r], d[8 * kk + 2 * r + 1]);
}

// D (+)= A·B, m64n64k16: A (64 x 16) and B (64 x 16) from shared memory, both
// K-major; scale_d 0 overwrites D, 1 accumulates.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t desc_a, uint64_t desc_b,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// D (+)= A·B, m64n64k16, both operands from shared memory, each K-major
// (Trans 0) or MN-major (Trans 1: the tile's rows are wgmma's k, its values
// M or N; imm-trans-a / imm-trans-b). The products of gemm_tc.cuh.
template <int TransA, int TransB>
__device__ __forceinline__ void wgmma_ss_n64_t(float (&d)[32], uint64_t desc_a, uint64_t desc_b,
                                               int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(TransA), "n"(TransB));
}

// D (+)= A·B, m64nNk16: A (64 x 16 bf16) from registers in the accumulator's
// row layout, B (16 x N) from shared memory, MN-major (imm-trans-b 1).
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4],
                                         uint64_t desc_b, int scale_d);

template <>
__device__ __forceinline__ void wgmma_rs<8>(float (&d)[4], const uint32_t (&a)[4],
                                              uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, %8, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<16>(float (&d)[8], const uint32_t (&a)[4],
                                              uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<32>(float (&d)[16], const uint32_t (&a)[4],
                                              uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32], const uint32_t (&a)[4],
                                              uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64], const uint32_t (&a)[4],
                                              uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

}  // namespace vil
