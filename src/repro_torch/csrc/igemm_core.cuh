// The int8 tensor-core GEMM core shared by bitlinear.cu and w2a8_gemv.cu:
// PTX wrappers for mbarriers, TMA and wgmma s32.s8.s8, the consumer
// warpgroups' main loop over a ring of K-major tiles, and the epilogue
// that scales by (gamma[m]/127)*delta and stores y.
//
// Tile convention (both kernels): K tiles of BK = 128 bytes; an A stage
// holds [rows, 128] int8 codes and a B stage [BN = 128, 128] K-major int8
// weights, both in the 128-byte swizzle that TMA's SWIZZLE_128B writes: one
// 128-byte K row per swizzle row, the 16-byte chunk c of row r stored at
// chunk c ^ (r & 7), 8-row groups 1024 bytes apart, every tile 1024-aligned.
// A producer fills a stage and signals `full`; each consumer warpgroup issues
// wgmma m64n128k32 on its 64 rows, keeps one stage's MMAs in flight while it
// issues the next stage's, and gives a stage back on `empty` once its MMAs
// have completed.
#pragma once

#include "common.cuh"

#include <cuda.h>

namespace {

namespace igemm {

constexpr int BK = 128, BN = 128;
constexpr int LDO = BN + 8;   // staged output row of the epilogue, elements

// -- PTX wrappers -------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
  }
}

__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// order this thread's generic-proxy shared-memory writes before later
// async-proxy reads of them (wgmma reads its operands through the async
// proxy)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(smem_u32(bar))
      : "memory");
}

// Shared-memory matrix descriptor of a K-major tile in the 128-byte
// swizzle: rows of 128 bytes, 8-row groups 1024 bytes apart (SBO), leading
// offset unused, tile base 1024-aligned.  Stepping K by 32 bytes inside the
// swizzle row advances the start address by 32 bytes.
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  const uint32_t a = smem_u32(p);
  return (uint64_t)((a & 0x3FFFF) >> 4) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keep the compiler from moving accumulator accesses across the async MMAs
__device__ __forceinline__ void fence_regs(int (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// D[64 x 128] += A[64 x 32] * B[128 x 32]^T, both K-major in shared memory
__device__ __forceinline__ void wgmma_m64n128k32_s8(int (&d)[64], uint64_t da,
                                                    uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]),
        "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]),
        "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]),
        "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]),
        "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]),
        "+r"(d[47]), "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
        "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]), "+r"(d[56]),
        "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]),
        "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// -- the consumers --------------------------------------------------------------

// Consumer warpgroup wg's main loop over nk K tiles: its 64 rows of each A
// stage (rows of TILE_A / BK bytes) against the B stage, into acc.  A stage
// is ready once `full` has completed its phase and, when `loaded` is not
// null, `loaded` too (a producer that writes B itself signals `full`, TMA's
// A tile lands on `loaded`).
template <int STAGES, int TILE_A, int TILE_B>
__device__ __forceinline__ void mainloop(int (&acc)[64], const uint8_t* sA,
                                         const uint8_t* sB, uint64_t* full,
                                         uint64_t* loaded, uint64_t* empty,
                                         int nk, int wg, int lane) {
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0;
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % STAGES, ph = (kt / STAGES) & 1;
    if (loaded != nullptr) mbar_wait(&loaded[s], ph);
    mbar_wait(&full[s], ph);
    const uint8_t* a = sA + s * TILE_A + wg * 64 * BK;
    const uint8_t* b = sB + s * TILE_B;
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < BK / 32; ++k)
      wgmma_m64n128k32_s8(acc, sw128_desc(a + 32 * k), sw128_desc(b + 32 * k));
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(acc);
    if (kt > 0 && lane == 0) mbar_arrive(&empty[(kt - 1) % STAGES]);
  }
  wgmma_wait<0>();
  fence_regs(acc);
}

// Epilogue of the CONSUMERS warpgroups of a CTA whose tile starts at (m0,
// n0): scale (SCALE false: none, the accumulators as they are, exact;
// gamma and delta are not read), stage each warp's 16 x 128 outputs in the
// drained ring at `stage` (every load has landed and every MMA has read its
// stage once all consumers pass the barrier), then store 16 bytes a lane,
// masking the ragged M and N edges.
template <typename T, int CONSUMERS, bool SCALE = true>
__device__ __forceinline__ void epilogue(int (&acc)[64], uint8_t* stage,
                                         const float* __restrict__ gamma,
                                         const float* __restrict__ delta,
                                         T* __restrict__ y, int M, int N, int m0,
                                         int n0, int warp, int lane) {
  asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS * 128) : "memory");
  const int wg = warp >> 2;
  const int wr = (warp & 3) * 16;                 // warp's first row in the WG
  const int r0 = m0 + wg * 64 + wr + (lane >> 2); // and rows r0 + 8
  float sc0 = r0 < M ? 1.0f : 0.0f, sc1 = r0 + 8 < M ? 1.0f : 0.0f;
  if constexpr (SCALE) {
    const float d = delta[0];
    sc0 = r0 < M ? (gamma[r0] / 127.0f) * d : 0.0f;
    sc1 = r0 + 8 < M ? (gamma[r0 + 8] / 127.0f) * d : 0.0f;
  }
  T* so = reinterpret_cast<T*>(stage) + warp * 16 * LDO;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int c = j * 8 + 2 * (lane & 3);
    T* p0 = so + (lane >> 2) * LDO + c;
    T* p1 = p0 + 8 * LDO;
    p0[0] = from_f32<T>((float)acc[4 * j] * sc0);
    p0[1] = from_f32<T>((float)acc[4 * j + 1] * sc0);
    p1[0] = from_f32<T>((float)acc[4 * j + 2] * sc1);
    p1[1] = from_f32<T>((float)acc[4 * j + 3] * sc1);
  }
  __syncwarp();
  constexpr int V = 16 / sizeof(T), PER_ROW = BN / V;
  const bool vec_ok = (N % V) == 0;
  const int rbase = m0 + wg * 64 + wr;
#pragma unroll 4
  for (int i = lane; i < 16 * PER_ROW; i += 32) {
    const int r = i / PER_ROW, c = (i % PER_ROW) * V;
    const int m = rbase + r, n = n0 + c;
    if (m >= M || n >= N) continue;
    const T* src = so + r * LDO + c;
    T* dst = y + (size_t)m * N + n;
    if (vec_ok && n + V <= N) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
      for (int e = 0; e < V && n + e < N; ++e) dst[e] = src[e];
    }
  }
}

// bytes the epilogue stages: CONSUMERS warpgroups of 4 warps, 16 rows each
template <int CONSUMERS>
constexpr int staged_bytes() { return CONSUMERS * 4 * 16 * LDO * 4; }

// -- host side ------------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled is a driver API function; the runtime hands out
// its entry point, so the library needs no link against libcuda.
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                     cudaEnableDefault, &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// uint8 [rows, cols] with row pitch `cols` bytes, read in [box_rows, 128]
// boxes in the 128-byte swizzle; reads beyond the edges fill zeros
bool swizzled_map(CUtensorMap* map, const void* base, int rows, int cols,
                  int box_rows) {
  EncodeTiled enc = encoder();
  if (enc == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols};
  const cuuint32_t box[2] = {128u, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(base), dims,
             strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace igemm

}  // namespace
