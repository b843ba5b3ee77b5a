// bitlinear: y[M, N] = (q8(x) @ wq) * ((gamma/127) * delta)
//
// Replaces the TPU kernel repro/kernels/bitlinear/kernel.py::bitlinear_kernel,
// the QAT forward of every student projection.  wq is the ternary weight
// (codes in {-1, 0, 1}, per-tensor scale delta); gamma [M] is the per-row
// absmax of x.  q8 = clip(rint(x * (127/(gamma+1e-5))), -128, 127) with the
// IEEE quotient and the op order of the TPU kernel (kernel.py:41); the
// products accumulate exactly in int32 and are scaled once in the epilogue
// (kernel.py:51-53), so the result equals the plain PyTorch version bit for
// bit.
//
// Bound on the H100: at the training shapes (M = 2048..4096 tokens, K, N in
// 1024..6448) the int8 operations (2*M*K*N at 1979 TOP/s) take longer than
// the bytes (x, wq and y once at 3.35 TB/s), so the product belongs on the
// int8 tensor cores, and on Hopper only wgmma reaches their full rate.
// wgmma takes 8-bit operands from shared memory in K-major layout only, so
// one call is three kernels:
//
//   1. bitlinear_kernel_quant_rows: one CTA per row reads x once in 16-byte
//      loads, takes gamma (when the caller has none) and writes the int8
//      codes into an [M, Kp] buffer, Kp = K rounded up to the GEMM's K tile,
//      the pad zero codes (they add nothing to an int32 sum, and every row
//      pitch meets TMA's 16-byte rule).  The codes are what the backward
//      needs, so the caller keeps them.
//   2. bitlinear_kernel_weight_kmajor: the weight as K-major int8 [N, Kp]
//      (zero pad), through a shared-memory transpose, four codes a word; from
//      the int8 codes, or from the fp32 master weight and delta, ternarized
//      on the way (round_clip(w / (delta + 1e-5), -1, 1), IEEE quotient),
//      writing the [K, N] codes beside it for the backward.
//   3. bitlinear_kernel_gemm: 128 x 128 output tiles; one producer warp keeps
//      a 3-stage ring of TMA loads in flight (A [128, 128] and B [128, 128]
//      int8 tiles, 128-byte swizzle: one swizzle row is one 128-byte K row),
//      mbarriers hand the stages over, and two consumer warpgroups each issue
//      wgmma m64n128k32 s32.s8.s8 on their 64 rows, int32 accumulators in
//      registers, one stage's MMAs in flight while the next stage's issue.
//      97 KB of shared memory a CTA, so two CTAs share an SM and one's
//      prologue and epilogue overlap the other's main loop.  The epilogue
//      scales by (gamma[m]/127)*delta, stages each warp's 16 rows in the
//      drained ring and writes them in 16-byte pieces, masking the ragged M
//      and N edges (TMA reads zeros beyond them).
#include "common.cuh"

#include <cuda.h>

namespace {

constexpr int BM = 128, BN = 128, BK = 128, STAGES = 3;
constexpr int CONSUMERS = 2;                       // warpgroups of 64 rows
constexpr int THREADS = 128 * CONSUMERS + 32;      // + one producer warp
constexpr int TILE_A = BM * BK, TILE_B = BN * BK;  // bytes per stage
constexpr int LDO = BN + 8;                        // staged output row, elements
constexpr int QUANT_THREADS = 128;
constexpr int WT_TILE = 64;                        // weight transpose tile

// the epilogue stages its output in the drained ring
static_assert(CONSUMERS * 4 * 16 * LDO * 4 <= STAGES * (TILE_A + TILE_B), "");

// dynamic shared memory of a GEMM CTA: the ring, its barriers and the slack
// that aligns the ring to 1024 bytes; two CTAs fit on an SM
constexpr int GEMM_SMEM = 1024 + STAGES * (TILE_A + TILE_B) + 2 * STAGES * 8;

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

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(smem_u32(bar))
      : "memory");
}

// Shared-memory matrix descriptor of a K-major tile written by TMA with the
// 128-byte swizzle: rows of 128 bytes, 8-row groups 1024 bytes apart (SBO),
// leading offset unused, tile base 1024-aligned.  Stepping K by 32 bytes
// inside the swizzle row advances the start address by 32 bytes.
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

// -- 1. the quantizing pass -----------------------------------------------------

// max that keeps a NaN, as torch.amax does
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a > b || a != a) ? a : b;
}

__device__ __forceinline__ uint32_t q8(float v, float inv) {
  float q = rintf(v * inv);
  q = fminf(fmaxf(q, -128.0f), 127.0f);
  return (uint32_t)((int)q & 0xff);
}

// 16 bytes of x as floats
__device__ __forceinline__ void load16(const float* p, float (&v)[4]) {
  const float4 u = *reinterpret_cast<const float4*>(p);
  v[0] = u.x; v[1] = u.y; v[2] = u.z; v[3] = u.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

// gamma_out != nullptr: take the row absmax into it; else read gamma_in.
// vec: every row is a whole number of 16-byte pieces, x 16-byte aligned.
template <typename T>
__global__ void __launch_bounds__(QUANT_THREADS)
bitlinear_kernel_quant_rows(const T* __restrict__ x,
                            const float* __restrict__ gamma_in,
                            float* __restrict__ gamma_out,
                            int8_t* __restrict__ codes, int K, int Kp, int vec) {
  constexpr int V = 16 / sizeof(T);
  __shared__ float red[QUANT_THREADS / 32];
  const int m = blockIdx.x, tid = threadIdx.x;
  const T* xr = x + (size_t)m * K;
  int8_t* cr = codes + (size_t)m * Kp;
  const int nv = vec ? K / V : 0;

  float g;
  if (gamma_out != nullptr) {
    float a = 0.0f;
    for (int c = tid; c < nv; c += QUANT_THREADS) {
      float v[V];
      load16(xr + c * V, v);
#pragma unroll
      for (int e = 0; e < V; ++e) a = nan_max(a, fabsf(v[e]));
    }
    for (int k = nv * V + tid; k < K; k += QUANT_THREADS)
      a = nan_max(a, fabsf(to_f32(xr[k])));
    for (int off = 16; off > 0; off >>= 1)
      a = nan_max(a, __shfl_xor_sync(0xffffffffu, a, off));
    if ((tid & 31) == 0) red[tid >> 5] = a;
    __syncthreads();
    g = red[0];
#pragma unroll
    for (int w = 1; w < QUANT_THREADS / 32; ++w) g = nan_max(g, red[w]);
    if (tid == 0) gamma_out[m] = g;
  } else {
    g = gamma_in[m];
  }
  const float inv = 127.0f / (g + 1e-5f);

  for (int c = tid; c < nv; c += QUANT_THREADS) {
    float v[V];
    load16(xr + c * V, v);
    uint32_t w[V / 4];
#pragma unroll
    for (int j = 0; j < V / 4; ++j)
      w[j] = q8(v[4 * j], inv) | q8(v[4 * j + 1], inv) << 8 |
             q8(v[4 * j + 2], inv) << 16 | q8(v[4 * j + 3], inv) << 24;
    if constexpr (V == 8)
      *reinterpret_cast<uint2*>(cr + c * V) = make_uint2(w[0], w[1]);
    else
      *reinterpret_cast<uint32_t*>(cr + c * V) = w[0];
  }
  for (int k = nv * V + tid; k < K; k += QUANT_THREADS)
    cr[k] = (int8_t)q8(to_f32(xr[k]), inv);
  for (int k = K + tid; k < Kp; k += QUANT_THREADS) cr[k] = 0;
}

// -- 2. the K-major weight --------------------------------------------------------

__device__ __forceinline__ uint32_t ternary(float w, float dpe) {
  const float q = fminf(fmaxf(rintf(w / dpe), -1.0f), 1.0f);
  return (uint32_t)((int)q & 0xff);
}

// Four consecutive n of row k of src as four int8 codes in one word: the
// int8 codes as they are, or the fp32 master weight ternarized with dpe =
// delta + 1e-5.  vec: N % 4 == 0 and src 16-byte aligned.
__device__ __forceinline__ uint32_t src_codes(const int8_t* src, size_t at, int n,
                                              int N, bool vec, float) {
  if (vec && n + 3 < N) return *reinterpret_cast<const uint32_t*>(src + at);
  uint32_t v = 0;
  for (int e = 0; e < 4 && n + e < N; ++e) v |= (uint32_t)(uint8_t)src[at + e] << (8 * e);
  return v;
}
__device__ __forceinline__ uint32_t src_codes(const float* src, size_t at, int n,
                                              int N, bool vec, float dpe) {
  if (vec && n + 3 < N) {
    const float4 f = *reinterpret_cast<const float4*>(src + at);
    return ternary(f.x, dpe) | ternary(f.y, dpe) << 8 | ternary(f.z, dpe) << 16 |
           ternary(f.w, dpe) << 24;
  }
  uint32_t v = 0;
  for (int e = 0; e < 4 && n + e < N; ++e) v |= ternary(src[at + e], dpe) << (8 * e);
  return v;
}

// src [K, N] (int8 codes, or the fp32 master weight with delta) -> wt [N, Kp]
// through a 64 x 64 shared-memory tile, four codes a word on both sides;
// grid (ceil(N / 64), Kp / 64).  With fp32 the codes also go to wq [K, N].
template <typename S>
__global__ void __launch_bounds__(256)
bitlinear_kernel_weight_kmajor(const S* __restrict__ src,
                               const float* __restrict__ delta,
                               int8_t* __restrict__ wq, int8_t* __restrict__ wt,
                               int K, int N, int Kp, int vec) {
  __shared__ uint32_t tile[WT_TILE][WT_TILE / 4 + 1];   // [k][n / 4]
  const int k0 = blockIdx.y * WT_TILE, n0 = blockIdx.x * WT_TILE;
  const float dpe = sizeof(S) == 4 ? delta[0] + 1e-5f : 0.0f;
  const bool wvec = vec && (reinterpret_cast<uintptr_t>(wq) & 3) == 0;
  for (int i = threadIdx.x; i < WT_TILE * WT_TILE / 4; i += 256) {
    const int r = i / (WT_TILE / 4), c = i % (WT_TILE / 4);
    const int k = k0 + r, n = n0 + 4 * c;
    uint32_t v = 0;
    if (k < K && n < N) {
      const size_t at = (size_t)k * N + n;
      v = src_codes(src, at, n, N, vec, dpe);
      if constexpr (sizeof(S) == 4) {
        if (wvec && n + 3 < N)
          *reinterpret_cast<uint32_t*>(wq + at) = v;
        else
          for (int e = 0; e < 4 && n + e < N; ++e) wq[at + e] = (int8_t)(v >> (8 * e));
      }
    }
    tile[r][c] = v;
  }
  __syncthreads();
  // word j of wt row n holds k = k0 + 4j .. 4j+3, byte (n % 4) of tile words
  for (int i = threadIdx.x; i < WT_TILE * WT_TILE / 4; i += 256) {
    const int r = i / (WT_TILE / 4), j = i % (WT_TILE / 4);   // r: n, j: k / 4
    const int n = n0 + r;
    if (n >= N) continue;
    const int sh = 8 * (r & 3);
    uint32_t v = 0;
#pragma unroll
    for (int e = 0; e < 4; ++e) v |= ((tile[4 * j + e][r >> 2] >> sh) & 0xffu) << (8 * e);
    *reinterpret_cast<uint32_t*>(wt + (size_t)n * Kp + k0 + 4 * j) = v;
  }
}

// -- 3. the GEMM on the int8 tensor cores ---------------------------------------

template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
bitlinear_kernel_gemm(const __grid_constant__ CUtensorMap tma_a,
                      const __grid_constant__ CUtensorMap tma_b,
                      const float* __restrict__ gamma,
                      const float* __restrict__ delta, T* __restrict__ y,
                      int M, int N, int Kp) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  uint8_t* sA = smem;
  uint8_t* sB = sA + STAGES * TILE_A;
  uint64_t* full = reinterpret_cast<uint64_t*>(sB + STAGES * TILE_B);
  uint64_t* empty = full + STAGES;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int nk = Kp / BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS * 4);   // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == CONSUMERS * 4) {
    // producer: one thread keeps up to STAGES tile pairs in flight
    if (lane == 0) {
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % STAGES, ph = (kt / STAGES) & 1;
        mbar_wait(&empty[s], ph ^ 1);
        mbar_expect_tx(&full[s], TILE_A + TILE_B);
        tma_load_2d(sA + s * TILE_A, &tma_a, kt * BK, m0, &full[s]);
        tma_load_2d(sB + s * TILE_B, &tma_b, kt * BK, n0, &full[s]);
      }
    }
    return;
  }

  // consumers: warpgroup wg owns rows wg*64 .. wg*64+63 of the tile; one
  // stage's MMAs stay in flight while the next stage's are issued, and a
  // stage goes back to the producer once its MMAs have completed
  const int wg = warp >> 2;
  int acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0;
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % STAGES, ph = (kt / STAGES) & 1;
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

  // epilogue: scale, stage the warp's 16 x 128 outputs in the drained ring
  // (every load has landed and every MMA has read its stage once both
  // warpgroups pass the barrier), then store 16 bytes a lane
  asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS * 128) : "memory");
  const int wr = (warp & 3) * 16;                 // warp's first row in the WG
  const int r0 = m0 + wg * 64 + wr + (lane >> 2); // and rows r0 + 8
  const float d = delta[0];
  const float sc0 = r0 < M ? (gamma[r0] / 127.0f) * d : 0.0f;
  const float sc1 = r0 + 8 < M ? (gamma[r0 + 8] / 127.0f) * d : 0.0f;
  T* so = reinterpret_cast<T*>(smem) + warp * 16 * LDO;
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

// [rows, Kp] int8, row pitch Kp bytes, read in [box_rows, BK] boxes
bool kmajor_map(CUtensorMap* map, const void* base, int rows, int Kp,
                int box_rows) {
  EncodeTiled enc = encoder();
  if (enc == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)Kp, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)Kp};
  const cuuint32_t box[2] = {(cuuint32_t)BK, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(base), dims,
             strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

int quant(const void* x, const void* gamma_in, void* gamma_out, void* codes, int M,
          int K, int Kp, int dtype, cudaStream_t s) {
  if (Kp % BK != 0 || Kp < K || M <= 0 || K <= 0) return (int)cudaErrorInvalidValue;
  if (dtype == DT_F32) {
    const int vec = (K % 4 == 0) && aligned16(x);
    bitlinear_kernel_quant_rows<float><<<M, QUANT_THREADS, 0, s>>>(
        (const float*)x, (const float*)gamma_in, (float*)gamma_out,
        (int8_t*)codes, K, Kp, vec);
  } else if (dtype == DT_BF16) {
    const int vec = (K % 8 == 0) && aligned16(x);
    bitlinear_kernel_quant_rows<__nv_bfloat16><<<M, QUANT_THREADS, 0, s>>>(
        (const __nv_bfloat16*)x, (const float*)gamma_in, (float*)gamma_out,
        (int8_t*)codes, K, Kp, vec);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

int weight(const void* src, const void* delta, void* wq, void* wt, int K, int N,
           int Kp, int src_is_f32, cudaStream_t s) {
  if (Kp % BK != 0 || Kp < K || N <= 0 || K <= 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((N + WT_TILE - 1) / WT_TILE, Kp / WT_TILE);
  const int vec = (N % 4 == 0) && aligned16(src);
  if (src_is_f32)
    bitlinear_kernel_weight_kmajor<float><<<grid, 256, 0, s>>>(
        (const float*)src, (const float*)delta, (int8_t*)wq, (int8_t*)wt, K, N,
        Kp, vec);
  else
    bitlinear_kernel_weight_kmajor<int8_t><<<grid, 256, 0, s>>>(
        (const int8_t*)src, nullptr, nullptr, (int8_t*)wt, K, N, Kp, vec);
  return (int)cudaGetLastError();
}

template <typename T>
int gemm_t(const void* codes, const void* wt, const void* gamma, const void* delta,
           void* y, int M, int N, int Kp, cudaStream_t stream) {
  static size_t allowed = 0;
  CUtensorMap ma, mb;
  if (!kmajor_map(&ma, codes, M, Kp, BM) || !kmajor_map(&mb, wt, N, Kp, BN))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = allow_smem(bitlinear_kernel_gemm<T>, GEMM_SMEM, &allowed);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  bitlinear_kernel_gemm<T><<<grid, THREADS, GEMM_SMEM, stream>>>(
      ma, mb, (const float*)gamma, (const float*)delta, (T*)y, M, N, Kp);
  return (int)cudaGetLastError();
}

int gemm(const void* codes, const void* wt, const void* gamma, const void* delta,
         void* y, int M, int N, int Kp, int dtype, cudaStream_t s) {
  if (Kp % BK != 0 || Kp <= 0 || M <= 0 || N <= 0 || !aligned16(codes) ||
      !aligned16(wt))
    return (int)cudaErrorInvalidValue;
  if (dtype == DT_F32) return gemm_t<float>(codes, wt, gamma, delta, y, M, N, Kp, s);
  if (dtype == DT_BF16)
    return gemm_t<__nv_bfloat16>(codes, wt, gamma, delta, y, M, N, Kp, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// The GEMM's K tile (Kp must be a multiple), tile sizes, ring depth,
// threads and dynamic shared memory per CTA: out[0..5].
extern "C" void bitlinear_gemm_info(long long* out) {
  out[0] = BK;
  out[1] = BM;
  out[2] = BN;
  out[3] = STAGES;
  out[4] = THREADS;
  out[5] = GEMM_SMEM;
}

// x [M, K] -> codes [M, Kp] int8 (pad zeros); gamma_out [M] is written when
// not null, gamma_in [M] read otherwise.
extern "C" int bitlinear_quant_launch(const void* x, const void* gamma_in,
                                      void* gamma_out, void* codes, int M, int K,
                                      int Kp, int dtype, void* stream) {
  return quant(x, gamma_in, gamma_out, codes, M, K, Kp, dtype, (cudaStream_t)stream);
}

// src [K, N]: int8 codes (delta, wq unused) or, with src_is_f32, the fp32
// master weight ternarized with delta (codes also to wq [K, N]) -> wt [N, Kp].
extern "C" int bitlinear_weight_launch(const void* src, const void* delta,
                                       void* wq, void* wt, int K, int N, int Kp,
                                       int src_is_f32, void* stream) {
  return weight(src, delta, wq, wt, K, N, Kp, src_is_f32, (cudaStream_t)stream);
}

// codes [M, Kp], wt [N, Kp] int8 (16-byte aligned) -> y [M, N]
extern "C" int bitlinear_gemm_launch(const void* codes, const void* wt,
                                     const void* gamma, const void* delta,
                                     void* y, int M, int N, int Kp, int dtype,
                                     void* stream) {
  return gemm(codes, wt, gamma, delta, y, M, N, Kp, dtype, (cudaStream_t)stream);
}

// The whole call: the three launches above in one entry, so a call crosses
// from the host once.  x [M, K] and the weight src [K, N] -> codes, wt (and
// wq, gamma_out as above) and y [M, N].
extern "C" int bitlinear_launch(const void* x, const void* gamma_in, void* gamma_out,
                                void* codes, const void* src, const void* delta,
                                void* wq, void* wt, void* y, int M, int K, int N,
                                int Kp, int dtype, int src_is_f32, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  int err = quant(x, gamma_in, gamma_out, codes, M, K, Kp, dtype, s);
  if (err == 0) err = weight(src, delta, wq, wt, K, N, Kp, src_is_f32, s);
  if (err == 0)
    err = gemm(codes, wt, gamma_out ? gamma_out : gamma_in, delta, y, M, N, Kp,
               dtype, s);
  return err;
}
