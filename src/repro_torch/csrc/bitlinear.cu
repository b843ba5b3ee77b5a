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
//
// The PTX wrappers, the consumers' main loop and the epilogue live in
// igemm_core.cuh, shared with w2a8_gemv.cu's tensor-core route; the
// quantizing pass is that route's first kernel too (bitlinear_quant_launch).
#include "igemm_core.cuh"

namespace {

using namespace igemm;

constexpr int BM = 128, STAGES = 3;
constexpr int CONSUMERS = 2;                       // warpgroups of 64 rows
constexpr int THREADS = 128 * CONSUMERS + 32;      // + one producer warp
constexpr int TILE_A = BM * BK, TILE_B = BN * BK;  // bytes per stage
constexpr int QUANT_THREADS = 128;
constexpr int WT_TILE = 64;                        // weight transpose tile

// the epilogue stages its output in the drained ring
static_assert(staged_bytes<CONSUMERS>() <= STAGES * (TILE_A + TILE_B), "");

// dynamic shared memory of a GEMM CTA: the ring, its barriers and the slack
// that aligns the ring to 1024 bytes; two CTAs fit on an SM
constexpr int GEMM_SMEM = 1024 + STAGES * (TILE_A + TILE_B) + 2 * STAGES * 8;

// -- 1. the quantizing pass -----------------------------------------------------

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
    fence_barrier_init();
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

  // consumers: warpgroup wg owns rows wg*64 .. wg*64+63 of the tile
  int acc[64];
  mainloop<STAGES, TILE_A, TILE_B>(acc, sA, sB, full, nullptr, empty, nk,
                                   warp >> 2, lane);
  epilogue<T, CONSUMERS>(acc, smem, gamma, delta, y, M, N, m0, n0, warp, lane);
}

// -- host side ------------------------------------------------------------------

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
  if (!swizzled_map(&ma, codes, M, Kp, BM) || !swizzled_map(&mb, wt, N, Kp, BN))
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
