// bitlinear: y[M, N] = (q8(x) @ wq) * ((gamma/127) * delta)
//
// Replaces the TPU kernel repro/kernels/bitlinear/kernel.py::bitlinear_kernel,
// the QAT forward of every student projection.  wq is the ternary weight as
// int8 [K, N] (codes in {-1, 0, 1}, per-tensor scale delta); gamma [M] is the
// per-row absmax of x, computed by the wrapper because a row's scale needs
// the whole K row.  q8 = clip(rint(x * (127/(gamma+1e-5))), -128, 127) with
// the IEEE quotient and the op order of the TPU kernel (kernel.py:41); the
// products accumulate exactly in int32 and are scaled once in the epilogue
// (kernel.py:51-53), so the result equals the plain PyTorch version bit for
// bit.
//
// Bound on the H100: at the training shapes (M = 2048 tokens, K, N in
// 1024..3072) the int8 operations (2*M*K*N at 1979 TOP/s) and the bytes
// (x, wq and y once at 3.35 TB/s) take about the same few microseconds, so
// the kernel is meant for the int8 tensor cores.  This first version is the
// simple one: a 128 x 128 output tile per CTA, 8 warps of 64 x 32 each
// issuing mma.sync m16n8k32 s8 with int32 accumulators in registers, K in
// steps of 32.  Each step quantizes the x tile to int8 codes in shared
// memory (every CTA of a row block does so again: x is small next to the
// work) and stages the weight tile transposed to [n][k], so both operands
// load as 32-bit fragments.  No cp.async double buffering, TMA or wgmma yet.
#include "common.cuh"

namespace {

constexpr int BM = 128, BN = 128, BK = 32;
constexpr int WARPS_M = 2, WARPS_N = 4;
constexpr int THREADS = 32 * WARPS_M * WARPS_N;
constexpr int WM = BM / WARPS_M, WN = BN / WARPS_N;   // 64 x 32 per warp
constexpr int MI = WM / 16, NI = WN / 8;              // mma tiles per warp
constexpr int LDA = BK + 16;   // bytes per A row: conflict-free fragment reads
constexpr int LDB = BK + 4;    // bytes per B row ([n][k]): few-way conflicts

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t q8(float v, float inv) {
  float q = rintf(v * inv);
  q = fminf(fmaxf(q, -128.0f), 127.0f);
  return (uint32_t)((int)q & 0xff);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
bitlinear_kernel(const T* __restrict__ x, const int8_t* __restrict__ wq,
                 const float* __restrict__ gamma, const float* __restrict__ delta,
                 T* __restrict__ y, int M, int K, int N) {
  __shared__ __align__(16) uint8_t As[BM * LDA];   // int8 codes [m][k]
  __shared__ __align__(16) uint8_t Bs[BN * LDB];   // ternary codes [n][k]
  __shared__ float inv_s[BM];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const bool vec_n = (N & 3) == 0;

  if (tid < BM) {
    const int m = m0 + tid;
    inv_s[tid] = m < M ? 127.0f / (gamma[m] + 1e-5f) : 0.0f;
  }
  __syncthreads();

  int acc[MI][NI][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  for (int k0 = 0; k0 < K; k0 += BK) {
    // x tile -> int8 codes: each item is 4 consecutive k of one row; a warp
    // reads 4 rows x 32 columns, coalesced.
    for (int it = tid; it < BM * (BK / 4); it += THREADS) {
      const int r = it / (BK / 4), c4 = (it % (BK / 4)) * 4;
      const int m = m0 + r;
      uint32_t word = 0;
      if (m < M) {
        const T* xr = x + (size_t)m * K + k0 + c4;
        const float inv = inv_s[r];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (k0 + c4 + e < K) word |= q8(to_f32(xr[e]), inv) << (8 * e);
      }
      *reinterpret_cast<uint32_t*>(As + r * LDA + c4) = word;
    }
    // weight tile [BK][BN] -> Bs[n][k]: warp w reads rows 4w..4w+3, 4 bytes
    // of each per lane (one 128-byte row per load), then transposes the 4x4
    // bytes in registers.
    {
      const int kq = warp, nc = lane * 4;
      const int n = n0 + nc;
      uint32_t rows[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int k = k0 + kq * 4 + e;
        uint32_t v = 0;
        if (k < K) {
          const int8_t* wr = wq + (size_t)k * N + n;
          if (vec_n && n + 3 < N) {
            v = *reinterpret_cast<const uint32_t*>(wr);
          } else {
            for (int f = 0; f < 4; ++f)
              if (n + f < N) v |= (uint32_t)(uint8_t)wr[f] << (8 * f);
          }
        }
        rows[e] = v;
      }
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        const uint32_t col = ((rows[0] >> (8 * f)) & 0xffu) |
                             (((rows[1] >> (8 * f)) & 0xffu) << 8) |
                             (((rows[2] >> (8 * f)) & 0xffu) << 16) |
                             (((rows[3] >> (8 * f)) & 0xffu) << 24);
        *reinterpret_cast<uint32_t*>(Bs + (nc + f) * LDB + kq * 4) = col;
      }
    }
    __syncthreads();

    uint32_t bf[NI][2];
#pragma unroll
    for (int j = 0; j < NI; ++j) {
      const uint8_t* p = Bs + (wn * WN + j * 8 + g) * LDB + 4 * t;
      bf[j][0] = *reinterpret_cast<const uint32_t*>(p);
      bf[j][1] = *reinterpret_cast<const uint32_t*>(p + 16);
    }
#pragma unroll
    for (int i = 0; i < MI; ++i) {
      const uint8_t* p = As + (wm * WM + i * 16 + g) * LDA + 4 * t;
      const uint32_t af[4] = {
          *reinterpret_cast<const uint32_t*>(p),
          *reinterpret_cast<const uint32_t*>(p + 8 * LDA),
          *reinterpret_cast<const uint32_t*>(p + 16),
          *reinterpret_cast<const uint32_t*>(p + 8 * LDA + 16)};
#pragma unroll
      for (int j = 0; j < NI; ++j) mma_s8(acc[i][j], af, bf[j]);
    }
    __syncthreads();
  }

  const float d = delta[0];
#pragma unroll
  for (int i = 0; i < MI; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm * WM + i * 16 + g + 8 * h;
      if (m >= M) continue;
      const float scale = (gamma[m] / 127.0f) * d;
#pragma unroll
      for (int j = 0; j < NI; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = n0 + wn * WN + j * 8 + 2 * t + e;
          if (n < N)
            y[(size_t)m * N + n] = from_f32<T>((float)acc[i][j][2 * h + e] * scale);
        }
      }
    }
  }
}

template <typename T>
int launch(const void* x, const void* wq, const void* gamma, const void* delta,
           void* y, int M, int K, int N, cudaStream_t stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  bitlinear_kernel<T><<<grid, THREADS, 0, stream>>>(
      (const T*)x, (const int8_t*)wq, (const float*)gamma, (const float*)delta,
      (T*)y, M, K, N);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int bitlinear_launch(const void* x, const void* wq, const void* gamma,
                                const void* delta, void* y, int M, int K, int N,
                                int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == DT_F32) return launch<float>(x, wq, gamma, delta, y, M, K, N, s);
  if (dtype == DT_BF16)
    return launch<__nv_bfloat16>(x, wq, gamma, delta, y, M, K, N, s);
  return (int)cudaErrorInvalidValue;
}
