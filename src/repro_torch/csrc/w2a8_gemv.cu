// w2a8: y[M, N] = (q8(x) @ unpack(wp)) * (gamma/127 * delta)
//
// Replaces the TPU kernel repro/kernels/w2a8_gemv/kernel.py::w2a8_kernel.
// wp is uint8 [K/4, N], four ternary weights per byte packed little-endian
// along K (value + 1 in two bits).  q8 = clip(rint(x * (127/(gamma+1e-5))),
// -128, 127) with gamma the per-row absmax; products accumulate in int32, so
// the result is exact up to the final fp32 scale and matches the plain
// PyTorch version bit for bit.
//
// Bound on the H100: decode rows (M <= 8) read every packed weight byte once
// and do 2*M*K*N integer operations on them, far below the card's integer
// rate, so the kernel is bound by the weight bytes from device memory.  The
// design keeps those reads coalesced and single: one CTA owns 32 consecutive
// output columns (one per lane), so each packed row is one 32-byte sector
// read by a warp, and the 8 warps of the CTA split the K loop.  The CTA's
// activation rows are quantized once into shared memory as int8 codes (the
// absmax is a warp reduction over the row), and the 2-bit weights are
// unpacked in registers right after the load.  dp4a, wgmma and TMA are left
// for later work.
#include "common.cuh"

constexpr int MT = 8;    // activation rows per CTA
constexpr int BN = 32;   // output columns per CTA, one per lane
constexpr int KW = 8;    // warps splitting the packed-K loop

template <typename T>
__global__ void __launch_bounds__(BN * KW)
w2a8_kernel(const T* __restrict__ x, const uint8_t* __restrict__ wp,
            const float* __restrict__ delta, T* __restrict__ y,
            int M, int K, int N) {
  extern __shared__ __align__(16) int8_t xs[];  // [MT][K] int8 codes
  __shared__ float gam[MT];
  __shared__ int red[KW][MT][BN];
  const int lane = threadIdx.x, wy = threadIdx.y;
  const int tid = wy * BN + lane;
  const int m0 = blockIdx.y * MT;
  const int mt = min(MT, M - m0);
  const int n = blockIdx.x * BN + lane;

  // per-row absmax: warp wy reduces row wy (MT == KW)
  {
    float g = 0.f;
    if (wy < mt) {
      const T* xr = x + (size_t)(m0 + wy) * K;
      for (int k = lane; k < K; k += 32) g = fmaxf(g, fabsf(to_f32(xr[k])));
    }
    for (int off = 16; off > 0; off >>= 1)
      g = fmaxf(g, __shfl_xor_sync(0xffffffffu, g, off));
    if (lane == 0) gam[wy] = g;
  }
  __syncthreads();

  // quantize the CTA's rows to int8 codes in shared memory
  for (int i = tid; i < MT * K; i += BN * KW) {
    const int r = i / K, k = i - r * K;
    int code = 0;
    if (r < mt) {
      const float inv = 127.0f / (gam[r] + 1e-5f);
      float v = rintf(to_f32(x[(size_t)(m0 + r) * K + k]) * inv);
      v = fminf(fmaxf(v, -128.0f), 127.0f);
      code = (int)v;
    }
    xs[i] = (int8_t)code;
  }
  __syncthreads();

  int acc[MT];
#pragma unroll
  for (int r = 0; r < MT; ++r) acc[r] = 0;
  if (n < N) {
    const int KP = K / 4;
    for (int kp = wy; kp < KP; kp += KW) {
      const uint32_t b = wp[(size_t)kp * N + n];
      const int w0 = (int)(b & 3u) - 1;
      const int w1 = (int)((b >> 2) & 3u) - 1;
      const int w2 = (int)((b >> 4) & 3u) - 1;
      const int w3 = (int)((b >> 6) & 3u) - 1;
#pragma unroll
      for (int r = 0; r < MT; ++r) {
        const char4 c = *reinterpret_cast<const char4*>(xs + r * K + 4 * kp);
        acc[r] += (int)c.x * w0 + (int)c.y * w1 + (int)c.z * w2 + (int)c.w * w3;
      }
    }
  }
#pragma unroll
  for (int r = 0; r < MT; ++r) red[wy][r][lane] = acc[r];
  __syncthreads();

  // one output per thread: thread (wy, lane) finishes row wy, column n
  if (wy < mt && n < N) {
    int s = 0;
#pragma unroll
    for (int w = 0; w < KW; ++w) s += red[w][wy][lane];
    const float scale = (gam[wy] / 127.0f) * delta[0];
    y[(size_t)(m0 + wy) * N + n] = from_f32<T>((float)s * scale);
  }
}

template <typename T>
static int launch(const void* x, const void* wp, const void* delta, void* y,
                  int M, int K, int N, cudaStream_t stream) {
  const dim3 block(BN, KW);
  const dim3 grid((N + BN - 1) / BN, (M + MT - 1) / MT);
  const size_t smem = (size_t)MT * K;
  static size_t allowed = 0;
  cudaError_t err = allow_smem(w2a8_kernel<T>, smem, &allowed);
  if (err != cudaSuccess) return (int)err;
  w2a8_kernel<T><<<grid, block, smem, stream>>>(
      (const T*)x, (const uint8_t*)wp, (const float*)delta, (T*)y, M, K, N);
  return (int)cudaGetLastError();
}

extern "C" int w2a8_gemv_launch(const void* x, const void* wp, const void* delta,
                                void* y, int M, int K, int N, int dtype,
                                void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == DT_F32) return launch<float>(x, wp, delta, y, M, K, N, s);
  if (dtype == DT_BF16) return launch<__nv_bfloat16>(x, wp, delta, y, M, K, N, s);
  return (int)cudaErrorInvalidValue;
}
