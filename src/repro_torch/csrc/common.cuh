// Shared helpers for the hand-written Hopper kernels of repro_torch.
// Each .cu file exposes a plain C launcher (loaded with ctypes) that returns
// cudaGetLastError() so the Python wrapper can raise on a refused launch.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

// dtype codes shared with repro_torch/kernels/build.py
enum { DT_F32 = 0, DT_BF16 = 1 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// -- the int8 activation quantizer (bitlinear.cu, w2a8_gemv.cu) -----------------

// max that keeps a NaN, as torch.amax does
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a > b || a != a) ? a : b;
}

// clip(rint(v * inv), -128, 127) as an int8 code in the low byte, with
// inv = 127 / (gamma + 1e-5) (the IEEE quotient, taken once per row)
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

// Raise a kernel's dynamic shared memory limit to `bytes` (static shared
// memory comes on top; the sum may reach 227 KB).  `allowed` caches the
// size already granted so the attribute call happens once per new maximum.
template <typename K>
static cudaError_t allow_smem(K kernel, size_t bytes, size_t* allowed) {
  if (bytes <= *allowed) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess) *allowed = bytes;
  return err;
}
