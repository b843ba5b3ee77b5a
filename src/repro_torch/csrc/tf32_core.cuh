// 3xTF32 products on the tensor cores, shared by ssd_scan.cu (mma.sync
// m16n8k8) and relation_kd.cu (wgmma m64n64k8).  The tensor cores take
// fp32 only as TF32 (10 mantissa bits); an fp32 product a.b is taken as
// a_lo.b_hi + a_hi.b_lo + a_hi.b_hi, the small products first, with
// v = hi + lo split by bit masks (no conversion instruction): about fp32's
// precision at three TF32 products.
#pragma once

#include "common.cuh"

namespace {

// v = hi + lo + (below 2^-21 |v|): hi keeps the top 10 mantissa bits of v
// (the part a TF32 operand holds), lo the next 10 of the exact remainder
// v - hi; two bit masks and a subtraction, no conversion instruction
__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(v) & 0xFFFFE000u;
  lo = __float_as_uint(v - __uint_as_float(hi)) & 0xFFFFE000u;
}

// D[16 x 8] += A[16 x 8] B[8 x 8]; fragments as the PTX ISA gives them for
// m16n8k8 .tf32 with g = lane / 4, t = lane % 4: a = A[g][t], A[g+8][t],
// A[g][t+4], A[g+8][t+4]; b = B[t][g], B[t+4][g]; d = D[g][2t], D[g][2t+1],
// D[g+8][2t], D[g+8][2t+1]
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// D += A B in 3xTF32 from split fragments, the small products first
__device__ __forceinline__ void mma3s(float (&d)[4], const uint32_t (&ah)[4],
                                      const uint32_t (&al)[4], uint32_t bh0,
                                      uint32_t bh1, uint32_t bl0, uint32_t bl1) {
  mma_tf32(d, al, bh0, bh1);
  mma_tf32(d, ah, bl0, bl1);
  mma_tf32(d, ah, bh0, bh1);
}

// D += A B in 3xTF32, the small products first
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], const float (&b)[2]) {
  uint32_t bh0, bl0, bh1, bl1;
  split(b[0], bh0, bl0);
  split(b[1], bh1, bl1);
  mma3s(d, ah, al, bh0, bh1, bl0, bl1);
}

__device__ __forceinline__ void split4(const float (&a)[4], uint32_t (&hi)[4],
                                       uint32_t (&lo)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) split(a[i], hi[i], lo[i]);
}

// D[64 x 64] (+)= A[64 x 8] B[64 x 8]^T on TF32, both K-major in shared
// memory (descriptors); D in the warpgroup's registers (lane (g, t) of warp
// w: d[4n + 2h + c] = D[16w + g + 8h][8n + 2t + c]).  accumulate = 0
// starts D from zero.
__device__ __forceinline__ void wgmma_m64n64k8_tf32(float (&d)[32], uint64_t da,
                                                    uint64_t db, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, %32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]),
        "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),
        "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]),
        "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// keep the compiler from moving accumulator accesses across async MMAs
__device__ __forceinline__ void fence_regs(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

}  // namespace
