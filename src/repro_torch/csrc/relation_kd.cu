// relation_kd: per-row KL( softmax_j(t_i . t_j / temp) || softmax_j(s_i . s_j / temp) )
//
// Replaces the TPU kernel
// repro/kernels/relation_kd/kernel.py::relation_kl_rows_kernel, the MiniLM
// attention-relation loss of distillation stage 3 (Eqs. 10-12).  s and t are
// the L2-normalized, head-resplit student and teacher states, fp32
// [BH, L, D]; the output is the KL of every relation row, fp32 [BH, L].  The
// L x L relation matrices are never formed: the loop over j tiles keeps five
// running values per row (teacher max m_t and sum z_t, student max m_s and
// sum z_s, and u = sum_j exp(t_rel - m_t) * (t_rel - s_rel), rescaled as the
// maxima grow), and the row finishes with the TPU kernel's
//   KL_i = u / z_t - (m_t + log z_t) + (m_s + log z_s)
// (kernel.py:85-92, z clamped at 1e-30), regrouped as
//   u / z_t + (m_s - m_t) + log(z_s / z_t):
// the same value without subtracting two sums of ~log(L), whose rounding
// (~ulp(5.5) at L = 256) would be as large as the KL of near rows.  Padded
// columns (j >= L) take no part, which is what the TPU kernel's NEG = -1e30
// mask amounts to (exp(NEG - m) == 0).  No probability clamp is applied here,
// as in the TPU kernel; the plain core/distill.py::relation_kl path clamps.
//
// Bound on the H100: the two relation products, 2 * 2*BH*L*L*D fp32
// operations at 67 TFLOP/s, outweigh the bytes (s and t read once): at
// BH=32, L=256, D=512 about 64 us against 10 us.  Design: one CTA per
// (bh, 32-row i tile) loops over 32-column j tiles; D is streamed through
// shared memory in 32-wide chunks (at D = 512 the fp32 i and j tiles of s
// and t would not fit at once), each thread accumulating a 2 x 2 block of
// both relations in registers with scalar FMAs.  The tile's relations then
// go through shared memory to 8 threads per row for the online update, whose
// state stays in their registers.  Tensor cores (TF32 would break the fp32
// parity the loss is held to) and larger register tiles are later work.
#include "common.cuh"

namespace {

constexpr int BI = 32, BJ = 32, DK = 32;
constexpr int THREADS = 256;
constexpr int ROW_LANES = THREADS / BI;   // 8 threads per relation row

__device__ __forceinline__ float group_max(float v) {
#pragma unroll
  for (int o = ROW_LANES / 2; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = ROW_LANES / 2; o > 0; o >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void __launch_bounds__(THREADS)
relation_kl_rows_kernel(const float* __restrict__ s, const float* __restrict__ t,
                        float* __restrict__ out, int L, int D, float temp) {
  __shared__ float sI[BI][DK + 1], tI[BI][DK + 1];
  __shared__ float sJ[BJ][DK + 1], tJ[BJ][DK + 1];
  __shared__ float srel[BI][BJ + 1], trel[BI][BJ + 1];
  const int tid = threadIdx.x;
  const int bh = blockIdx.y, i0 = blockIdx.x * BI;
  const float* sb = s + (size_t)bh * L * D;
  const float* tb = t + (size_t)bh * L * D;
  // relation tile: thread (ty, tx) owns rows ty, ty+16 and columns tx, tx+16
  const int ty = tid / 16, tx = tid % 16;
  // online update: thread (row, c) owns columns c, c+8, c+16, c+24 of a row
  const int row = tid / ROW_LANES, c = tid % ROW_LANES;

  float m_t = -1e30f, z_t = 0.0f, m_s = -1e30f, z_s = 0.0f, u = 0.0f;

  for (int j0 = 0; j0 < L; j0 += BJ) {
    float at[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
    float as[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
    for (int d0 = 0; d0 < D; d0 += DK) {
      // each warp loads whole 32-float rows of a chunk: coalesced
      for (int it = tid; it < BI * DK; it += THREADS) {
        const int r = it / DK, k = it % DK, d = d0 + k;
        const int i = i0 + r, j = j0 + r;
        const bool di = i < L && d < D, dj = j < L && d < D;
        sI[r][k] = di ? sb[(size_t)i * D + d] : 0.0f;
        tI[r][k] = di ? tb[(size_t)i * D + d] : 0.0f;
        sJ[r][k] = dj ? sb[(size_t)j * D + d] : 0.0f;
        tJ[r][k] = dj ? tb[(size_t)j * D + d] : 0.0f;
      }
      __syncthreads();
#pragma unroll 8
      for (int k = 0; k < DK; ++k) {
        const float ti0 = tI[ty][k], ti1 = tI[ty + 16][k];
        const float si0 = sI[ty][k], si1 = sI[ty + 16][k];
        const float tj0 = tJ[tx][k], tj1 = tJ[tx + 16][k];
        const float sj0 = sJ[tx][k], sj1 = sJ[tx + 16][k];
        at[0][0] = fmaf(ti0, tj0, at[0][0]);
        at[0][1] = fmaf(ti0, tj1, at[0][1]);
        at[1][0] = fmaf(ti1, tj0, at[1][0]);
        at[1][1] = fmaf(ti1, tj1, at[1][1]);
        as[0][0] = fmaf(si0, sj0, as[0][0]);
        as[0][1] = fmaf(si0, sj1, as[0][1]);
        as[1][0] = fmaf(si1, sj0, as[1][0]);
        as[1][1] = fmaf(si1, sj1, as[1][1]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        trel[ty + 16 * a][tx + 16 * b] = at[a][b] / temp;
        srel[ty + 16 * a][tx + 16 * b] = as[a][b] / temp;
      }
    __syncthreads();

    // online rescale of the row's five accumulators over this tile's columns
    float tv[BJ / ROW_LANES], sv[BJ / ROW_LANES];
    float tmax = -1e30f, smax = -1e30f;
#pragma unroll
    for (int q = 0; q < BJ / ROW_LANES; ++q) {
      const int jj = c + ROW_LANES * q;
      const bool ok = j0 + jj < L;
      tv[q] = ok ? trel[row][jj] : -1e30f;
      sv[q] = ok ? srel[row][jj] : -1e30f;
      tmax = fmaxf(tmax, tv[q]);
      smax = fmaxf(smax, sv[q]);
    }
    const float mt_new = fmaxf(m_t, group_max(tmax));
    const float ms_new = fmaxf(m_s, group_max(smax));
    float pt_sum = 0.0f, ps_sum = 0.0f, u_sum = 0.0f;
#pragma unroll
    for (int q = 0; q < BJ / ROW_LANES; ++q) {
      if (j0 + c + ROW_LANES * q >= L) continue;
      const float pt = expf(tv[q] - mt_new);
      pt_sum += pt;
      ps_sum += expf(sv[q] - ms_new);
      u_sum += pt * (tv[q] - sv[q]);
    }
    pt_sum = group_sum(pt_sum);
    ps_sum = group_sum(ps_sum);
    u_sum = group_sum(u_sum);
    const float ct = expf(m_t - mt_new), cs = expf(m_s - ms_new);
    z_t = z_t * ct + pt_sum;
    z_s = z_s * cs + ps_sum;
    u = u * ct + u_sum;
    m_t = mt_new;
    m_s = ms_new;
    __syncthreads();   // srel/trel are rewritten by the next tile
  }

  const int i = i0 + row;
  if (c == 0 && i < L) {
    const float zt = fmaxf(z_t, 1e-30f), zs = fmaxf(z_s, 1e-30f);
    out[(size_t)bh * L + i] = u / zt + (m_s - m_t) + logf(zs / zt);
  }
}

}  // namespace

extern "C" int relation_kd_launch(const void* s, const void* t, void* out, int BH,
                                  int L, int D, float temp, void* stream) {
  const dim3 grid((L + BI - 1) / BI, BH);
  relation_kl_rows_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)s, (const float*)t, (float*)out, L, D, temp);
  return (int)cudaGetLastError();
}
