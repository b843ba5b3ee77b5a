// relation_kd: per-row KL( softmax_j(t_i . t_j / temp) || softmax_j(s_i . s_j / temp) )
//
// Replaces the TPU kernel
// repro/kernels/relation_kd/kernel.py::relation_kl_rows_kernel, the MiniLM
// attention-relation loss of distillation stage 3 (Eqs. 10-12).  s and t are
// the L2-normalized, head-resplit student and teacher states, fp32
// [BH, L, D]; the output is the KL of every relation row, fp32 [BH, L].  The
// L x L relation matrices are never formed: the walk over j tiles keeps five
// running values per row (teacher max m_t and sum z_t, student max m_s and
// sum z_s, and u = sum_j exp(t_rel - m_t) * (t_rel - s_rel), rescaled as the
// maxima grow), and the row finishes with the TPU kernel's
//   KL_i = u / z_t - (m_t + log z_t) + (m_s + log z_s)
// (kernel.py:85-92, z clamped at 1e-30), regrouped as
//   u / z_t + (m_s - m_t) + log(z_s / z_t):
// the same value without subtracting two sums of ~log(L), whose rounding
// (~ulp(5.5) at L = 256) would be as large as the KL of near rows.  Padded
// columns (j >= L) are set to NEG = -1e30 before the max, the TPU kernel's
// mask: exp(NEG - m) == 0 and their t_rel - s_rel is 0, so they add
// nothing.  No probability clamp is applied, as in the TPU kernel; the plain
// core/distill.py::relation_kl path clamps.
//
// Bound on the H100: the two relation products, 2 * 2*BH*L*L*D operations,
// which run on the tensor cores as 3xTF32 (tf32_core.cuh: three TF32
// products for each fp32 one; a single TF32 product misses the rtol 1e-5
// gate at temperatures below 1 and on clustered rows), so 3 * 4.3 GFLOP at
// 495 TFLOP/s at BH=32, L=256, D=512: 0.026 ms, against 0.010 ms for the
// bytes (s and t read once).
//
// Design (one warpgroup of 128 threads a CTA, two CTAs an SM):
//  * A CTA owns BI = 64 rows i of one bh and walks its split's j tiles of
//    BJ = 64 columns.  For each j tile one pass over D gives both relation
//    tiles, t_i.t_j^T and s_i.s_j^T, with wgmma m64n64k8 on TF32: it runs
//    asynchronously, beside the copy of the next chunk and the other CTA's
//    work, and reads its operands from shared memory, not registers.  The
//    rows i and j index both tensors, so both operands are K-major rows of
//    s or t, which is the only layout wgmma takes for TF32.
//  * D streams in chunks of 32 floats (128 bytes a row).  cp.async brings a
//    chunk's i rows and j rows of s and t into a raw stage (32 KB; each
//    thread copies one 16-byte column of 16 rows, its addresses set once);
//    then all threads split each float once into its TF32 high and low
//    parts and store them as eight K-major tiles (A_hi, A_lo, B_hi, B_lo of
//    t and s, 64 rows of 128 bytes each, 64 KB) in the 128-byte swizzle
//    wgmma reads (igemm_core.cuh's convention).  The next chunk is copied
//    while the tensor cores take this one; the split waits for them, and
//    the other CTA on the SM keeps the tensor cores busy meanwhile (97 KB
//    of shared memory a CTA).  At D = 512 the i tile of s and t alone
//    would be 256 KB, so the i rows are streamed beside the j rows and
//    re-read from L2 for every j tile: BH * n_i * n_j * (BI + BJ) * D * 8
//    bytes through L2 per launch (268 MB at BH=32, L=256, D=512; 68.7 GB
//    at L=4096), much of the kernel's time (PERF.md).  Rows past L and D
//    past its end are zero-filled by the copies (src-size 0); a D that is
//    not a multiple of 4, or an operand not on a 16-byte boundary, takes
//    4-byte copies instead.
//  * The tensor cores sum an MMA's products into its accumulator with
//    truncation, not rounding to nearest: one accumulator carried over all
//    of D drifts toward zero by ~1e-5 of the relation (192 truncations at
//    D = 512), which at temp 0.25 moves the rows past the gate (measured
//    with a single chain, and modelled in tests/test_torch_relation_tiles.py).
//    So every 16 floats of D (two k steps, six products: both steps'
//    lo.hi, then hi.lo, then hi.hi) start from a zero accumulator and are
//    added into the tile's sums with fp32 adds (rounded to nearest).
//  * At the end of a j tile the online update runs on the sums in
//    registers: lane (g, q) of warp w holds columns 8n + 2q, 8n + 2q + 1 of
//    rows 16w + g and 16w + g + 8, so a row's max and sums are reduced
//    across the four lanes of a quad (shuffles); relations are divided by
//    temp after the sum (an IEEE division, as the plain version) and the
//    five values stay in registers.
//  * With too few row tiles for two CTAs on each SM the j walk is split
//    across CTAs (relation_plan).  Each split writes its rows' five values
//    to a workspace; the last CTA of a row tile to finish (a counter, zeroed
//    again by that CTA, so the counters need no memset launch) merges them
//    in split order: m = max over the splits, z and u rescaled by
//    exp(m_split - m) and summed from split 0 on.  The result is bitwise the
//    same from run to run.
//  * expf and logf are the accurate functions, not the fast intrinsics.
#include "igemm_core.cuh"
#include "tf32_core.cuh"

namespace {

constexpr int THREADS = 128;     // one warpgroup
constexpr int BI = 64;           // rows i a CTA owns (wgmma's M)
constexpr int BJ = 64;           // columns j a tile holds (wgmma's N)
constexpr int DK = 32;           // floats of D a stage holds (128 bytes a row)
constexpr int ROWS = BI + BJ;    // rows of one tensor in a raw stage
constexpr int RAW_BYTES = 2 * ROWS * DK * 4;   // t's rows, then s's: 32 KB
constexpr int TILE_BYTES = 64 * DK * 4;        // one K-major split tile: 8 KB
constexpr int SPLIT_BYTES = 8 * TILE_BYTES;    // [t, s][A_hi, A_lo, B_hi, B_lo]
constexpr int SMEM_BYTES = SPLIT_BYTES + RAW_BYTES + 1024;   // + alignment: 97 KB
constexpr int TARGET_CTAS = 2 * 132;           // two CTAs on each SM of an H100
constexpr int MAX_SPLITS = 16;
constexpr int PARTS = 5;                       // m_t, z_t, m_s, z_s, u
constexpr float NEG = -1e30f;

struct RelationPlan {
  int n_i, n_j;            // row tiles, column tiles
  int splits, per_split;   // j walk splits, column tiles in each
  long long ws_floats;     // the splits' partials [BH, n_i, splits, 5, BI]
  long long counters;      // one per row tile, [BH, n_i]
  long long ctas;
};

static inline bool relation_plan(int BH, int L, int D, RelationPlan& p) {
  if (BH < 1 || L < 1 || D < 0 || BH > 65535) return false;
  p.n_i = (L + BI - 1) / BI;
  p.n_j = (L + BJ - 1) / BJ;
  const long long base = (long long)BH * p.n_i;
  long long want = (TARGET_CTAS + base - 1) / base;
  if (want > MAX_SPLITS) want = MAX_SPLITS;
  if (want > p.n_j) want = p.n_j;
  p.per_split = (int)((p.n_j + want - 1) / want);
  p.splits = (p.n_j + p.per_split - 1) / p.per_split;
  p.ws_floats = p.splits > 1 ? base * p.splits * PARTS * BI : 0;
  p.counters = p.splits > 1 ? base : 0;
  p.ctas = base * p.splits;
  return p.ctas < (1LL << 31);
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(dst)),
               "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(dst)),
               "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ float kl_row(float m_t, float z_t, float m_s, float z_s,
                                        float u) {
  const float zt = fmaxf(z_t, 1e-30f), zs = fmaxf(z_s, 1e-30f);
  return u / zt + (m_s - m_t) + logf(zs / zt);
}

// Raw stage `step` of the walk: D chunk step % n_dc of the rows i and the
// rows of j tile step / n_dc, t's then s's, each row 128 bytes.
template <bool VEC>
__device__ __forceinline__ void load_raw(float* st, const float* tb, const float* sb,
                                         int i0, int j0, int d0, int L, int D) {
  const int tid = threadIdx.x;
  if (VEC) {
    // thread tid copies chunk k = tid % 8 of rows r0 + 16 m, m = 0..7 (i rows
    // for m < 4, then j rows), of both tensors
    static_assert(THREADS == 128 && ROWS == 128 && DK == 32, "");
    const int k = tid % 8, r0 = tid / 8, d = d0 + 4 * k;
    float* dst = st + r0 * DK + 4 * k;
#pragma unroll
    for (int m = 0; m < 8; ++m) {
      const int row = (m < 4 ? i0 : j0 - BI) + r0 + 16 * m;
      const bool ok = row < L && d < D;
      const size_t off = ok ? (size_t)row * D + d : 0;
      cp_async16(dst + 16 * m * DK, tb + off, ok ? 16 : 0);
      cp_async16(dst + (ROWS + 16 * m) * DK, sb + off, ok ? 16 : 0);
    }
  } else {
    for (int e = tid; e < 2 * ROWS * DK; e += THREADS) {
      const int tensor = e / (ROWS * DK), r = (e / DK) % ROWS;
      const int d = d0 + e % DK;
      const int row = r < BI ? i0 + r : j0 + r - BI;
      const bool ok = row < L && d < D;
      const float* base = tensor ? sb : tb;
      cp_async4(st + e, ok ? base + (size_t)row * D + d : base, ok ? 4 : 0);
    }
  }
}

// Split a raw stage into its eight K-major tiles: tensor x's rows i as A and
// rows j as B, high then low TF32 parts, the 16-byte chunk k of row r at
// chunk k ^ (r & 7) (the 128-byte swizzle).  Thread tid takes chunk
// k = tid % 8 of rows tid / 8 + 16 m: eight lanes take one row's eight
// chunks, so both the read and the write cover 32 banks.
__device__ __forceinline__ void split_stage(const float* raw, uint8_t* tiles) {
  const int k = threadIdx.x % 8, r0 = threadIdx.x / 8;
  const float* src = raw + r0 * DK + 4 * k;
  uint8_t* dst = tiles + r0 * 128 + 16 * (k ^ (r0 & 7));
#pragma unroll
  for (int x = 0; x < 2; ++x)
#pragma unroll
    for (int m = 0; m < 8; ++m) {
      const float4 v = *reinterpret_cast<const float4*>(src + (x * ROWS + 16 * m) * DK);
      uint4 hi, lo;
      split(v.x, hi.x, lo.x);
      split(v.y, hi.y, lo.y);
      split(v.z, hi.z, lo.z);
      split(v.w, hi.w, lo.w);
      uint8_t* t = dst + (x * 4 + 2 * (m / 4)) * TILE_BYTES + (m % 4) * 16 * 128;
      *reinterpret_cast<uint4*>(t) = hi;
      *reinterpret_cast<uint4*>(t + TILE_BYTES) = lo;
    }
}

// grid (n_i * splits, BH): CTA x takes row tile x / splits and split
// x % splits of its j walk.  part / counters: the workspace (unused with
// one split).
template <bool VEC>
__global__ void __launch_bounds__(THREADS, 2)
relation_kl_tiles(const float* __restrict__ s, const float* __restrict__ t,
                  float* __restrict__ out, float* __restrict__ part,
                  unsigned* __restrict__ counters, int L, int D, float temp,
                  int splits, int per_split) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ bool last;
  // the eight split tiles (1024-aligned), then the raw stage
  uint8_t* tiles = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  float* raw_st = reinterpret_cast<float*>(tiles + SPLIT_BYTES);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;
  const int bh = blockIdx.y, it = blockIdx.x / splits, sp = blockIdx.x % splits;
  const int n_i = (L + BI - 1) / BI, n_j = (L + BJ - 1) / BJ;
  const int i0 = it * BI, jt0 = sp * per_split;
  const int n_dc = D > DK ? (D + DK - 1) / DK : 1;
  const int steps = (min(n_j, jt0 + per_split) - jt0) * n_dc;
  const float* sb = s + (size_t)bh * L * D;
  const float* tb = t + (size_t)bh * L * D;
  auto raw = [&](int p) {   // chunk p's rows into the raw stage
    if (p < steps)
      load_raw<VEC>(raw_st, tb, sb, i0, (jt0 + p / n_dc) * BJ, (p % n_dc) * DK, L, D);
    cp_async_commit();
  };

  float sum[2][32];      // the j tile's t_i.t_j^T and s_i.s_j^T, fp32 sums
  float chain[2][2][32];  // [tensor][16 floats of the chunk]: fresh each chunk
#pragma unroll
  for (int x = 0; x < 2; ++x)
#pragma unroll
    for (int e = 0; e < 32; ++e) sum[x][e] = chain[x][0][e] = chain[x][1][e] = 0.0f;
  float m_t[2] = {NEG, NEG}, z_t[2] = {0.f, 0.f};
  float m_s[2] = {NEG, NEG}, z_s[2] = {0.f, 0.f}, u[2] = {0.f, 0.f};

  raw(0);
  cp_async_wait<0>();
  __syncthreads();
  split_stage(raw_st, tiles);
  igemm::fence_proxy_async();
  __syncthreads();
  raw(1);
  for (int step = 0; step < steps; ++step) {
    // the tiles hold chunk `step`, the raw stage receives chunk step + 1:
    // six products for each 16 floats of D and each tensor
#pragma unroll
    for (int x = 0; x < 2; ++x)
#pragma unroll
      for (int h = 0; h < 2; ++h) fence_regs(chain[x][h]);
    igemm::wgmma_fence();
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      const uint8_t* a_hi = tiles + (4 * x) * TILE_BYTES;
      const uint8_t* a_lo = a_hi + TILE_BYTES;
      const uint8_t* b_hi = a_hi + 2 * TILE_BYTES;
      const uint8_t* b_lo = a_hi + 3 * TILE_BYTES;
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int part = 0; part < 3; ++part)
#pragma unroll
          for (int kk = 2 * h; kk < 2 * h + 2; ++kk) {
            const uint8_t* a = part == 0 ? a_lo : a_hi;
            const uint8_t* b = part == 1 ? b_lo : b_hi;
            wgmma_m64n64k8_tf32(chain[x][h], igemm::sw128_desc(a + 32 * kk),
                                igemm::sw128_desc(b + 32 * kk),
                                part > 0 || kk > 2 * h);
          }
    }
    igemm::wgmma_commit();
    cp_async_wait<0>();
    igemm::wgmma_wait<0>();
    __syncthreads();   // chunk step + 1 has landed, the tiles are read
    if (step + 1 < steps) {
      split_stage(raw_st, tiles);
      igemm::fence_proxy_async();
    }
#pragma unroll
    for (int x = 0; x < 2; ++x)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        fence_regs(chain[x][h]);
#pragma unroll
        for (int e = 0; e < 32; ++e) sum[x][e] += chain[x][h][e];
      }
    __syncthreads();   // the tiles hold chunk step + 1, the raw stage is free
    raw(step + 2);
    if (step % n_dc != n_dc - 1) continue;

    // the j tile is done: online update of rows g and g + 8 over its columns
    const int j0 = (jt0 + step / n_dc) * BJ;
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      float tv[16], sv[16], tmax = NEG, smax = NEG;
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const bool ok = j0 + 8 * n + 2 * q + c < L;
          tv[2 * n + c] = ok ? sum[0][4 * n + 2 * hr + c] / temp : NEG;
          sv[2 * n + c] = ok ? sum[1][4 * n + 2 * hr + c] / temp : NEG;
          tmax = fmaxf(tmax, tv[2 * n + c]);
          smax = fmaxf(smax, sv[2 * n + c]);
        }
      const float mt = fmaxf(m_t[hr], quad_max(tmax));
      const float ms = fmaxf(m_s[hr], quad_max(smax));
      float pt_sum = 0.0f, ps_sum = 0.0f, u_sum = 0.0f;
#pragma unroll
      for (int e = 0; e < 16; ++e) {   // a masked column adds exp(NEG - m) = 0
        const float pt = expf(tv[e] - mt);
        pt_sum += pt;
        ps_sum += expf(sv[e] - ms);
        u_sum += pt * (tv[e] - sv[e]);
      }
      const float ct = expf(m_t[hr] - mt), cs = expf(m_s[hr] - ms);
      z_t[hr] = z_t[hr] * ct + quad_sum(pt_sum);
      z_s[hr] = z_s[hr] * cs + quad_sum(ps_sum);
      u[hr] = u[hr] * ct + quad_sum(u_sum);
      m_t[hr] = mt;
      m_s[hr] = ms;
    }
#pragma unroll
    for (int x = 0; x < 2; ++x)
#pragma unroll
      for (int e = 0; e < 32; ++e) sum[x][e] = 0.0f;
  }
  cp_async_wait<0>();

  // the quad holds one row's values in each of its lanes; lane q == 0 writes
  if (splits == 1) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int i = i0 + 16 * warp + g + 8 * hr;
      if (q == 0 && i < L)
        out[(size_t)bh * L + i] = kl_row(m_t[hr], z_t[hr], m_s[hr], z_s[hr], u[hr]);
    }
    return;
  }
  float* tile = part + ((size_t)bh * n_i + it) * splits * PARTS * BI;
  if (q == 0) {
    float* mine = tile + (size_t)sp * PARTS * BI;
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int r = 16 * warp + g + 8 * hr;
      mine[r] = m_t[hr];
      mine[BI + r] = z_t[hr];
      mine[2 * BI + r] = m_s[hr];
      mine[3 * BI + r] = z_s[hr];
      mine[4 * BI + r] = u[hr];
    }
  }
  __threadfence();
  __syncthreads();
  unsigned* counter = counters + (size_t)bh * n_i + it;
  if (tid == 0) last = atomicAdd(counter, 1u) == (unsigned)splits - 1;
  __syncthreads();
  if (!last) return;
  // the last split of this row tile: every split's values have landed
  __threadfence();
  if (tid < BI && i0 + tid < L) {
    float mt = NEG, ms = NEG;
    for (int k = 0; k < splits; ++k) {
      const float* pk = tile + (size_t)k * PARTS * BI + tid;
      mt = fmaxf(mt, __ldcg(pk));
      ms = fmaxf(ms, __ldcg(pk + 2 * BI));
    }
    float zt = 0.0f, zs = 0.0f, uu = 0.0f;
    for (int k = 0; k < splits; ++k) {
      const float* pk = tile + (size_t)k * PARTS * BI + tid;
      const float ct = expf(__ldcg(pk) - mt);
      zt += __ldcg(pk + BI) * ct;
      zs += __ldcg(pk + 3 * BI) * expf(__ldcg(pk + 2 * BI) - ms);
      uu += __ldcg(pk + 4 * BI) * ct;
    }
    out[(size_t)bh * L + i0 + tid] = kl_row(mt, zt, ms, zs, uu);
  }
  if (tid == 0) *counter = 0u;
}

template <bool VEC>
int launch(const float* s, const float* t, float* out, float* part,
           unsigned* counters, const RelationPlan& p, int L, int D, float temp,
           int BH, cudaStream_t stream) {
  static size_t allowed = 0;
  cudaError_t err = allow_smem(relation_kl_tiles<VEC>, SMEM_BYTES, &allowed);
  if (err != cudaSuccess) {
    cudaGetLastError();   // reported here, not to the next launcher
    return (int)err;
  }
  relation_kl_tiles<VEC><<<dim3(p.n_i * p.splits, BH), THREADS, SMEM_BYTES, stream>>>(
      s, t, out, part, counters, L, D, temp, p.splits, p.per_split);
  return (int)cudaGetLastError();
}

}  // namespace

// The launch plan for [BH, L, D]: rows a CTA owns, columns a j tile holds,
// splits of the j walk, j tiles in each split, fp32 floats of the splits'
// partials, uint32 counters (one per row tile; they must be 0 at launch,
// and the merging CTA leaves them 0), CTAs.  Returns 1 for a shape the
// kernel does not take.
extern "C" int relation_kd_plan_query(int BH, int L, int D, long long* out) {
  RelationPlan p;
  if (!relation_plan(BH, L, D, p)) return 1;
  out[0] = BI;
  out[1] = BJ;
  out[2] = p.splits;
  out[3] = p.per_split;
  out[4] = p.ws_floats;
  out[5] = p.counters;
  out[6] = p.ctas;
  return 0;
}

extern "C" int relation_kd_launch(const void* s, const void* t, void* out, void* part,
                                  long long part_floats, void* counters,
                                  long long n_counters, int BH, int L, int D,
                                  float temp, void* stream) {
  RelationPlan p;
  if (!relation_plan(BH, L, D, p) ||
      (p.splits > 1 && (part == nullptr || part_floats < p.ws_floats ||
                        counters == nullptr || n_counters < p.counters)))
    return (int)cudaErrorInvalidValue;
  const float *sf = (const float*)s, *tf = (const float*)t;
  float *of = (float*)out, *pf = (float*)part;
  unsigned* cf = (unsigned*)counters;
  const bool vec = D % 4 == 0 && (uintptr_t)s % 16 == 0 && (uintptr_t)t % 16 == 0;
  cudaStream_t st = (cudaStream_t)stream;
  return vec ? launch<true>(sf, tf, of, pf, cf, p, L, D, temp, BH, st)
             : launch<false>(sf, tf, of, pf, cf, p, L, D, temp, BH, st);
}
