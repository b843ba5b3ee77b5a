// Attention over the paged KV pools for one (row, kv-head): the body shared
// by the paged decode kernel (T = 1) and the paged prefill-chunk kernel.
//
// One CTA per (row b, kv-head h).  Its R = T*g query rows (row r = j*g + gi,
// chunk token j, grouped head gi) attend, with an fp32 online softmax,
//   1. the row's resident positions [0, min(start, L*bs)), read in place from
//      the pools through the block table (trie-shared prefix blocks too), and
//   2. the chunk's own K/V straight from the projection outputs, causally
//      (key c is seen by token j iff c <= j and c < lens).
// Only then, after a barrier, are the chunk rows j < lens written into the
// row's blocks: the first written block can hold resident positions that
// this CTA reads, so every read must be done before any write.  Pad rows
// j >= lens are never written.
//
// Keys go in tiles of KT through shared memory as fp32 (rows padded to Dh+1
// floats so lanes reading different keys hit different banks).  Scores use
// LP lanes per (query row, key) pair, chosen so all 256 threads work even
// for a decode row (R = g); the context accumulators live in registers, ACC
// per thread, so up to ACC*256 / Dh query rows form one row group and larger
// chunks loop over row groups.
#pragma once
#include "common.cuh"

constexpr int PA_THREADS = 256;
constexpr int PA_ACC = 32;        // fp32 context accumulators per thread
constexpr int PA_KT = 32;         // keys per tile
constexpr int PA_SLD = PA_KT + 1; // padded row stride of the probability tile
constexpr float PA_NEG_INF = -2.0e38f;

struct PagedProblem {
  int Hkv, R, T, g, Dh, bs, L, RG;
  float scale, softcap;
};

// Dynamic shared memory of one CTA, in bytes.
static inline size_t paged_smem_bytes(int RG, int Dh) {
  const size_t ld = (size_t)Dh + 1;
  return sizeof(float) * (RG * ld + 2 * PA_KT * ld + (size_t)RG * PA_SLD + 3 * (size_t)RG);
}

template <typename TQ, typename TC>
__device__ __forceinline__ void paged_attend(
    const TQ* __restrict__ q,      // [B, Hkv, R, Dh]
    const TQ* __restrict__ kc,     // [B, Hkv, T, Dh]
    const TQ* __restrict__ vc,     // [B, Hkv, T, Dh]
    TC* __restrict__ kpool,        // [N, Hkv, bs, Dh]
    TC* __restrict__ vpool,
    const int* __restrict__ bt,    // [B, L]
    const int b, const int start, const int lens, const bool clamp_write,
    TC* __restrict__ out,          // [B, Hkv, R, Dh]
    const PagedProblem p) {
  extern __shared__ __align__(16) float sm[];
  const int h = blockIdx.x;
  const int tid = threadIdx.x;
  const int Dh = p.Dh, ld = p.Dh + 1;
  float* Qs = sm;
  float* Ks = Qs + p.RG * ld;
  float* Vs = Ks + PA_KT * ld;
  float* S = Vs + PA_KT * ld;
  float* mrow = S + p.RG * PA_SLD;
  float* zrow = mrow + p.RG;
  float* crow = zrow + p.RG;

  const size_t bh = (size_t)b * p.Hkv + h;
  const TQ* qb = q + bh * p.R * Dh;
  const TQ* kcb = kc + bh * p.T * Dh;
  const TQ* vcb = vc + bh * p.T * Dh;
  TC* ob = out + bh * p.R * Dh;
  const int* btb = bt + (size_t)b * p.L;
  const int nl = min(lens, p.T);                   // valid chunk rows
  const int nres = max(0, min(start, p.L * p.bs));  // resident keys, all < start
  const int n_res_tiles = (nres + PA_KT - 1) / PA_KT;
  const int n_tiles = n_res_tiles + (p.T + PA_KT - 1) / PA_KT;

  for (int r0 = 0; r0 < p.R; r0 += p.RG) {
    const int rg = min(p.RG, p.R - r0);
    __syncthreads();                               // previous group is done
    for (int e = tid; e < rg * Dh; e += PA_THREADS) {
      const int r = e / Dh, d = e - r * Dh;
      Qs[r * ld + d] = to_f32(qb[(size_t)(r0 + r) * Dh + d]);
    }
    for (int r = tid; r < rg; r += PA_THREADS) {
      mrow[r] = PA_NEG_INF;
      zrow[r] = 0.f;
    }
    float acc[PA_ACC];
#pragma unroll
    for (int k = 0; k < PA_ACC; ++k) acc[k] = 0.f;

    for (int t = 0; t < n_tiles; ++t) {
      const bool chunk = t >= n_res_tiles;
      const int c0 = (chunk ? t - n_res_tiles : t) * PA_KT;   // first key
      const int nk = min(PA_KT, (chunk ? p.T : nres) - c0);
      __syncthreads();                             // tile buffers are free
      for (int e = tid; e < nk * Dh; e += PA_THREADS) {
        const int j = e / Dh, d = e - j * Dh;
        float kv, vv;
        if (chunk) {
          const size_t o = (size_t)(c0 + j) * Dh + d;
          kv = to_f32(kcb[o]);
          vv = to_f32(vcb[o]);
        } else {
          const int pos = c0 + j;
          const size_t blk = (size_t)btb[pos / p.bs];
          const size_t o = ((blk * p.Hkv + h) * p.bs + pos % p.bs) * Dh + d;
          kv = to_f32(kpool[o]);
          vv = to_f32(vpool[o]);
        }
        Ks[j * ld + d] = kv;
        Vs[j * ld + d] = vv;
      }
      __syncthreads();

      // scores, LP lanes per (row, key) pair, reduced by shuffles
      const int P = rg * nk;
      int LP = 1;
      while (LP < 32 && P * LP * 2 <= PA_THREADS) LP *= 2;
      const int slots = PA_THREADS / LP;
      for (int base = 0; base < P; base += slots) {
        const int pi = base + tid / LP, sub = tid % LP;
        float part = 0.f;
        int r = 0, j = 0;
        if (pi < P) {
          r = pi / nk;
          j = pi - r * nk;
          const float* qr = Qs + r * ld;
          const float* kr = Ks + j * ld;
          for (int d = sub; d < Dh; d += LP) part += qr[d] * kr[d];
        }
        for (int off = LP >> 1; off > 0; off >>= 1)
          part += __shfl_xor_sync(0xffffffffu, part, off);
        if (pi < P && sub == 0) {
          float s = part * p.scale;
          if (p.softcap > 0.f) s = p.softcap * tanhf(s / p.softcap);
          const bool valid = !chunk || (c0 + j <= (r0 + r) / p.g && c0 + j < nl);
          S[r * PA_SLD + j] = valid ? s : PA_NEG_INF;
        }
      }
      __syncthreads();

      // online-softmax statistics, one thread per query row; masked keys get
      // weight exactly 0 (not exp of a huge negative), so a tile with no
      // valid key leaves the carry untouched
      for (int r = tid; r < rg; r += PA_THREADS) {
        float* Sr = S + r * PA_SLD;
        float mx = mrow[r];
        for (int j = 0; j < nk; ++j) mx = fmaxf(mx, Sr[j]);
        const float c = expf(mrow[r] - mx);
        float z = zrow[r] * c;
        for (int j = 0; j < nk; ++j) {
          const bool valid = !chunk || (c0 + j <= (r0 + r) / p.g && c0 + j < nl);
          const float e = valid ? expf(Sr[j] - mx) : 0.f;
          Sr[j] = e;
          z += e;
        }
        mrow[r] = mx;
        zrow[r] = z;
        crow[r] = c;
      }
      __syncthreads();

#pragma unroll
      for (int k = 0; k < PA_ACC; ++k) {
        const int e = tid + k * PA_THREADS;
        if (e < rg * Dh) {
          const int r = e / Dh, d = e - r * Dh;
          const float* Sr = S + r * PA_SLD;
          float a = acc[k] * crow[r];
          for (int j = 0; j < nk; ++j) a += Sr[j] * Vs[j * ld + d];
          acc[k] = a;
        }
      }
    }

#pragma unroll
    for (int k = 0; k < PA_ACC; ++k) {
      const int e = tid + k * PA_THREADS;
      if (e < rg * Dh) {
        const int r = e / Dh, d = e - r * Dh;
        ob[(size_t)(r0 + r) * Dh + d] = from_f32<TC>(acc[k] / fmaxf(zrow[r], 1e-30f));
      }
    }
  }

  // every read of the pools by this CTA is done: scatter the chunk rows
  __syncthreads();
  for (int e = tid; e < nl * Dh; e += PA_THREADS) {
    const int j = e / Dh, d = e - j * Dh;
    const int pos = start + j;
    int lb = pos / p.bs;
    if (lb > p.L - 1) {
      if (!clamp_write) continue;
      lb = p.L - 1;
    }
    const size_t blk = (size_t)btb[lb];
    const size_t o = ((blk * p.Hkv + h) * p.bs + pos % p.bs) * Dh + d;
    const size_t c = (size_t)j * Dh + d;
    kpool[o] = from_f32<TC>(to_f32(kcb[c]));
    vpool[o] = from_f32<TC>(to_f32(vcb[c]));
  }
}

// Host side: query rows per row group, so RG * Dh accumulators fit the CTA.
static inline int paged_row_group(int R, int Dh) {
  const int cap = PA_ACC * PA_THREADS / Dh;
  return R < cap ? R : cap;
}
