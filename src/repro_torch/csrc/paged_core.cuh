// Attention over the paged KV pools: the body shared by the paged decode
// kernel (paged_attention.cu, T = 1) and the paged prefill-chunk kernel
// (paged_prefill.cu).
//
// The problem of one (row b, kv-head h): R = T*g query rows (row r = j*g +
// gi for chunk token j, grouped head gi) attend, with an fp32 softmax,
//   1. the row's resident positions [0, min(start, L*bs)), read in place from
//      the pools through the block table (trie-shared prefix blocks too), and
//   2. the chunk's own K/V straight from the projection outputs, causally
//      (key c is seen by token j iff c <= j and c < lens);
// the chunk rows j < lens are written into the row's blocks, pad rows never.
//
// Bound on the H100: the resident K/V bytes of the live rows, read once.  At
// T*g = 64 query rows the work is ~2 operations per byte read, far below the
// bf16 ridge (~295), so the design is about bytes and parallelism:
//
//  * Only the valid query rows.  Row b computes rows r < lens[b]*g, in m16
//    tiles; rows j >= lens get zeros and no work.  Nothing reads them: the
//    engine samples position lens-1 of each row (serving/engine.py,
//    _chunk_step_impl), pad positions are never written to the pools, and
//    every later op on a pad position is per-token and its result dropped.
//  * The KV walk is split across CTAs (flash-decoding).  The grid is
//    (Hkv, B, NS * NRG): NS splits of SK resident keys each (SK a multiple
//    of 64, chosen by paged_plan from the table width L, at most 16 splits),
//    NRG row groups of 64 query rows.  A CTA walks its split's keys in tiles
//    of KT through a two-stage cp.async ring (16-byte copies of each key's
//    contiguous (block, head) row; the split's slice of the block table is
//    staged in shared memory once, so a load divides by bs once per key row,
//    never per element).  Its 4 warps take one m16 tile each, or, when the
//    row has fewer valid rows, split each tile's 16-key steps between them;
//    those warps merge their (m, z, acc) in shared memory in warp order.
//    With NS > 1 each CTA writes its fp32 partial (m, z, acc) to a
//    workspace and a second kernel (paged_merge, 8 query rows per CTA)
//    combines the splits in split order: deterministic.  A split past its
//    row's depth writes an empty partial (z = 0) and exits; so does the resident walk of an idle
//    row (block_tables[b, 0] == 0, the trash block: serving/paged.py), whose
//    output is its chunk's own attention, finite and discarded.
//  * Tensor cores for bf16 x bf16 (the serving configuration): Q·Kᵀ by
//    mma.sync m16n8k16 with ldmatrix from XOR-swizzled tiles, fp32
//    accumulators (bf16 products are exact, so only the summation order
//    differs from the plain version).  P stays in registers and feeds P·V
//    as the A operand, split into a bf16 high part and a bf16 low part
//    (p - hi), both multiplied with V and accumulated in fp32: one rounding
//    of P to bf16 would move the output by more than one bf16 ulp.  The
//    row statistics (max, sum, rescale) live in registers, reduced across
//    the four lanes that share a row.  Other dtype pairs (fp32 pools, mixed)
//    compute the same register tiles with fp32 CUDA-core FMAs from shared
//    memory (KT = 32), keeping the fp32 tolerance.
//  * Head dims 16, 32, 64, 128 and 256.  At 256 a thread's accumulators
//    alone are DH/8 x 4 = 128 fp32 registers, and holding the Q fragments as well
//    (DH/16 x 4 = 64 more) would leave too few of the 255 for the tile's
//    scores and addresses, so the tensor-core path reloads each Q fragment
//    from shared memory (ldmatrix, Q stays staged for the whole walk) next
//    to the K fragment it meets, instead of holding them all (kHoldQ).  The
//    shared memory stays under the 227 KB opt-in: bf16 Q 32 KB + ring
//    128 KB, fp32 Q 65 KB + ring 130 KB, plus the table slice.  A decode
//    row with g = 1 (MHA) fills one of the 16 rows of its m16 tile.  At 32
//    and 16 a bf16 key row holds 4 or 2 of the swizzle's 16-byte chunks
//    (pa_swz), DH = 16 has one k-step of Q·Kᵀ, not a pair, and a merge CTA
//    takes 16 rows so that it stays one whole warp (pa_merge_rows).  These
//    widths are the reduced configs' and only need to be right: the same
//    tiles, with most of a thread's registers unused.
//
// Reads and writes across CTAs.  The pool writes of a row are done once, by
// the CTA of row group 0 and of the split that holds position start (the
// split that also folds in the chunk's keys), from the chunk tile in shared
// memory as it lands.  Other CTAs of the same row
// read the pools concurrently, which is safe because
//   - resident reads are positions < start[b] and writes are positions
//     >= start[b]: disjoint slots, even inside one block;
//   - shared prefix blocks are never written (serving/paged.py: a shared
//     prefix ends on a block boundary, a request writes only blocks it owns);
//   - only the trash block is both read and written, by idle rows (which do
//     not read it here) and stalled rows, whose outputs are discarded.
// A decode row whose table does not cover idx has its write clamped into
// block L-1; the engine always cuts the table to cover every live row, and
// no live row is in that case.
#pragma once
#include <type_traits>
#include "common.cuh"

constexpr int PA_THREADS = 128;   // 4 warps
constexpr int PA_WARPS = PA_THREADS / 32;
constexpr int PA_ROWS = 64;       // query rows per row group: 4 m16 tiles
constexpr int PA_MAX_SPLITS = 16;
constexpr float PA_NEG = -2.0e38f;

// query rows per merge CTA: a row takes DH/8 threads (8 elements each), 8
// rows a CTA, 16 at DH = 16 so that the CTA is one whole warp
__host__ __device__ constexpr int pa_merge_rows(int dh) { return dh >= 32 ? 8 : 16; }
__host__ __device__ constexpr int pa_merge_chunks(int dh) { return PA_ROWS / pa_merge_rows(dh); }

struct PagedProblem {
  int B, Hkv, R, T, g, Dh, bs, L;
  int SK, NS, NRG, ntab;   // split keys, splits, row groups, table slice
  int QR;                  // query rows staged per CTA: min(64, R rounded to 16)
  float scale, softcap;
  int decode;              // 1: lens == 1, write clamped into block L-1
};

template <typename TQ, typename TC>
struct PagedArgs {
  const TQ* q;        // [B, Hkv, R, Dh]
  const TQ* kc;       // [B, Hkv, T, Dh]
  const TQ* vc;
  TC* kpool;          // [N, Hkv, bs, Dh]
  TC* vpool;
  const int* bt;      // [B, L]
  const int* start;   // [B]
  const int* lens;    // [B] (null for decode)
  TC* out;            // [B, Hkv, R, Dh]
  float* ws_acc;      // [B, Hkv, NRG, NS, 64, Dh] (null when NS == 1)
  float2* ws_mz;      // [B, Hkv, NRG, NS, 64]
};

template <typename TQ, typename TC, int DH>
struct PagedShape {
  static constexpr bool kMma =
      std::is_same<TQ, __nv_bfloat16>::value && std::is_same<TC, __nv_bfloat16>::value;
  // hold Q's fragments in registers for the whole walk (DH <= 128), or
  // reload each from shared memory where it is used (DH = 256)
  static constexpr bool kHoldQ = DH <= 128;
  static constexpr int KT = kMma ? 64 : 32;        // keys per tile
  static constexpr int EPC = 16 / (int)sizeof(TC);  // cache elements per 16 bytes
  static constexpr int QLD = kMma ? DH : DH + 4;    // Q row stride (bf16 / fp32)
  static constexpr int KLD = kMma ? DH : DH + EPC;  // K/V row stride
  static constexpr size_t tile_elems = (size_t)KT * KLD;
  static constexpr size_t ring_bytes = 2 * 2 * tile_elems * sizeof(TC);   // 2 stages x K, V
  static constexpr int MGW = (DH / 8 * 4 + 4) * 32;   // floats of one warp's merge slot
  static constexpr size_t merge_bytes = (size_t)(PA_WARPS - 1) * MGW * sizeof(float);
  // Q rows [qr][QLD], then the ring (or the warps' merge slots), then the
  // split's slice of the block table
  static __host__ __device__ size_t q_bytes(int qr) {
    return (size_t)qr * QLD * (kMma ? 2 : 4);
  }
  static __host__ __device__ size_t tab_offset(int qr) {
    return q_bytes(qr) + (ring_bytes > merge_bytes ? ring_bytes : merge_bytes);
  }
  static size_t bytes(int qr, int ntab) { return tab_offset(qr) + sizeof(int) * (size_t)ntab; }
};

// The XOR swizzle of a bf16 tile of DH columns: the physical 16-byte chunk
// of chunk c in row r, so that the 8 rows an ldmatrix reads at one chunk
// fall in distinct banks.  The pattern permutes the W = min(8, DH/8) chunks
// of a row and changes once per 128-byte line (8/W rows): c ^ (r & 7) for
// DH >= 64; at 32 and 16 (4 and 2 chunks a row) r & 7 would address past
// the row, so the line index is masked to the row's chunks.
template <int DH>
__host__ __device__ constexpr int pa_swz(int r, int c) {
  constexpr int W = DH / 8 < 8 ? DH / 8 : 8;
  return c ^ ((r / (8 / W)) & (W - 1));
}

// -- small PTX helpers ---------------------------------------------------------

__device__ __forceinline__ uint32_t pa_smem(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16-byte global -> shared copy; zero-fills the destination when !valid
__device__ __forceinline__ void pa_cp16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(pa_smem(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void pa_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void pa_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void pa_ldsm4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(pa_smem(p))
               : "memory");
}
__device__ __forceinline__ void pa_ldsm4t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(pa_smem(p))
               : "memory");
}

// d += a (16x16 bf16, row) * b (16x8 bf16, col), fp32 accumulators
__device__ __forceinline__ void pa_mma(float (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pa_pack(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// (x, y) -> bf16 pairs: high parts and the low parts x - hi(x), y - hi(y)
__device__ __forceinline__ void pa_split(float x, float y, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat16 hx = __float2bfloat16_rn(x), hy = __float2bfloat16_rn(y);
  hi = pa_pack(hx, hy);
  lo = pa_pack(__float2bfloat16_rn(x - __bfloat162float(hx)),
               __float2bfloat16_rn(y - __bfloat162float(hy)));
}

__device__ __forceinline__ float4 pa_ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 pa_ld4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ float2 pa_ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 pa_ld2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ void pa_st2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void pa_st2(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

__device__ __forceinline__ float pa_dot4(float4 a, float4 b, float s) {
  s = fmaf(a.x, b.x, s);
  s = fmaf(a.y, b.y, s);
  s = fmaf(a.z, b.z, s);
  return fmaf(a.w, b.w, s);
}

// -- the attention body ----------------------------------------------------------

template <typename TQ, typename TC, int DH>
__device__ __forceinline__ void paged_attend(const PagedArgs<TQ, TC>& a,
                                             const PagedProblem& p) {
  using S = PagedShape<TQ, TC, DH>;
  constexpr int KT = S::KT, NT = DH / 8, EPC = S::EPC;
  constexpr int CPR = DH / EPC;               // 16-byte chunks per key row
  extern __shared__ __align__(16) unsigned char pa_sm[];

  const int h = blockIdx.x, b = blockIdx.y;
  const int rg = blockIdx.z / p.NS, s = blockIdx.z - rg * p.NS;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int* btb = a.bt + (size_t)b * p.L;

  // this split's slice of the block table, read with the row's scalars
  int* tab = reinterpret_cast<int*>(pa_sm + S::tab_offset(p.QR));
  const int k_lo = s * p.SK, blk_lo = k_lo / p.bs;
  const int ntab = min(p.L, (k_lo + p.SK - 1) / p.bs + 1) - blk_lo;
  for (int i = tid; i < ntab; i += PA_THREADS) tab[i] = btb[blk_lo + i];
  const int start = a.start[b];
  const int nl = p.decode ? 1 : min(a.lens[b], p.T);   // valid chunk tokens
  const int nq = nl * p.g;                             // valid query rows
  const int r_lo = rg * PA_ROWS;
  const int nrow = min(PA_ROWS, nq - r_lo);
  const size_t bh = (size_t)b * p.Hkv + h;
  TC* ob = a.out + bh * p.R * DH;

  // pad rows of this group: zeros, written once
  if (s == 0) {
    const int z0 = max(r_lo, nq), z1 = min(r_lo + PA_ROWS, p.R);
    uint4* zp = reinterpret_cast<uint4*>(ob + (size_t)z0 * DH);
    for (int e = tid; e < (z1 - z0) * DH / EPC; e += PA_THREADS)
      zp[e] = make_uint4(0u, 0u, 0u, 0u);
  }
  if (nrow <= 0) return;

  const bool idle = btb[0] == 0;                       // table all trash
  const int nres = idle ? 0 : max(0, min(start, p.L * p.bs));
  const int k_hi = min(k_lo + p.SK, nres);
  const int n_res = max(0, k_hi - k_lo);
  const bool chunk = s == min(start / p.SK, p.NS - 1);
  const size_t ws_row = ((bh * p.NRG + rg) * p.NS + s) * PA_ROWS;
  if (n_res == 0 && !chunk) {                          // empty split
    for (int i = tid; i < nrow; i += PA_THREADS)
      a.ws_mz[ws_row + i] = make_float2(PA_NEG, 0.f);
    return;
  }
  const TQ* kcb = a.kc + bh * p.T * DH;
  const TQ* vcb = a.vc + bh * p.T * DH;

  // Q rows of the group; rows >= nrow zero
  const TQ* qb = a.q + (bh * p.R + r_lo) * DH;
  if constexpr (S::kMma) {
    __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(pa_sm);
    constexpr int QC = DH / 8;
    for (int e = tid; e < p.QR * QC; e += PA_THREADS) {
      const int r = e / QC, c = e - r * QC;
      const bool v = r < nrow;
      pa_cp16(Qs + r * DH + (pa_swz<DH>(r, c) << 3), qb + (v ? (size_t)r * DH + c * 8 : 0), v);
    }
  } else {
    float* Qs = reinterpret_cast<float*>(pa_sm);
    for (int e = tid; e < p.QR * DH; e += PA_THREADS) {
      const int r = e / DH, d = e - r * DH;
      Qs[r * S::QLD + d] = r < nrow ? to_f32(qb[(size_t)r * DH + d]) : 0.f;
    }
  }
  pa_commit();
  __syncthreads();                                     // the table slice

  TC* ring = reinterpret_cast<TC*>(pa_sm + S::q_bytes(p.QR));
  // element offset of 16-byte chunk c of key row i in a K or V tile
  auto kv_off = [](int i, int c) -> int {
    if constexpr (S::kMma) return i * DH + (pa_swz<DH>(i, c) << 3);
    else return i * S::KLD + c * EPC;
  };
  const int n_res_tiles = (n_res + KT - 1) / KT;
  const int ntiles = n_res_tiles + (chunk ? (nl + KT - 1) / KT : 0);

  auto load_tile = [&](int t, int st) {
    TC* Kd = ring + (size_t)(2 * st) * S::tile_elems;
    TC* Vd = Kd + S::tile_elems;
    if (t < n_res_tiles) {
      const int p0 = k_lo + t * KT;
      const int nk = min(KT, k_hi - p0);
      for (int e = tid; e < KT * CPR; e += PA_THREADS) {
        const int i = e / CPR, c = e - i * CPR;
        const bool v = i < nk;
        size_t o = 0;
        if (v) {
          const int pos = p0 + i, lb = pos / p.bs;
          o = (((size_t)tab[lb - blk_lo] * p.Hkv + h) * p.bs + (pos - lb * p.bs)) * DH + c * EPC;
        }
        pa_cp16(Kd + kv_off(i, c), a.kpool + o, v);
        pa_cp16(Vd + kv_off(i, c), a.vpool + o, v);
      }
    } else {
      const int c0 = (t - n_res_tiles) * KT;
      const int nk = min(KT, nl - c0);
      if constexpr (std::is_same<TQ, TC>::value) {
        for (int e = tid; e < KT * CPR; e += PA_THREADS) {
          const int i = e / CPR, c = e - i * CPR;
          const bool v = i < nk;
          const size_t o = v ? (size_t)(c0 + i) * DH + c * EPC : 0;
          pa_cp16(Kd + kv_off(i, c), kcb + o, v);
          pa_cp16(Vd + kv_off(i, c), vcb + o, v);
        }
      } else {
        // chunk keys rounded to the cache dtype, as the plain version reads
        // them back from the pools
        for (int e = tid; e < KT * DH; e += PA_THREADS) {
          const int i = e / DH, d = e - i * DH;
          const bool v = i < nk;
          const size_t o = (size_t)(c0 + i) * DH + d;
          const int so = kv_off(i, d / EPC) + d % EPC;
          Kd[so] = from_f32<TC>(v ? to_f32(kcb[o]) : 0.f);
          Vd[so] = from_f32<TC>(v ? to_f32(vcb[o]) : 0.f);
        }
      }
    }
  };

  // warp roles: mtv m16 tiles, kw warps per tile splitting its 16-key steps
  const int mtv = nrow > 32 ? 4 : (nrow > 16 ? 2 : 1);
  const int kw = PA_WARPS / mtv;
  const int mt = warp % mtv, kl = warp / mtv;
  const bool has_rows = mt * 16 < nrow;
  const int qr = lane >> 2, qc = lane & 3;
  const int row0 = mt * 16 + qr, row1 = row0 + 8;      // group-local rows
  const int tok0 = (r_lo + row0) / p.g, tok1 = (r_lo + row1) / p.g;

  float m0 = PA_NEG, m1 = PA_NEG, z0 = 0.f, z1 = 0.f;
  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  uint32_t qf[S::kMma && S::kHoldQ ? DH / 16 : 1][4];
  // lane's row and 16-byte column offset of Q's ldmatrix.x4 (k-step kk
  // reads chunk 2*kk + qcol); mt*16 + qrow < QR always
  const int qrow = mt * 16 + (lane & 7) + ((lane >> 3) & 1) * 8, qcol = lane >> 4;
  const __nv_bfloat16* Qsm = reinterpret_cast<const __nv_bfloat16*>(pa_sm);
  auto q_frag = [&](uint32_t (&r)[4], int kk) {
    const int c = 2 * kk + qcol;
    pa_ldsm4(r, Qsm + qrow * DH + (pa_swz<DH>(qrow, c) << 3));
  };

  load_tile(0, 0);
  pa_commit();
  for (int t = 0; t < ntiles; ++t) {
    if (t + 1 < ntiles) load_tile(t + 1, (t + 1) & 1);
    pa_commit();
    pa_wait<1>();                                      // Q and tile t landed
    __syncthreads();
    if (t >= n_res_tiles && rg == 0) {
      // the pool writes of the chunk rows j < lens, once per (b, h), from
      // the tile as it landed (rounded to the cache dtype): 16-byte stores,
      // no second read of the projection outputs
      const int c0 = (t - n_res_tiles) * KT;
      const TC* Ks = ring + (size_t)(2 * (t & 1)) * S::tile_elems;
      const TC* Vs = Ks + S::tile_elems;
      for (int e = tid; e < min(KT, nl - c0) * CPR; e += PA_THREADS) {
        const int i = e / CPR, c = e - i * CPR;
        const int pos = start + c0 + i;
        int lb = pos / p.bs;
        const int off = pos - lb * p.bs;
        if (lb > p.L - 1) {
          if (!p.decode) continue;
          lb = p.L - 1;
        }
        const size_t o = (((size_t)btb[lb] * p.Hkv + h) * p.bs + off) * DH + c * EPC;
        *reinterpret_cast<uint4*>(a.kpool + o) =
            *reinterpret_cast<const uint4*>(Ks + kv_off(i, c));
        *reinterpret_cast<uint4*>(a.vpool + o) =
            *reinterpret_cast<const uint4*>(Vs + kv_off(i, c));
      }
    }
    if (has_rows) {
      if constexpr (S::kMma && S::kHoldQ) {
        if (t == 0) {
#pragma unroll
          for (int kk = 0; kk < DH / 16; ++kk) q_frag(qf[kk], kk);
        }
      }
      const bool is_chunk = t >= n_res_tiles;
      const int key0 = is_chunk ? (t - n_res_tiles) * KT : 0;   // first chunk key
      const int nk = is_chunk ? min(KT, nl - key0) : min(KT, k_hi - (k_lo + t * KT));
      const TC* Kt = ring + (size_t)(2 * (t & 1)) * S::tile_elems;
      const TC* Vt = Kt + S::tile_elems;
      for (int c16 = kl; c16 * 16 < nk; c16 += kw) {
        float sc[2][4];
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) sc[n][e] = 0.f;
        if constexpr (S::kMma && S::kHoldQ) {
          // two accumulators per n-tile (even and odd k-steps): four
          // independent mma chains instead of two; DH = 16 has one k-step
          constexpr int KS = DH / 16;
          float sd[2][4];
#pragma unroll
          for (int n = 0; n < 2; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) sd[n][e] = 0.f;
          const int kr = c16 * 16 + (lane & 7) + ((lane >> 4) << 3);
#pragma unroll
          for (int kk = 0; kk + 1 < KS; kk += 2) {
            uint32_t kb[4], kd[4];
            pa_ldsm4(kb, Kt + kv_off(kr, 2 * kk + ((lane >> 3) & 1)));
            pa_ldsm4(kd, Kt + kv_off(kr, 2 * kk + 2 + ((lane >> 3) & 1)));
            pa_mma(sc[0], qf[kk], kb[0], kb[1]);
            pa_mma(sc[1], qf[kk], kb[2], kb[3]);
            pa_mma(sd[0], qf[kk + 1], kd[0], kd[1]);
            pa_mma(sd[1], qf[kk + 1], kd[2], kd[3]);
          }
          if constexpr (KS % 2) {
            uint32_t kb[4];
            pa_ldsm4(kb, Kt + kv_off(kr, 2 * (KS - 1) + ((lane >> 3) & 1)));
            pa_mma(sc[0], qf[KS - 1], kb[0], kb[1]);
            pa_mma(sc[1], qf[KS - 1], kb[2], kb[3]);
          }
#pragma unroll
          for (int n = 0; n < 2; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) sc[n][e] += sd[n][e];
        } else if constexpr (S::kMma) {
          // DH = 256: Q's fragment reloaded beside each K fragment, and one
          // accumulator per n-tile (the registers of the second pair are
          // what the held fragments would have spilled)
          const int kr = c16 * 16 + (lane & 7) + ((lane >> 4) << 3);
#pragma unroll
          for (int kk = 0; kk < DH / 16; ++kk) {
            uint32_t kb[4], qa[4];
            pa_ldsm4(kb, Kt + kv_off(kr, 2 * kk + ((lane >> 3) & 1)));
            q_frag(qa, kk);
            pa_mma(sc[0], qa, kb[0], kb[1]);
            pa_mma(sc[1], qa, kb[2], kb[3]);
          }
        } else {
          const float* Qs = reinterpret_cast<const float*>(pa_sm);
          const float* q0 = Qs + row0 * S::QLD;
          const float* q1 = Qs + row1 * S::QLD;
          const int kb = c16 * 16 + 2 * qc;
          const TC* k0 = Kt + kb * S::KLD;
          const TC* k1 = k0 + S::KLD;
          const TC* k2 = k0 + 8 * S::KLD;
          const TC* k3 = k0 + 9 * S::KLD;
#pragma unroll 4
          for (int d = 0; d < DH; d += 4) {
            const float4 x0 = pa_ld4(q0 + d), x1 = pa_ld4(q1 + d);
            const float4 y0 = pa_ld4(k0 + d), y1 = pa_ld4(k1 + d);
            const float4 y2 = pa_ld4(k2 + d), y3 = pa_ld4(k3 + d);
            sc[0][0] = pa_dot4(x0, y0, sc[0][0]);
            sc[0][1] = pa_dot4(x0, y1, sc[0][1]);
            sc[1][0] = pa_dot4(x0, y2, sc[1][0]);
            sc[1][1] = pa_dot4(x0, y3, sc[1][1]);
            sc[0][2] = pa_dot4(x1, y0, sc[0][2]);
            sc[0][3] = pa_dot4(x1, y1, sc[0][3]);
            sc[1][2] = pa_dot4(x1, y2, sc[1][2]);
            sc[1][3] = pa_dot4(x1, y3, sc[1][3]);
          }
        }
        // scale, softcap, mask; masked keys get weight exactly 0 below
        bool ok[2][4];
        float mx0 = PA_NEG, mx1 = PA_NEG;
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = c16 * 16 + n * 8 + 2 * qc + (e & 1);
            ok[n][e] = key < nk && (!is_chunk || key0 + key <= (e < 2 ? tok0 : tok1));
            float x = sc[n][e] * p.scale;
            if (p.softcap > 0.f) x = p.softcap * tanhf(x / p.softcap);
            sc[n][e] = ok[n][e] ? x : PA_NEG;
            if (e < 2) mx0 = fmaxf(mx0, sc[n][e]);
            else mx1 = fmaxf(mx1, sc[n][e]);
          }
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
        const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
        const float c0 = expf(m0 - mn0), c1 = expf(m1 - mn1);
        m0 = mn0;
        m1 = mn1;
        float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float w = ok[n][e] ? expf(sc[n][e] - (e < 2 ? mn0 : mn1)) : 0.f;
            sc[n][e] = w;
            if (e < 2) ps0 += w;
            else ps1 += w;
          }
        z0 = z0 * c0 + ps0;
        z1 = z1 * c1 + ps1;
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          acc[n][0] *= c0;
          acc[n][1] *= c0;
          acc[n][2] *= c1;
          acc[n][3] *= c1;
        }
        // P·V over these 16 keys
        if constexpr (S::kMma) {
          uint32_t ph[4], pl[4];
          pa_split(sc[0][0], sc[0][1], ph[0], pl[0]);
          pa_split(sc[0][2], sc[0][3], ph[1], pl[1]);
          pa_split(sc[1][0], sc[1][1], ph[2], pl[2]);
          pa_split(sc[1][2], sc[1][3], ph[3], pl[3]);
          const int vr = c16 * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
          for (int np = 0; np < NT / 2; ++np) {
            uint32_t vb[4];
            pa_ldsm4t(vb, Vt + kv_off(vr, 2 * np + (lane >> 4)));
            pa_mma(acc[2 * np], ph, vb[0], vb[1]);
            pa_mma(acc[2 * np], pl, vb[0], vb[1]);
            pa_mma(acc[2 * np + 1], ph, vb[2], vb[3]);
            pa_mma(acc[2 * np + 1], pl, vb[2], vb[3]);
          }
        } else {
#pragma unroll
          for (int k = 0; k < 16; ++k) {
            const int src = (lane & ~3) | ((k & 7) >> 1);
            const float pa = __shfl_sync(0xffffffffu, sc[k >> 3][k & 1], src);
            const float pb = __shfl_sync(0xffffffffu, sc[k >> 3][2 + (k & 1)], src);
            const TC* vr = Vt + (c16 * 16 + k) * S::KLD + 2 * qc;
#pragma unroll
            for (int n = 0; n < NT; ++n) {
              const float2 v = pa_ld2(vr + 8 * n);
              acc[n][0] = fmaf(pa, v.x, acc[n][0]);
              acc[n][1] = fmaf(pa, v.y, acc[n][1]);
              acc[n][2] = fmaf(pb, v.x, acc[n][2]);
              acc[n][3] = fmaf(pb, v.y, acc[n][3]);
            }
          }
        }
      }
    }
    __syncthreads();                                   // stage t&1 is free
  }
  pa_wait<0>();

  // row sums over the four lanes of a row
  z0 += __shfl_xor_sync(0xffffffffu, z0, 1);
  z0 += __shfl_xor_sync(0xffffffffu, z0, 2);
  z1 += __shfl_xor_sync(0xffffffffu, z1, 1);
  z1 += __shfl_xor_sync(0xffffffffu, z1, 2);

  // the kw warps of an m-tile merge into its first, in warp order
  if (kw > 1) {
    float* mg = reinterpret_cast<float*>(pa_sm + S::q_bytes(p.QR));
    if (kl > 0 && has_rows) {
      float* w = mg + (warp - 1) * S::MGW;
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) w[(n * 4 + e) * 32 + lane] = acc[n][e];
      w[(NT * 4 + 0) * 32 + lane] = m0;
      w[(NT * 4 + 1) * 32 + lane] = m1;
      w[(NT * 4 + 2) * 32 + lane] = z0;
      w[(NT * 4 + 3) * 32 + lane] = z1;
    }
    __syncthreads();
    if (kl == 0 && has_rows) {
      for (int j = 1; j < kw; ++j) {
        const float* w = mg + (warp + j * mtv - 1) * S::MGW;
        const float mb0 = w[(NT * 4 + 0) * 32 + lane], mb1 = w[(NT * 4 + 1) * 32 + lane];
        const float mn0 = fmaxf(m0, mb0), mn1 = fmaxf(m1, mb1);
        const float ca0 = expf(m0 - mn0), cb0 = expf(mb0 - mn0);
        const float ca1 = expf(m1 - mn1), cb1 = expf(mb1 - mn1);
        z0 = z0 * ca0 + w[(NT * 4 + 2) * 32 + lane] * cb0;
        z1 = z1 * ca1 + w[(NT * 4 + 3) * 32 + lane] * cb1;
        m0 = mn0;
        m1 = mn1;
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          acc[n][0] = acc[n][0] * ca0 + w[(n * 4 + 0) * 32 + lane] * cb0;
          acc[n][1] = acc[n][1] * ca0 + w[(n * 4 + 1) * 32 + lane] * cb0;
          acc[n][2] = acc[n][2] * ca1 + w[(n * 4 + 2) * 32 + lane] * cb1;
          acc[n][3] = acc[n][3] * ca1 + w[(n * 4 + 3) * 32 + lane] * cb1;
        }
      }
    }
  }
  if (kl != 0 || !has_rows) return;

  const bool v0 = row0 < nrow, v1 = row1 < nrow;
  if (a.ws_acc == nullptr) {                           // one split: finish here
    TC* o0 = ob + (size_t)(r_lo + row0) * DH + 2 * qc;
    TC* o1 = ob + (size_t)(r_lo + row1) * DH + 2 * qc;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      if (v0) pa_st2(o0 + 8 * n, acc[n][0] / z0, acc[n][1] / z0);
      if (v1) pa_st2(o1 + 8 * n, acc[n][2] / z1, acc[n][3] / z1);
    }
  } else {                                             // the split's partial
    float* w0 = a.ws_acc + (ws_row + row0) * DH + 2 * qc;
    float* w1 = a.ws_acc + (ws_row + row1) * DH + 2 * qc;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      if (v0) pa_st2(w0 + 8 * n, acc[n][0], acc[n][1]);
      if (v1) pa_st2(w1 + 8 * n, acc[n][2], acc[n][3]);
    }
    if (qc == 0) {
      if (v0) a.ws_mz[ws_row + row0] = make_float2(m0, z0);
      if (v1) a.ws_mz[ws_row + row1] = make_float2(m1, z1);
    }
  }
}

// The splits' partials of one (row, kv-head) combined in split order,
// pa_merge_rows(DH) query rows per CTA: each thread weighs its row's splits
// itself (e^(m - M) over the splits with z > 0; splits past the row's depth
// carry z = 0) and combines 8 head-dim elements of that row.
template <typename TQ, typename TC, int DH>
__device__ __forceinline__ void paged_merge(const PagedArgs<TQ, TC>& a,
                                            const PagedProblem& p) {
  constexpr int TPR = DH / 8;                          // threads per row
  constexpr int MR = pa_merge_rows(DH), MC = pa_merge_chunks(DH);
  const int h = blockIdx.x, b = blockIdx.y;
  const int rg = blockIdx.z / MC;
  const int i = (blockIdx.z - rg * MC) * MR + threadIdx.x / TPR;
  const int d = (threadIdx.x % TPR) * 8;
  const int nl = p.decode ? 1 : min(a.lens[b], p.T);
  if (i >= min(PA_ROWS, nl * p.g - rg * PA_ROWS)) return;
  const size_t bh = (size_t)b * p.Hkv + h;
  const size_t base = (bh * p.NRG + rg) * p.NS * PA_ROWS + i;
  float M = PA_NEG;
  for (int s = 0; s < p.NS; ++s) {
    const float2 mz = a.ws_mz[base + (size_t)s * PA_ROWS];
    if (mz.y > 0.f) M = fmaxf(M, mz.x);
  }
  float Z = 0.f, acc[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) acc[k] = 0.f;
  for (int s = 0; s < p.NS; ++s) {
    const size_t r = base + (size_t)s * PA_ROWS;
    const float2 mz = a.ws_mz[r];
    if (mz.y > 0.f) {
      const float e = expf(mz.x - M);
      Z = fmaf(mz.y, e, Z);
      const float4 x = pa_ld4(a.ws_acc + r * DH + d);
      const float4 y = pa_ld4(a.ws_acc + r * DH + d + 4);
      acc[0] = fmaf(x.x, e, acc[0]);
      acc[1] = fmaf(x.y, e, acc[1]);
      acc[2] = fmaf(x.z, e, acc[2]);
      acc[3] = fmaf(x.w, e, acc[3]);
      acc[4] = fmaf(y.x, e, acc[4]);
      acc[5] = fmaf(y.y, e, acc[5]);
      acc[6] = fmaf(y.z, e, acc[6]);
      acc[7] = fmaf(y.w, e, acc[7]);
    }
  }
  TC* o = a.out + (bh * p.R + rg * PA_ROWS + i) * DH + d;
#pragma unroll
  for (int k = 0; k < 8; k += 2) pa_st2(o + k, acc[k] / Z, acc[k + 1] / Z);
}

// Host side: launch the attention kernel and, with more than one split, the
// merge kernel, on `stream`.  Returns a CUDA error code (0 on success).
template <typename TQ, typename TC, int DH, typename KA, typename KM>
static int paged_launch_dh(KA attend, KM merge, size_t* allowed,
                           const PagedArgs<TQ, TC>& a, const PagedProblem& p,
                           cudaStream_t stream) {
  const size_t smem = PagedShape<TQ, TC, DH>::bytes(p.QR, p.ntab);
  cudaError_t err = allow_smem(attend, smem, allowed);
  if (err != cudaSuccess) return (int)err;
  attend<<<dim3(p.Hkv, p.B, p.NS * p.NRG), PA_THREADS, smem, stream>>>(a, p);
  err = cudaGetLastError();
  if (err != cudaSuccess || p.NS == 1) return (int)err;
  merge<<<dim3(p.Hkv, p.B, p.NRG * pa_merge_chunks(DH)), pa_merge_rows(DH) * DH / 8, 0,
          stream>>>(a, p);
  return (int)cudaGetLastError();
}

// The plan of a launch, from host-known shapes only (no device sync): SK
// resident keys per split, 128 for decode (T == 1) and 256 for a chunk (its
// fp32 partials, up to 64 rows x Dh, then cost a quarter of the split's
// resident K/V bytes), grown in steps of 64 so that there are at most
// PA_MAX_SPLITS; then the splits, row groups, table slice and staged query
// rows.  False for a shape the kernels do not take.  The wrappers read the
// plan through paged_plan_query (paged_attention.cu).
static inline bool paged_plan(PagedProblem& p) {
  if (p.B < 1 || p.R < 1 || p.T < 1 || p.bs < 1 || p.L < 1) return false;
  if (p.Dh != 16 && p.Dh != 32 && p.Dh != 64 && p.Dh != 128 && p.Dh != 256) return false;
  const long long keys = (long long)p.L * p.bs;
  const long long grown = (keys + PA_MAX_SPLITS * 64 - 1) / (PA_MAX_SPLITS * 64) * 64;
  const long long base = p.T == 1 ? 128 : 256;
  p.SK = (int)(grown > base ? grown : base);
  p.NS = (int)((keys + p.SK - 1) / p.SK);
  p.NRG = (p.R + PA_ROWS - 1) / PA_ROWS;
  p.ntab = (p.SK - 1) / p.bs + 2;
  p.QR = p.R < PA_ROWS ? (p.R + 15) / 16 * 16 : PA_ROWS;
  return p.NRG * p.NS <= 65535 && p.NRG * pa_merge_chunks(p.Dh) <= 65535;
}

// fp32 floats of the splits' partials: acc [B, Hkv, NRG, NS, 64, Dh], then
// (m, z) [B, Hkv, NRG, NS, 64]; none with one split.
static inline long long paged_workspace_floats(const PagedProblem& p) {
  if (p.NS == 1) return 0;
  return (long long)p.B * p.Hkv * p.NRG * p.NS * PA_ROWS * (p.Dh + 2);
}

// Points acc and (m, z) into the caller's workspace `ws` of `ws_floats`
// floats; false when it cannot hold the plan's partials.
static inline bool paged_workspace(const PagedProblem& p, void* ws, long long ws_floats,
                                   float** acc, float2** mz) {
  const long long need = paged_workspace_floats(p);
  *acc = nullptr;
  *mz = nullptr;
  if (need == 0) return true;
  if (ws == nullptr || ws_floats < need) return false;
  *acc = (float*)ws;
  *mz = (float2*)(*acc + need / (p.Dh + 2) * p.Dh);
  return true;
}
