// w2a8: y[M, N] = (q8(x) @ unpack(wp)) * (gamma/127 * delta)
//
// Replaces the TPU kernel repro/kernels/w2a8_gemv/kernel.py::w2a8_kernel.
// wp is uint8 [K/4, N], four ternary weights per byte packed little-endian
// along K (value + 1 in two bits).  q8 = clip(rint(x * (127/(gamma+1e-5))),
// -128, 127) with gamma the per-row absmax; products accumulate in int32, so
// the result is exact up to the final fp32 scale and matches the plain
// PyTorch version bit for bit.  The weight stays packed in device memory:
// the 2-bit format is what the model's memory claim rests on, so no route
// keeps an unpacked copy.
//
// Bound on the H100: the serving step calls it at two kinds of shape.  At
// decode rows (M <= 8) it reads K*N/4 weight bytes once and does 2*M*K*N
// integer operations, far below the card's rate: bound by the weight bytes,
// in practice by latency (0.2-0.9 us of bytes).  At a chunk step's rows (M
// = 8 x 32 = 256) the int8 operations (at 1979 TOP/s, on the tensor cores)
// and the bytes are both ~1 us.  So there are two routes, chosen by the
// wrapper on M (SPLIT_K_MAX_M below):
//
//   B. split-K (M <= SPLIT_K_MAX_M, one launch): a grid of column tiles x K
//      splits x row groups, sized to fill the SMs at every decode shape.  A
//      CTA of 4 warps owns 128 columns (4 per lane, one 32-bit load per
//      packed row) and one K slice: it takes gamma of its rows (the full-row
//      absmax; x is L2-resident at these M), quantizes only its slice into
//      shared memory, unpacks each byte into a char4 and uses __dp4a.  The
//      warps' sums meet in shared memory and go to an int32 workspace by
//      atomicAdd, exact and independent of order, so the result stays
//      bitwise.  The last CTA to arrive on a column tile (a counter) scales,
//      writes y and zeroes its workspace and counter again, so no memset
//      launch is needed between calls.
//   A. int8 wgmma (larger M, two launches): bitlinear's quantizing pass
//      writes the codes [M, Kp] and gamma into a buffer kept per stream,
//      then the GEMM of igemm_core.cuh runs on them.  Its B operand is made
//      in shared memory from the packed weight: a TMA warp keeps a ring of
//      stages in flight, each the codes tile and the packed tile [BK/4, BN]
//      (4 KB, read with the 128-byte swizzle so the unpackers' 16-byte reads
//      are conflict-free); a producer warpgroup turns each packed byte
//      (kp, n) into the 32-bit word of its four codes at K-major (n, 4kp ..
//      4kp+3), written at the 128-byte-swizzled address wgmma reads, then
//      fences the async proxy (wgmma reads what the generic proxy wrote)
//      and arrives on the stage's barrier.  The tensor maps are cached: the
//      packed weight's by pointer and shape, the codes buffer's by its
//      pointer, rows and pitch, so a call encodes none once warm.
//
// w2a8_forward_acc (w2a8_gemv_acc_launch): a row-parallel shard of the
// product under a tensor-parallel split.  x is the rank's K columns of the
// rows and wp the rank's K/4 packed rows; gamma [M] (the whole rows' absmax,
// maximized over the ranks) is given, and the entry returns the fp32
// accumulators acc[M, N] = q8(x) @ unpack(wp), unscaled: the int32 sums
// exactly (|acc| <= 128 K < 2^24), for the ranks to sum before the one
// scale (gamma/127) * delta.  The same two routes by M, stopping before the
// scale, each a separate instantiation (ACC / SCALE template flags, so the
// scaled kernels are unchanged): split-K reads gamma instead of taking the
// row absmax and writes the int32 sums as floats; the wgmma route's
// quantizing pass reads gamma and its epilogue runs with no scale.
#include "igemm_core.cuh"

#include <mutex>
#include <unordered_map>

extern "C" int bitlinear_quant_launch(const void* x, const void* gamma_in,
                                      void* gamma_out, void* codes, int M, int K,
                                      int Kp, int dtype, void* stream);

namespace {

using namespace igemm;

// M at and below which the wrapper takes the split-K route (the routes
// measure even at M = 8 with K = 1024 and split-K ahead at K >= 2048; the
// wgmma route ahead from M = 16 at every phase-2 shape)
constexpr int SPLIT_K_MAX_M = 8;

// Four ternary codes of one packed byte as four int8 in a word: byte i holds
// ((b >> 2i) & 3) - 1, as Q.unpack_ternary gives it.
__device__ __forceinline__ uint32_t unpack4(uint32_t b) {
  const uint32_t u = (b | (b << 6) | (b << 12) | (b << 18)) & 0x03030303u;
  return ((u | 0x80808080u) - 0x01010101u) ^ 0x80808080u;
}

// -- route B: split-K on dp4a -------------------------------------------------------

constexpr int SK_THREADS = 128;   // 4 warps
constexpr int SK_BN = 128;        // columns per CTA, 4 per lane
constexpr int SK_MR = 8;          // rows per CTA at most (grid.z groups the rows)
constexpr int SK_KQ = 16;         // a split's packed rows: a multiple (4 per warp step)
constexpr int SK_MAX_KPS = 256;   // packed rows per split at most (shared memory)
constexpr int SK_PRE = 8;         // packed rows a lane loads before the gamma pass
constexpr int SK_TARGET_CTAS = 264;

struct SplitPlan {
  int tiles, splits, kps, groups, mr;
};

// column tiles of 128, K splits of kps packed rows, row groups of mr rows;
// the workspace holds M*N sums, then one counter per (group, tile), at most
// M * ceil(N/128) ints (the wrapper allocates that bound)
SplitPlan splitk_plan(int M, int K, int N) {
  SplitPlan p;
  const int KP = K / 4;
  p.tiles = (N + SK_BN - 1) / SK_BN;
  p.mr = M <= 4 ? 4 : SK_MR;
  p.groups = (M + p.mr - 1) / p.mr;
  const int want = max(1, SK_TARGET_CTAS / (p.tiles * p.groups));
  int kps = (KP + want - 1) / want;
  kps = (kps + SK_KQ - 1) / SK_KQ * SK_KQ;
  p.kps = min(max(kps, SK_KQ), SK_MAX_KPS);
  p.splits = (KP + p.kps - 1) / p.kps;
  return p;
}

// The absmax of row xr (one warp; x is L2-resident at these M), keeping
// the row's elements [lo, hi) as floats in xs on the way.
template <typename T>
__device__ __forceinline__ float row_absmax(const T* __restrict__ xr, int K,
                                            int lane, int xvec, int lo, int hi,
                                            float* xs) {
  constexpr int V = 16 / sizeof(T);
  const int nv = xvec ? K / V : 0;
  float a = 0.0f;
#pragma unroll 4
  for (int c = lane; c < nv; c += 32) {
    float v[V];
    load16(xr + c * V, v);
#pragma unroll
    for (int e = 0; e < V; ++e) a = nan_max(a, fabsf(v[e]));
    if (c * V >= lo && c * V < hi) {   // lo is a multiple of V
#pragma unroll
      for (int e = 0; e < V; ++e) xs[c * V - lo + e] = v[e];
    }
  }
  for (int k = nv * V + lane; k < K; k += 32) {
    const float v = to_f32(xr[k]);
    a = nan_max(a, fabsf(v));
    if (k >= lo && k < hi) xs[k - lo] = v;
  }
  for (int off = 16; off > 0; off >>= 1)
    a = nan_max(a, __shfl_xor_sync(0xffffffffu, a, off));
  return a;
}

// the packed bytes of columns n .. n+3 of packed row kp as one word (zero
// bytes past N)
__device__ __forceinline__ uint32_t packed_word(const uint8_t* __restrict__ wp,
                                                int kp, int n, int N, int wvec) {
  const uint8_t* p = wp + (size_t)kp * N + n;
  if (wvec) return *reinterpret_cast<const uint32_t*>(p);
  uint32_t v = 0;
  for (int e = 0; e < 4 && n + e < N; ++e) v |= (uint32_t)p[e] << (8 * e);
  return v;
}

// acc[r][c] += the codes of packed rows kp .. kp+3 of row r against the
// four words w (one per packed row) of the lane's columns c = 0..3
template <int MR>
__device__ __forceinline__ void dp4a_step(int (&acc)[MR][4], const uint32_t (&w)[4],
                                          const int8_t* codes, int ks, int at) {
  uint32_t u[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) u[j][c] = unpack4((w[j] >> (8 * c)) & 0xffu);
#pragma unroll
  for (int r = 0; r < MR; ++r) {
    const int4 xc = *reinterpret_cast<const int4*>(codes + r * ks + at);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      acc[r][c] = __dp4a(xc.x, (int)u[0][c], acc[r][c]);
      acc[r][c] = __dp4a(xc.y, (int)u[1][c], acc[r][c]);
      acc[r][c] = __dp4a(xc.z, (int)u[2][c], acc[r][c]);
      acc[r][c] = __dp4a(xc.w, (int)u[3][c], acc[r][c]);
    }
  }
}

// ACC: a row shard's accumulators (gamma_in given, acc_out written, no scale)
template <typename T, int MR, bool ACC>
__global__ void __launch_bounds__(SK_THREADS)
w2a8_kernel_splitk(const T* __restrict__ x, const uint8_t* __restrict__ wp,
                   const float* __restrict__ delta, T* __restrict__ y,
                   int* __restrict__ ws, unsigned* __restrict__ counters, int M,
                   int K, int N, int kps, int xvec, int wvec,
                   const float* __restrict__ gamma_in, float* __restrict__ acc_out) {
  extern __shared__ __align__(16) uint8_t sk_smem[];
  int* red = reinterpret_cast<int*>(sk_smem);                       // [4][MR][SK_BN]
  float* xs = reinterpret_cast<float*>(red + 4 * MR * SK_BN);       // [MR][4 kps]
  int8_t* codes = reinterpret_cast<int8_t*>(xs + MR * 4 * kps);     // [MR][4 kps]
  __shared__ float gam[MR], inv[MR];
  __shared__ int last;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int KP = K >> 2, ks = 4 * kps;
  const int n0 = blockIdx.x * SK_BN, n = n0 + 4 * lane;
  const int kp0 = blockIdx.y * kps, kp1 = min(KP, kp0 + kps);
  const int m0 = blockIdx.z * MR, mr = min(MR, M - m0);
  // warp w: packed rows [kp0 + w*q, +q) of the slice, 4 a step (the codes
  // are zero past the slice's end, so the rows there add nothing)
  const int q = kps / 4, wa = kp0 + warp * q;

  // the lane's first packed words are in flight during the gamma pass
  uint32_t pre[SK_PRE];
#pragma unroll
  for (int j = 0; j < SK_PRE; ++j)
    pre[j] = n < N && j < q && wa + j < kp1 ? packed_word(wp, wa + j, n, N, wvec) : 0u;

  // gamma of the CTA's rows over the whole row (or the given one), keeping
  // the slice, then the slice's codes
  for (int r = warp; r < MR; r += 4) {
    float g = r < mr ? row_absmax(x + (size_t)(m0 + r) * K, K, lane, xvec,
                                  4 * kp0, 4 * kp1, xs + r * ks)
                     : 0.0f;
    if constexpr (ACC) {
      if (r < mr) g = gamma_in[m0 + r];
    }
    if (lane == 0) {
      gam[r] = g;
      inv[r] = 127.0f / (g + 1e-5f);
    }
  }
  __syncthreads();
  const int kn = 4 * (kp1 - kp0);
  for (int r = 0; r < MR; ++r) {
    for (int kk = tid; kk < ks; kk += SK_THREADS) {
      uint32_t c = 0;
      if (r < mr && kk < kn) c = q8(xs[r * ks + kk], inv[r]);
      codes[r * ks + kk] = (int8_t)c;
    }
  }
  __syncthreads();

  int acc[MR][4];
#pragma unroll
  for (int r = 0; r < MR; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0;
  if (n < N) {
#pragma unroll
    for (int i = 0; i < SK_PRE; i += 4) {
      const uint32_t w[4] = {pre[i], pre[i + 1], pre[i + 2], pre[i + 3]};
      if (i < q) dp4a_step<MR>(acc, w, codes, ks, 4 * (wa - kp0 + i));
    }
#pragma unroll 2
    for (int i = SK_PRE; i < q; i += 4) {
      uint32_t w[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        w[j] = wa + i + j < kp1 ? packed_word(wp, wa + i + j, n, N, wvec) : 0u;
      dp4a_step<MR>(acc, w, codes, ks, 4 * (wa - kp0 + i));
    }
  }
#pragma unroll
  for (int r = 0; r < MR; ++r)
    *reinterpret_cast<int4*>(red + (warp * MR + r) * SK_BN + 4 * lane) =
        make_int4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
  __syncthreads();

  // thread t owns column n0 + t: the 4 warps' sums, then one split's share
  const int nt = n0 + tid;
  const float d = ACC ? 1.0f : delta[0];
  if (gridDim.y == 1) {   // one split: the sums are whole
    for (int r = 0; r < mr && nt < N; ++r) {
      const int s = red[r * SK_BN + tid] + red[(MR + r) * SK_BN + tid] +
                    red[(2 * MR + r) * SK_BN + tid] + red[(3 * MR + r) * SK_BN + tid];
      const size_t at = (size_t)(m0 + r) * N + nt;
      if constexpr (ACC) acc_out[at] = (float)s;
      else y[at] = from_f32<T>((float)s * ((gam[r] / 127.0f) * d));
    }
    return;
  }
  for (int r = 0; r < mr && nt < N; ++r) {
    const int s = red[r * SK_BN + tid] + red[(MR + r) * SK_BN + tid] +
                  red[(2 * MR + r) * SK_BN + tid] + red[(3 * MR + r) * SK_BN + tid];
    atomicAdd(ws + (size_t)(m0 + r) * N + nt, s);
  }
  __threadfence();
  __syncthreads();
  unsigned* counter = counters + blockIdx.z * gridDim.x + blockIdx.x;
  if (tid == 0) last = atomicAdd(counter, 1u) == gridDim.y - 1;
  __syncthreads();
  if (!last) return;
  // the last split of this tile: every other split's sums have landed
  __threadfence();
  for (int r = 0; r < mr && nt < N; ++r) {
    int* p = ws + (size_t)(m0 + r) * N + nt;
    const int s = __ldcg(p);
    __stcg(p, 0);
    const size_t at = (size_t)(m0 + r) * N + nt;
    if constexpr (ACC) acc_out[at] = (float)s;
    else y[at] = from_f32<T>((float)s * ((gam[r] / 127.0f) * d));
  }
  if (tid == 0) *counter = 0u;
}

// ACC: the accumulators of a row shard into acc_out, gamma_in given (see the top)
template <typename T, int MR, bool ACC>
int splitk_t(const void* x, const void* wp, const void* delta, void* y, void* ws,
             int M, int K, int N, const SplitPlan& p, cudaStream_t stream,
             const float* gamma_in, float* acc_out) {
  static size_t allowed = 0;
  const size_t smem = (size_t)4 * MR * SK_BN * 4 + (size_t)MR * 4 * p.kps * 5;
  cudaError_t err = allow_smem(w2a8_kernel_splitk<T, MR, ACC>, smem, &allowed);
  if (err != cudaSuccess) return (int)err;
  constexpr int V = 16 / sizeof(T);
  const int xvec = (K % V == 0) && aligned16(x);
  const int wvec = (N % 4 == 0) && ((reinterpret_cast<uintptr_t>(wp) & 3) == 0);
  int* sums = (int*)ws;
  const dim3 grid(p.tiles, p.splits, p.groups);
  w2a8_kernel_splitk<T, MR, ACC><<<grid, SK_THREADS, smem, stream>>>(
      (const T*)x, (const uint8_t*)wp, (const float*)delta, (T*)y, sums,
      (unsigned*)(sums + (size_t)M * N), M, K, N, p.kps, xvec, wvec, gamma_in,
      acc_out);
  return (int)cudaGetLastError();
}

template <typename T>
int splitk(const void* x, const void* wp, const void* delta, void* y, void* ws,
           int M, int K, int N, cudaStream_t s, const float* gamma_in = nullptr,
           float* acc_out = nullptr) {
  const SplitPlan p = splitk_plan(M, K, N);
  if (acc_out != nullptr) {
    if (p.mr == 4)
      return splitk_t<T, 4, true>(x, wp, delta, y, ws, M, K, N, p, s, gamma_in, acc_out);
    return splitk_t<T, SK_MR, true>(x, wp, delta, y, ws, M, K, N, p, s, gamma_in,
                                    acc_out);
  }
  if (p.mr == 4)
    return splitk_t<T, 4, false>(x, wp, delta, y, ws, M, K, N, p, s, nullptr, nullptr);
  return splitk_t<T, SK_MR, false>(x, wp, delta, y, ws, M, K, N, p, s, nullptr,
                                   nullptr);
}

// -- route A: int8 wgmma, the B tile unpacked in shared memory ------------------------

constexpr int STAGES = 3;
constexpr int CONSUMERS = 1;                 // warpgroups of 64 rows
constexpr int BM = 64 * CONSUMERS;
constexpr int TILE_A = BM * BK, TILE_B = BN * BK, TILE_P = BK / 4 * BN;
constexpr int UNPACK0 = CONSUMERS * 4;       // first unpacking warp
constexpr int THREADS = 128 * CONSUMERS + 128 + 32;
constexpr int GEMM_SMEM = 1024 + STAGES * (TILE_A + TILE_B + TILE_P) + 3 * STAGES * 8;

static_assert(staged_bytes<CONSUMERS>() <= STAGES * (TILE_A + TILE_B), "");

// SCALE false: a row shard's accumulators, unscaled (gamma, delta not read)
template <typename T, bool SCALE>
__global__ void __launch_bounds__(THREADS, 2)
w2a8_kernel_gemm(const __grid_constant__ CUtensorMap tma_a,
                 const __grid_constant__ CUtensorMap tma_p,
                 const float* __restrict__ gamma, const float* __restrict__ delta,
                 T* __restrict__ y, int M, int N, int Kp) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  uint8_t* sA = smem;
  uint8_t* sB = sA + STAGES * TILE_A;
  uint8_t* sP = sB + STAGES * TILE_B;
  uint64_t* loaded = reinterpret_cast<uint64_t*>(sP + STAGES * TILE_P);
  uint64_t* full = loaded + STAGES;
  uint64_t* empty = full + STAGES;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int nk = Kp / BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&loaded[s], 1);              // the TMA warp, + the bytes
      mbar_init(&full[s], 4);                // lane 0 of each unpacking warp
      mbar_init(&empty[s], CONSUMERS * 4);   // lane 0 of each consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp == UNPACK0 + 4) {
    // TMA: one thread keeps up to STAGES stages (codes + packed tile) in flight
    if (lane == 0) {
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % STAGES, ph = (kt / STAGES) & 1;
        mbar_wait(&empty[s], ph ^ 1);
        mbar_expect_tx(&loaded[s], TILE_A + TILE_P);
        tma_load_2d(sA + s * TILE_A, &tma_a, kt * BK, m0, &loaded[s]);
        tma_load_2d(sP + s * TILE_P, &tma_p, n0, kt * (BK / 4), &loaded[s]);
      }
    }
    return;
  }

  if (warp >= UNPACK0) {
    // unpack: lane = packed row kp of the tile; warp u takes the 16-column
    // chunks 2u and 2u+1.  The packed tile is swizzled (chunk c of row kp at
    // c ^ (kp & 7)); the word of (kp, n) goes to row n, bytes 4kp .. 4kp+3,
    // in chunk (kp >> 2) ^ (n & 7): for one n the 32 lanes hit 32 banks.
    const int u = warp - UNPACK0;
    uint32_t off[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) off[j] = (((lane >> 2) ^ j) << 4) | ((lane & 3) << 2);
    for (int kt = 0; kt < nk; ++kt) {
      const int s = kt % STAGES, ph = (kt / STAGES) & 1;
      mbar_wait(&loaded[s], ph);
      const uint8_t* src = sP + s * TILE_P + lane * BN;
      uint8_t* dst = sB + s * TILE_B;
#pragma unroll
      for (int cc = 0; cc < 2; ++cc) {
        const int c = 2 * u + cc;
        const uint4 v = *reinterpret_cast<const uint4*>(src + ((c ^ (lane & 7)) << 4));
        const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const uint32_t b = (w[j >> 2] >> (8 * (j & 3))) & 0xffu;
          *reinterpret_cast<uint32_t*>(dst + (16 * c + j) * BK + off[j & 7]) = unpack4(b);
        }
      }
      fence_proxy_async();
      __syncwarp();
      if (lane == 0) mbar_arrive(&full[s]);
    }
    return;
  }

  // consumers: warpgroup wg owns rows wg*64 .. wg*64+63 of the tile
  int acc[64];
  mainloop<STAGES, TILE_A, TILE_B>(acc, sA, sB, full, loaded, empty, nk,
                                   warp >> 2, lane);
  epilogue<T, CONSUMERS, SCALE>(acc, smem, gamma, delta, y, M, N, m0, n0, warp,
                                lane);
}

struct MapKey {
  const void* base;
  int rows, cols, box;
  bool operator==(const MapKey& o) const {
    return base == o.base && rows == o.rows && cols == o.cols && box == o.box;
  }
};
struct MapKeyHash {
  size_t operator()(const MapKey& k) const {
    return std::hash<const void*>()(k.base) ^ ((size_t)k.rows * 0x9E3779B1u) ^
           ((size_t)k.cols << 20) ^ (size_t)k.box;
  }
};

// A tensor map encoded once per (base, rows, cols, box rows) and kept; a
// freed and reused pointer with the same shape gives the same map.
bool cached_map(CUtensorMap* out, const void* base, int rows, int cols, int box) {
  static std::mutex mu;
  static std::unordered_map<MapKey, CUtensorMap, MapKeyHash> cache;
  const MapKey key{base, rows, cols, box};
  std::lock_guard<std::mutex> lock(mu);
  auto it = cache.find(key);
  if (it != cache.end()) {
    *out = it->second;
    return true;
  }
  if (cache.size() >= 4096) cache.clear();
  if (!swizzled_map(out, base, rows, cols, box)) return false;
  cache.emplace(key, *out);
  return true;
}

// the codes buffer: gamma [rows_cap] fp32 first, the codes [rows_cap, Kp]
// 1024 bytes further on
size_t codes_offset(int rows_cap) { return ((size_t)4 * rows_cap + 1023) / 1024 * 1024; }

// SCALE false: the accumulators of a row shard into y (T = float), the codes
// quantized with the given gamma_in and no scale in the epilogue
template <typename T, bool SCALE = true>
int gemm(const void* x, const void* wp, const void* delta, void* y, int M, int K,
         int N, int dtype, void* scratch, int rows_cap, cudaStream_t stream,
         const float* gamma_in = nullptr) {
  static size_t allowed = 0;
  const int Kp = (K + BK - 1) / BK * BK;
  float* gamma = (float*)scratch;
  int8_t* codes = (int8_t*)scratch + codes_offset(rows_cap);
  int err = bitlinear_quant_launch(x, gamma_in, SCALE ? gamma : nullptr, codes, M, K,
                                   Kp, dtype, (void*)stream);
  if (err != 0) return err;
  CUtensorMap ma, mp;
  if (!cached_map(&ma, codes, rows_cap, Kp, BM) ||
      !cached_map(&mp, wp, K / 4, N, BK / 4))
    return (int)cudaErrorInvalidValue;
  cudaError_t e = allow_smem(w2a8_kernel_gemm<T, SCALE>, GEMM_SMEM, &allowed);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  w2a8_kernel_gemm<T, SCALE><<<grid, THREADS, GEMM_SMEM, stream>>>(
      ma, mp, gamma, (const float*)delta, (T*)y, M, N, Kp);
  return (int)cudaGetLastError();
}

}  // namespace

// The route threshold and the GEMM's tiles: out[0..5] = SPLIT_K_MAX_M, BM,
// BN, BK, STAGES, GEMM_SMEM.
extern "C" void w2a8_gemv_info(long long* out) {
  out[0] = SPLIT_K_MAX_M;
  out[1] = BM;
  out[2] = BN;
  out[3] = BK;
  out[4] = STAGES;
  out[5] = GEMM_SMEM;
}

// route 0 (split-K): ws holds at least M*N + M*ceil(N/128) int32, all zero
// (the kernel leaves them zero again).  route 1 (wgmma): N % 16 == 0 and wp
// 16-byte aligned; scratch holds the codes buffer of rows_cap >= M rows
// (codes_offset(rows_cap) + rows_cap * Kp bytes, Kp = K rounded up to 128).
extern "C" int w2a8_gemv_launch(const void* x, const void* wp, const void* delta,
                                void* y, int M, int K, int N, int dtype, int route,
                                void* scratch, int rows_cap, void* ws,
                                void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (M <= 0 || N <= 0 || K <= 0 || K % 4 != 0) return (int)cudaErrorInvalidValue;
  if (route == 0) {
    if (dtype == DT_F32) return splitk<float>(x, wp, delta, y, ws, M, K, N, s);
    if (dtype == DT_BF16) return splitk<__nv_bfloat16>(x, wp, delta, y, ws, M, K, N, s);
    return (int)cudaErrorInvalidValue;
  }
  if (route != 1 || N % 16 != 0 || !aligned16(wp) || rows_cap < M)
    return (int)cudaErrorInvalidValue;
  if (dtype == DT_F32) return gemm<float>(x, wp, delta, y, M, K, N, dtype, scratch, rows_cap, s);
  if (dtype == DT_BF16)
    return gemm<__nv_bfloat16>(x, wp, delta, y, M, K, N, dtype, scratch, rows_cap, s);
  return (int)cudaErrorInvalidValue;
}

// w2a8_forward_acc: x [M, K] (a row shard's columns), wp [K/4, N], gamma_in
// [M] fp32 -> acc [M, N] fp32, the unscaled sums (see the top); route, scratch,
// rows_cap and ws as for w2a8_gemv_launch.
extern "C" int w2a8_gemv_acc_launch(const void* x, const void* wp,
                                    const void* gamma_in, void* acc, int M, int K,
                                    int N, int dtype, int route, void* scratch,
                                    int rows_cap, void* ws, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (M <= 0 || N <= 0 || K <= 0 || K % 4 != 0 || gamma_in == nullptr)
    return (int)cudaErrorInvalidValue;
  const float* g = (const float*)gamma_in;
  if (route == 0) {
    if (dtype == DT_F32)
      return splitk<float>(x, wp, nullptr, nullptr, ws, M, K, N, s, g, (float*)acc);
    if (dtype == DT_BF16)
      return splitk<__nv_bfloat16>(x, wp, nullptr, nullptr, ws, M, K, N, s, g,
                                   (float*)acc);
    return (int)cudaErrorInvalidValue;
  }
  if (route != 1 || N % 16 != 0 || !aligned16(wp) || rows_cap < M ||
      (dtype != DT_F32 && dtype != DT_BF16))
    return (int)cudaErrorInvalidValue;
  return gemm<float, false>(x, wp, nullptr, acc, M, K, N, dtype, scratch, rows_cap, s,
                            g);
}
