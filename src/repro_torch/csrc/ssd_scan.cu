// ssd_scan: the Mamba2 SSD chunked scan, y and the final state per (b, h).
//
// Replaces the TPU kernel repro/kernels/ssd_scan/kernel.py::ssd_scan_kernel.
// For one batch row b and head h, over chunks of Q steps (Q divides S):
//
//   la      = cumsum(log(max(a, 1e-20)))                       (fp32)
//   y_q     = sum_{k<=q} (C_q.B_k) exp(la_q - la_k) dt_k x_k   (intra-chunk)
//           + exp(la_q) C_q . h_prev                            (off-diagonal)
//   h_next  = h_prev exp(la_last) + sum_k B_k (dt_k exp(la_last - la_k)) x_k
//
// with h [N, P] carried from chunk to chunk and written out after the last.
// Operands are in the model's layout: x, y [b, S, H, P]; a, dt [b, S, H];
// B, C [b, S, N], shared by the H heads of a batch row.  The TPU kernel's
// [BH, S, P] layout is the case H = 1.
//
// Bound on the H100: the function needs, per (bh, chunk), Q(Q+1)*P
// operations for the causal half of M.x and 2*Q*N*P each for C.h and the
// state update, plus, per (b, chunk), Q(Q+1)*N for the causal half of
// C.B^T: ~9.8 GFLOP at the training shape (b = 8, H = 48, S = 512, Q =
// 256, N = 128, P = 64), against ~0.12 GB of operands.  fp32 FMAs (67
// TFLOP/s) would take 0.146 ms; the tensor cores take fp32 only as TF32 (10
// mantissa bits), which misses the 1e-4 tolerance, so every product here
// is 3xTF32 on mma.sync m16n8k8 (tf32_core.cuh): v = hi + lo with hi the
// top 10 mantissa bits of v and lo those of v - hi (bit masks, no
// conversion instruction), a.b = a_lo.b_hi + a_hi.b_lo + a_hi.b_hi, about
// fp32's precision at three TF32 products (3 x 9.8 GFLOP at 495 TFLOP/s:
// ~0.06 ms).
//
// Design: the stages of kernels/ssd_scan/ref.py::ssd_stages in three
// launches from one C entry, their intermediates in a workspace:
//   1+2. ssd_kernel_prep, two kinds of block in one grid:
//      la: per (b, chunk, 16 heads), the logs in parallel, the in-chunk
//      cumsum la summed in sequence order by one thread per head (a
//      reordered sum moves la_q - la_k by ~1e-4 where la reaches -500), then
//      the state weights dt*exp(la_last - la), dt and exp(la_last), [bh, S]
//      (or [bh, chunks]) for the later stages;
//      C.B^T: once per (b, chunk), its causal 64 x 64 tiles only, shared by
//      the heads;
//   3+4. ssd_kernel_state: per (bh, 64 state rows), the chunks in order, the
//      state in the warps' accumulators: h_in of each chunk written out for
//      stage 5, then h = h exp(la_last) + B^T (weights * x) over the chunk's
//      keys in tiles of 32, the next tile loaded into registers while the
//      current one is multiplied; the final h written last;
//   5. ssd_kernel_out: per (bh, chunk, 64 query rows), y = exp(la_q)
//      C_q.h_in (skipped in the first chunk, whose h_in is zero) + the sum
//      over key tiles of 64 at or below the diagonal of M.x, with M = C.B^T *
//      exp(la_q - la_k) * dt_k built in the A fragments, masked (k > q -> 0)
//      before the exponential is taken (above the diagonal it can be inf;
//      the backward's plain recompute keeps the same masking).
// Each warp owns 16 output rows; operand tiles are staged in shared memory
// with row pitches chosen so every fragment load hits 32 banks, and the B
// operand every warp of a CTA reads is split into its TF32 parts once, as
// it is staged.  expf and logf are the accurate functions, not the fast
// intrinsics.
#include "tf32_core.cuh"

namespace {

constexpr int THREADS = 128;   // 4 warps
constexpr int HG = 16;         // heads per stage-1 CTA
constexpr int QT = 64;         // query rows per stage-2 and stage-5 tile
constexpr int KT5 = 64;        // keys per stage-5 tile
constexpr int KT3 = 32;        // keys per stage-3 tile

// -- 1. la and the per-step factors ------------------------------------------------------

// heads [h0, h0 + 16) of chunk c of batch row bi; shared memory 2 * Q *
// (HG + 1) floats
__device__ __forceinline__ void la_block(const float* __restrict__ a,
                                         const float* __restrict__ dt,
                                         float* __restrict__ la,
                                         float* __restrict__ wst,
                                         float* __restrict__ dtt,
                                         float* __restrict__ dec, int S, int H,
                                         int Q, int h0, int c, int bi, float* sm1) {
  constexpr int LD = HG + 1;
  float* lg = sm1;             // [Q][LD]
  float* ds = sm1 + Q * LD;    // [Q][LD]
  const int hn = min(HG, H - h0), s0 = c * Q, nc = S / Q;
  const int tid = threadIdx.x;
  for (int i0 = 0; i0 < Q * HG; i0 += 8 * THREADS) {   // 8 loads in flight
    float va[8], vd[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int i = i0 + u * THREADS + tid, q = i / HG, j = i % HG;
      va[u] = vd[u] = 0.0f;
      if (i < Q * HG && j < hn) {
        const size_t at = ((size_t)bi * S + s0 + q) * H + h0 + j;
        va[u] = a[at];
        vd[u] = dt[at];
      }
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int i = i0 + u * THREADS + tid, q = i / HG, j = i % HG;
      if (i < Q * HG) {
        lg[q * LD + j] = j < hn ? logf(fmaxf(va[u], 1e-20f)) : 0.0f;
        ds[q * LD + j] = vd[u];
      }
    }
  }
  __syncthreads();
  // la = cumsum(log a), left to right in one thread per head: the order of
  // the plain version's (and PyTorch's outer-dimension) scan
  if (tid < hn) {
    float run = 0.0f;
    int q = 0;
    for (; q + 8 <= Q; q += 8) {   // 8 loads in flight, then the 8 adds in order
      float v[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) v[i] = lg[(q + i) * LD + tid];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        run += v[i];
        lg[(q + i) * LD + tid] = run;
      }
    }
    for (; q < Q; ++q) {
      run += lg[q * LD + tid];
      lg[q * LD + tid] = run;
    }
  }
  __syncthreads();
  for (int i = tid; i < Q * HG; i += THREADS) {
    const int j = i / Q, q = i % Q;
    if (j >= hn) continue;
    const int bh = bi * H + h0 + j;
    const float l = lg[q * LD + j], last = lg[(Q - 1) * LD + j];
    const size_t at = (size_t)bh * S + s0 + q;
    la[at] = l;
    wst[at] = ds[q * LD + j] * expf(last - l);
    dtt[at] = ds[q * LD + j];
    if (q == Q - 1) dec[(size_t)bh * nc + c] = expf(last);
  }
}

// -- 2. C.B^T per (b, chunk) ------------------------------------------------------------

// the CB buffer's row pitch: Q rounded up to 4 floats, so rows are 16-byte
// aligned
__host__ __device__ constexpr int cb_pitch(int Q) { return (Q + 3) / 4 * 4; }

// causal tile `tile` (of T(T+1)/2, T = ceil(Q / 64)) of chunk c of batch
// row bi; the CB buffer is [b, chunks, Q, cb_pitch(Q)]; entries above the
// diagonal of a diagonal tile, and the pitch's pad, are written or left but
// never read; shared memory 2 * 64 * (N + 4) floats
template <int N>
__device__ __forceinline__ void cb_block(const float* __restrict__ Bm,
                                         const float* __restrict__ Cm,
                                         float* __restrict__ cb, int S, int Q,
                                         int tile, int c, int bi, float* sm2) {
  constexpr int LD = N + 4;   // g*LD + t hits 32 banks
  float* Cs = sm2;            // [QT][LD] query rows
  float* Bs = sm2 + QT * LD;  // [QT][LD] key rows
  int qi = 0, rem = tile;
  while (rem > qi) rem -= ++qi;
  const int ki = rem;         // tile (qi, ki), ki <= qi
  const int nc = S / Q;
  const int q0 = qi * QT, k0 = ki * QT;
  const float* Cb = Cm + ((size_t)bi * S + (size_t)c * Q) * N;
  const float* Bb = Bm + ((size_t)bi * S + (size_t)c * Q) * N;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  for (int i = tid; i < QT * N / 4; i += THREADS) {
    const int r = i / (N / 4), n4 = (i % (N / 4)) * 4;
    float4 cv = make_float4(0.f, 0.f, 0.f, 0.f), bv = cv;
    if (q0 + r < Q) cv = *reinterpret_cast<const float4*>(Cb + (size_t)(q0 + r) * N + n4);
    if (k0 + r < Q) bv = *reinterpret_cast<const float4*>(Bb + (size_t)(k0 + r) * N + n4);
    float* cd = Cs + r * LD + n4;
    float* bd = Bs + r * LD + n4;
    cd[0] = cv.x; cd[1] = cv.y; cd[2] = cv.z; cd[3] = cv.w;
    bd[0] = bv.x; bd[1] = bv.y; bd[2] = bv.z; bd[3] = bv.w;
  }
  __syncthreads();
  float acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
  const float* ar = Cs + (16 * warp + g) * LD;
#pragma unroll 2
  for (int kk = 0; kk < N; kk += 8) {
    const float af[4] = {ar[kk + t], ar[8 * LD + kk + t], ar[kk + t + 4],
                         ar[8 * LD + kk + t + 4]};
    uint32_t ah[4], al[4];
    split4(af, ah, al);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float* br = Bs + (8 * j + g) * LD + kk + t;
      const float bf[2] = {br[0], br[4]};
      mma3(acc[j], ah, al, bf);
    }
  }
  const int Qp = cb_pitch(Q);
  float* out = cb + ((size_t)bi * nc + c) * Q * Qp;
  const int r0 = q0 + 16 * warp + g;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = k0 + 8 * j + 2 * t;   // even, and Qp a multiple of 4
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + 8 * h;
      if (r < Q && col < Qp)
        *reinterpret_cast<float2*>(out + (size_t)r * Qp + col) =
            make_float2(acc[j][2 * h], acc[j][2 * h + 1]);
    }
  }
}

// Stages 1 and 2 in one launch (neither reads the other): the first
// ceil(H/16) * chunks * b blocks take la, the rest the causal C.B^T tiles
// (grid T(T+1)/2 * chunks * b); dynamic shared memory the larger of the two.
template <int N>
__global__ void __launch_bounds__(THREADS)
ssd_kernel_prep(const float* __restrict__ a, const float* __restrict__ dt,
                const float* __restrict__ Bm, const float* __restrict__ Cm,
                float* __restrict__ la, float* __restrict__ wst,
                float* __restrict__ dtt, float* __restrict__ dec,
                float* __restrict__ cb, int batch, int S, int H, int Q) {
  extern __shared__ __align__(16) float sm0[];
  const int nc = S / Q, hgs = (H + HG - 1) / HG, tq = (Q + QT - 1) / QT;
  const int x = blockIdx.x, n_la = hgs * nc * batch;
  if (x < n_la) {
    la_block(a, dt, la, wst, dtt, dec, S, H, Q, (x % hgs) * HG, (x / hgs) % nc,
             x / (hgs * nc), sm0);
  } else {
    const int y = x - n_la, tiles = tq * (tq + 1) / 2;
    cb_block<N>(Bm, Cm, cb, S, Q, y % tiles, (y / tiles) % nc, y / (tiles * nc), sm0);
  }
}

// -- 3 + 4. chunk states and their carry ---------------------------------------------------

// a float4 as its TF32 high and low parts
__device__ __forceinline__ void split_store(uint32_t* hi, uint32_t* lo, float4 v) {
  uint4 h, l;
  split(v.x, h.x, l.x);
  split(v.y, h.y, l.y);
  split(v.z, h.z, l.z);
  split(v.w, h.w, l.w);
  *reinterpret_cast<uint4*>(hi) = h;
  *reinterpret_cast<uint4*>(lo) = l;
}

// A CTA owns ROWS state rows (N = 128: half of them, so a bh is two CTAs)
// and all P columns; its 4 warps split the row tiles first (16 rows x P a
// warp at ROWS = 64; N = P = 16: one 16 x 8 tile a warp, warps 2 and 3
// idle).
template <int N, int P>
struct StateTiles {
  static constexpr int ROWS = N < 64 ? N : 64;
  static constexpr int WM = ROWS / 16, WN = P / 8;
  static constexpr int WARPS_M = WM < 4 ? WM : 4, WARPS_N = 4 / WARPS_M;
  static constexpr int MT = WM / WARPS_M;
  static constexpr int NT = (WN + WARPS_N - 1) / WARPS_N;
  static constexpr int BV = KT3 * ROWS / 4 / THREADS;   // float4 a thread stages
  static constexpr int XV = KT3 * P / 4 / THREADS;
  static_assert(BV * 4 * THREADS == KT3 * ROWS && XV * 4 * THREADS == KT3 * P, "");
};

// grid (b * H, N / ROWS); h_in [bh, chunks, N, P] (chunk 0's is zero and
// not written), hout [bh, N, P].  The next key tile is loaded into
// registers while the current one is multiplied; the weighted x tile, the
// B operand every warp reads, is split into TF32 parts once, as it is
// staged.
template <int N, int P>
__global__ void __launch_bounds__(THREADS)
ssd_kernel_state(const float* __restrict__ x, const float* __restrict__ Bm,
                 const float* __restrict__ wst, const float* __restrict__ dec,
                 float* __restrict__ hin, float* __restrict__ hout, int S, int H,
                 int Q) {
  using ST = StateTiles<N, P>;
  constexpr int R = ST::ROWS;
  constexpr int LDB = R + 8, LDX = P + 8;   // t*LD + g hits 32 banks
  __shared__ __align__(16) float Bs[KT3 * LDB];       // [key][n - n0]
  __shared__ __align__(16) uint32_t Xh[KT3 * LDX];    // [key][p], weighted, hi
  __shared__ __align__(16) uint32_t Xl[KT3 * LDX];    // and lo
  const int bh = blockIdx.x, bi = bh / H, hi = bh % H, nc = S / Q;
  const int n0 = blockIdx.y * R;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp % ST::WARPS_M, wn = warp / ST::WARPS_M;
  const size_t row = (size_t)H * P;
  const float* xb = x + (size_t)bi * S * row + (size_t)hi * P;
  const float* Bb = Bm + (size_t)bi * S * N + n0;
  const float* wb = wst + (size_t)bh * S;

  float acc[ST::MT][ST::NT][4];
#pragma unroll
  for (int i = 0; i < ST::MT; ++i)
#pragma unroll
    for (int j = 0; j < ST::NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;

  // acc element (i, j, e) is h[n][p] with n = n0 + 16*(wm*MT + i) + g +
  // 8*(e/2), p = 8*(wn*NT + j) + 2t + e%2
  auto store = [&](float* dst) {
#pragma unroll
    for (int i = 0; i < ST::MT; ++i)
#pragma unroll
      for (int j = 0; j < ST::NT; ++j) {
        const int jt = wn * ST::NT + j;
        if (jt >= ST::WN) continue;
        const int n = n0 + 16 * (wm * ST::MT + i) + g, p = 8 * jt + 2 * t;
        *reinterpret_cast<float2*>(dst + (size_t)n * P + p) =
            make_float2(acc[i][j][0], acc[i][j][1]);
        *reinterpret_cast<float2*>(dst + (size_t)(n + 8) * P + p) =
            make_float2(acc[i][j][2], acc[i][j][3]);
      }
  };

  float4 nb[ST::BV], nx[ST::XV];
  float nw[ST::XV];
  auto fetch = [&](int s0, int k0) {
#pragma unroll
    for (int i = 0; i < ST::BV; ++i) {
      const int at = tid + i * THREADS, r = at / (R / 4), c4 = (at % (R / 4)) * 4;
      nb[i] = k0 + r < Q ? *reinterpret_cast<const float4*>(Bb + (size_t)(s0 + k0 + r) * N + c4)
                         : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int i = 0; i < ST::XV; ++i) {
      const int at = tid + i * THREADS, r = at / (P / 4), c4 = (at % (P / 4)) * 4;
      const bool in = k0 + r < Q;
      nx[i] = in ? *reinterpret_cast<const float4*>(xb + (size_t)(s0 + k0 + r) * row + c4)
                 : make_float4(0.f, 0.f, 0.f, 0.f);
      nw[i] = in ? wb[s0 + k0 + r] : 0.0f;
    }
  };
  auto stage = [&]() {
#pragma unroll
    for (int i = 0; i < ST::BV; ++i) {
      const int at = tid + i * THREADS, r = at / (R / 4), c4 = (at % (R / 4)) * 4;
      *reinterpret_cast<float4*>(Bs + r * LDB + c4) = nb[i];
    }
#pragma unroll
    for (int i = 0; i < ST::XV; ++i) {
      const int at = tid + i * THREADS, r = at / (P / 4), c4 = (at % (P / 4)) * 4;
      const float4 v = make_float4(nx[i].x * nw[i], nx[i].y * nw[i], nx[i].z * nw[i],
                                   nx[i].w * nw[i]);
      split_store(Xh + r * LDX + c4, Xl + r * LDX + c4, v);
    }
  };

  const int tiles = (Q + KT3 - 1) / KT3;
  fetch(0, 0);
  for (int c = 0; c < nc; ++c) {
    if (c > 0) {
      store(hin + ((size_t)bh * nc + c) * N * P);
      const float d = dec[(size_t)bh * nc + c];
#pragma unroll
      for (int i = 0; i < ST::MT; ++i)
#pragma unroll
        for (int j = 0; j < ST::NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][j][e] *= d;
    }
    for (int kt = 0; kt < tiles; ++kt) {
      __syncthreads();   // the last tile's fragments are read
      stage();
      __syncthreads();
      if (kt + 1 < tiles) fetch(c * Q, (kt + 1) * KT3);
      else if (c + 1 < nc) fetch((c + 1) * Q, 0);
#pragma unroll
      for (int kk = 0; kk < KT3; kk += 8) {
        uint32_t ah[ST::MT][4], al[ST::MT][4];
#pragma unroll
        for (int i = 0; i < ST::MT; ++i) {
          // A = B^T: A[n][k] = Bs[k][n]
          const float* bp = Bs + (kk + t) * LDB + 16 * (wm * ST::MT + i) + g;
          const float af[4] = {bp[0], bp[8], bp[4 * LDB], bp[4 * LDB + 8]};
          split4(af, ah[i], al[i]);
        }
#pragma unroll
        for (int j = 0; j < ST::NT; ++j) {
          const int jt = wn * ST::NT + j;
          if (jt >= ST::WN) continue;
          const int o = (kk + t) * LDX + 8 * jt + g;
#pragma unroll
          for (int i = 0; i < ST::MT; ++i)
            mma3s(acc[i][j], ah[i], al[i], Xh[o], Xh[o + 4 * LDX], Xl[o], Xl[o + 4 * LDX]);
        }
      }
    }
  }
  store(hout + (size_t)bh * N * P);
}

// -- 5. the output ---------------------------------------------------------------------

// The A operand tile (C rows, or C.B^T) [QT][LDA] and the split B operand
// tile (h_in rows, or x rows) [BR][P + 8] twice, hi and lo; the
// off-diagonal product walks N in passes of NH columns.
template <int N, int P>
struct OutTiles {
  static constexpr int NH = N < 64 ? N : 64;
  static constexpr int BR = KT5 > NH ? KT5 : NH;
  static constexpr int LDA = (KT5 > NH ? KT5 : NH) + 4;   // g*LDA + t hits 32 banks
  static constexpr int LDB = P + 8;                       // t*LDB + g hits 32 banks
};

template <int N, int P>
__host__ __device__ constexpr int out_smem_floats() {
  return QT * OutTiles<N, P>::LDA + 2 * OutTiles<N, P>::BR * OutTiles<N, P>::LDB;
}

// grid (ceil(Q / 64), chunks, b * H); dynamic shared memory
// out_smem_floats + 2 * Q floats (la and dt of the chunk): 56 KB at N =
// 128, P = 64, Q = 256, so four CTAs share an SM
template <int N, int P>
__global__ void __launch_bounds__(THREADS)
ssd_kernel_out(const float* __restrict__ x, const float* __restrict__ Cm,
               const float* __restrict__ cb, const float* __restrict__ la,
               const float* __restrict__ dtt,
               const float* __restrict__ hin, float* __restrict__ y, int S,
               int H, int Q) {
  using OT = OutTiles<N, P>;
  constexpr int NT = P / 8, LDA = OT::LDA, LDB = OT::LDB;
  extern __shared__ __align__(16) float sm5[];
  float* As = sm5;                                                // [QT][LDA]
  uint32_t* Bh = reinterpret_cast<uint32_t*>(sm5 + QT * LDA);      // [BR][LDB]
  uint32_t* Bl = Bh + OT::BR * LDB;
  float* la_s = sm5 + out_smem_floats<N, P>();
  float* dt_s = la_s + Q;
  const int tq = gridDim.x - 1 - blockIdx.x;   // heavy (late) query tiles first
  const int c = blockIdx.y, bh = blockIdx.z, bi = bh / H, hi = bh % H;
  const int nc = S / Q, s0 = c * Q, q0 = tq * QT, Qp = cb_pitch(Q);
  const int kend = min(q0 + QT, Q);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const size_t row = (size_t)H * P;
  const float* xb = x + ((size_t)bi * S + s0) * row + (size_t)hi * P;
  float* yb = y + ((size_t)bi * S + s0) * row + (size_t)hi * P;
  for (int i = tid; i < kend; i += THREADS) {
    const size_t at = (size_t)bh * S + s0 + i;
    la_s[i] = la[at];
    dt_s[i] = dtt[at];
  }

  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
  const int r0 = 16 * warp + g;            // the lane's rows r0 and r0 + 8 of the tile
  const int qa = q0 + r0, qb = qa + 8;     // as chunk positions

  // rows [0, rows) of the B tile from src (row pitch `pitch`, rows past
  // `valid` zero), split
  auto stage_b = [&](const float* src, size_t pitch, int rows, int valid) {
    for (int i = tid; i < rows * P / 4; i += THREADS) {
      const int r = i / (P / 4), p4 = (i % (P / 4)) * 4;
      const float4 v = r < valid ? *reinterpret_cast<const float4*>(src + (size_t)r * pitch + p4)
                                 : make_float4(0.f, 0.f, 0.f, 0.f);
      split_store(Bh + r * LDB + p4, Bl + r * LDB + p4, v);
    }
  };
  // acc += A[tile rows][kk .. kk+ksteps*8) B, A's fragments from `af`
  auto step = [&](const float (&af)[4], int kk) {
    uint32_t ah[4], al[4];
    split4(af, ah, al);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int o = (kk + t) * LDB + 8 * j + g;
      mma3s(acc[j], ah, al, Bh[o], Bh[o + 4 * LDB], Bl[o], Bl[o + 4 * LDB]);
    }
  };

  if (c > 0) {
    // exp(la_q) * (C_q . h_in), over N in passes of NH columns
    const float* Cb = Cm + ((size_t)bi * S + s0) * N;
    const float* hb = hin + ((size_t)bh * nc + c) * N * P;
    for (int nh = 0; nh < N; nh += OT::NH) {
      __syncthreads();   // the last pass's tiles are read
      for (int i = tid; i < QT * OT::NH / 4; i += THREADS) {
        const int r = i / (OT::NH / 4), n4 = (i % (OT::NH / 4)) * 4;
        const float4 v = q0 + r < Q
            ? *reinterpret_cast<const float4*>(Cb + (size_t)(q0 + r) * N + nh + n4)
            : make_float4(0.f, 0.f, 0.f, 0.f);
        *reinterpret_cast<float4*>(As + r * LDA + n4) = v;
      }
      stage_b(hb + (size_t)nh * P, P, OT::NH, OT::NH);
      __syncthreads();
      const float* ar = As + r0 * LDA;
#pragma unroll 2
      for (int kk = 0; kk < OT::NH; kk += 8) {
        const float af[4] = {ar[kk + t], ar[8 * LDA + kk + t], ar[kk + t + 4],
                             ar[8 * LDA + kk + t + 4]};
        step(af, kk);
      }
    }
    const float e0 = qa < Q ? expf(la_s[qa]) : 0.0f;
    const float e1 = qb < Q ? expf(la_s[qb]) : 0.0f;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      acc[j][0] *= e0; acc[j][1] *= e0;
      acc[j][2] *= e1; acc[j][3] *= e1;
    }
  }

  // intra-chunk: key tiles at or below the diagonal
  const float* cbb = cb + ((size_t)bi * nc + c) * Q * Qp;
  for (int k0 = 0; k0 < kend; k0 += KT5) {
    __syncthreads();   // the previous phase's tiles are read, la_s is written
    for (int i = tid; i < QT * KT5 / 4; i += THREADS) {
      const int r = i / (KT5 / 4), k4 = (i % (KT5 / 4)) * 4;
      const float4 v = q0 + r < Q && k0 + k4 < Qp
          ? *reinterpret_cast<const float4*>(cbb + (size_t)(q0 + r) * Qp + k0 + k4)
          : make_float4(0.f, 0.f, 0.f, 0.f);
      *reinterpret_cast<float4*>(As + r * LDA + k4) = v;
    }
    stage_b(xb + (size_t)k0 * row, row, KT5, Q - k0);
    __syncthreads();
    const float la_a = qa < Q ? la_s[qa] : 0.0f, la_b = qb < Q ? la_s[qb] : 0.0f;
    const float* mr = As + r0 * LDA;
    // keys past the warp's last row are all masked: the warp stops there
    const int kn = min(min(KT5, kend - k0), q0 + 16 * warp + 16 - k0);
#pragma unroll 2
    for (int kk = 0; kk < kn; kk += 8) {
      // M = C.B^T * exp(la_q - la_k) * dt_k where k <= q < Q, else 0 (the
      // pad and the entries above the diagonal are never multiplied)
      const int ka = k0 + kk + t, kb = ka + 4;
      float af[4] = {0.f, 0.f, 0.f, 0.f};
      if (ka <= qa && qa < Q) af[0] = mr[kk + t] * expf(la_a - la_s[ka]) * dt_s[ka];
      if (ka <= qb && qb < Q) af[1] = mr[8 * LDA + kk + t] * expf(la_b - la_s[ka]) * dt_s[ka];
      if (kb <= qa && qa < Q) af[2] = mr[kk + t + 4] * expf(la_a - la_s[kb]) * dt_s[kb];
      if (kb <= qb && qb < Q) af[3] = mr[8 * LDA + kk + t + 4] * expf(la_b - la_s[kb]) * dt_s[kb];
      step(af, kk);
    }
  }
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int p = 8 * j + 2 * t;
    if (qa < Q)
      *reinterpret_cast<float2*>(yb + (size_t)qa * row + p) = make_float2(acc[j][0], acc[j][1]);
    if (qb < Q)
      *reinterpret_cast<float2*>(yb + (size_t)qb * row + p) = make_float2(acc[j][2], acc[j][3]);
  }
}

// -- host side -----------------------------------------------------------------------------

struct Workspace {
  float *la, *wst, *dtt, *dec, *cb, *hin;
  size_t floats;
};

Workspace carve(float* base, int batch, int S, int H, int P, int N, int Q) {
  const size_t bh = (size_t)batch * H, nc = S / Q;
  Workspace w;
  size_t at = 0;
  auto take = [&](size_t n) {
    float* p = base ? base + at : nullptr;
    at += (n + 63) / 64 * 64;   // 256-byte aligned pieces
    return p;
  };
  w.la = take(bh * S);
  w.wst = take(bh * S);
  w.dtt = take(bh * S);
  w.dec = take(bh * nc);
  w.cb = take((size_t)batch * nc * Q * cb_pitch(Q));
  w.hin = take(bh * nc * N * P);
  w.floats = at;
  return w;
}

template <int N, int P>
int launch(const float* x, const float* a, const float* dt, const float* B,
           const float* C, float* y, float* hout, float* ws, int batch, int S,
           int H, int Q, cudaStream_t stream) {
  static size_t allowed0 = 0, allowed5 = 0;
  const size_t la_floats = (size_t)2 * Q * (HG + 1), cb_floats = (size_t)2 * QT * (N + 4);
  const size_t smem0 = (la_floats > cb_floats ? la_floats : cb_floats) * sizeof(float);
  const size_t smem5 = ((size_t)out_smem_floats<N, P>() + 2 * (size_t)Q) * sizeof(float);
  cudaError_t err = allow_smem(ssd_kernel_prep<N>, smem0, &allowed0);
  if (err == cudaSuccess) err = allow_smem(ssd_kernel_out<N, P>, smem5, &allowed5);
  if (err != cudaSuccess) {
    cudaGetLastError();   // reported here, not to the next launcher
    return (int)err;
  }
  const Workspace w = carve(ws, batch, S, H, P, N, Q);
  const int nc = S / Q, tiles = (Q + QT - 1) / QT;
  const int n_prep = ((H + HG - 1) / HG + tiles * (tiles + 1) / 2) * nc * batch;
  ssd_kernel_prep<N><<<n_prep, THREADS, smem0, stream>>>(
      a, dt, B, C, w.la, w.wst, w.dtt, w.dec, w.cb, batch, S, H, Q);
  ssd_kernel_state<N, P><<<dim3(batch * H, N / StateTiles<N, P>::ROWS), THREADS, 0, stream>>>(
      x, B, w.wst, w.dec, w.hin, hout, S, H, Q);
  ssd_kernel_out<N, P><<<dim3(tiles, nc, batch * H), THREADS, smem5, stream>>>(
      x, C, w.cb, w.la, w.dtt, w.hin, y, S, H, Q);
  return (int)cudaGetLastError();
}

}  // namespace

// Floats of workspace a call needs (the wrapper allocates it), or -1 for a
// call the launcher refuses: (N, P) not built, or a chunk whose stages need
// more shared memory than a CTA has (checked again at launch).
extern "C" long long ssd_scan_workspace(int batch, int S, int H, int P, int N,
                                        int Q) {
  if (Q <= 0 || S % Q != 0) return -1;
  if (!((N == 128 && P == 64) || (N == 16 && P == 16))) return -1;
  const size_t most = 227 * 1024;
  const size_t out = N == 128 ? out_smem_floats<128, 64>() : out_smem_floats<16, 16>();
  if ((size_t)2 * Q * (HG + 1) * sizeof(float) > most ||
      (out + 2 * (size_t)Q) * sizeof(float) > most)
    return -1;
  return (long long)carve(nullptr, batch, S, H, P, N, Q).floats;
}

// (N, P) = (128, 64): mamba2-780m; (16, 16): its reduced test config.
// Other sizes, and a chunk whose shared memory exceeds a CTA's, return
// cudaErrorInvalidValue, which the Python wrapper raises.
extern "C" int ssd_scan_launch(const void* x, const void* a, const void* dt,
                               const void* B, const void* C, void* y, void* hout,
                               void* ws, int batch, int S, int H, int P, int N,
                               int Q, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (Q <= 0 || S % Q != 0) return (int)cudaErrorInvalidValue;
  const float *xf = (const float*)x, *af = (const float*)a, *df = (const float*)dt,
              *bf = (const float*)B, *cf = (const float*)C;
  if (N == 128 && P == 64)
    return launch<128, 64>(xf, af, df, bf, cf, (float*)y, (float*)hout, (float*)ws,
                           batch, S, H, Q, s);
  if (N == 16 && P == 16)
    return launch<16, 16>(xf, af, df, bf, cf, (float*)y, (float*)hout, (float*)ws,
                          batch, S, H, Q, s);
  return (int)cudaErrorInvalidValue;
}
