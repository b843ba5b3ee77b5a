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
// B, C [b, S, N], read once per head (b = bh / H) instead of broadcast to
// every head first as the TPU wrapper does (ops.py:31-32).  The TPU
// kernel's [BH, S, P] layout is the case H = 1.
//
// Bound on the H100: the function needs, per (bh, chunk), Q(Q+1)*P fp32
// operations for the causal half of M.x and 2*Q*N*P each for C.h and the
// state update, plus, per (b, chunk), Q(Q+1)*N for the causal half of
// C.B^T, which the heads of a batch row share.  At the training shape
// (b = 8, H = 48, S = 512, Q = 256, N = 128, P = 64) that is ~9.8 GFLOP,
// ~0.146 ms at 67 TFLOP/s, against ~0.12 GB of operands (~0.04 ms at
// 3.35 TB/s): operations bound.  This kernel does more: it computes C.B^T
// once per head.
//
// Design (a simple first version: fp32 FMAs from shared memory, no tensor
// cores, no TMA).  The TPU grid (BH, S/Q) runs its chunk axis in order with
// h in VMEM; GPU blocks run in no order, so one CTA of 256 threads owns one
// bh and walks its chunks in a loop, h [N][P] (32 KB at N=128, P=64) in
// shared memory.  A whole chunk's B, C, x and C.B^T (~512 KB at Q=256) do
// not fit in 227 KB, so query rows go in tiles of 64: each tile takes
// C.h, then streams key tiles of 32 (only those at or below the diagonal):
// the 64x32 scores C.B^T, masked and weighted into M, then M.x into a 4 x
// P/16 register tile per thread.  The state update streams the chunk's key
// tiles once more.  Masked entries of M are selected to 0 before the
// exponential is taken (exp of la_q - la_k above the diagonal can be inf),
// and expf/logf are the IEEE-accurate functions, not the fast intrinsics.
// ~98.5 KB of shared memory at N=128, P=64, so two CTAs share an SM.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int TQ = 64;          // query rows per tile
constexpr int TK = 32;          // key rows per tile
constexpr int MT_LD = TQ + 4;   // row stride of the transposed M tile

template <int V> __device__ __forceinline__ void ld(const float* p, float* o);
template <> __device__ __forceinline__ void ld<1>(const float* p, float* o) { o[0] = p[0]; }
template <> __device__ __forceinline__ void ld<2>(const float* p, float* o) {
  const float2 v = *reinterpret_cast<const float2*>(p);
  o[0] = v.x; o[1] = v.y;
}
template <> __device__ __forceinline__ void ld<4>(const float* p, float* o) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
}

template <int V> __device__ __forceinline__ void st(float* p, const float* v);
template <> __device__ __forceinline__ void st<1>(float* p, const float* v) { p[0] = v[0]; }
template <> __device__ __forceinline__ void st<2>(float* p, const float* v) {
  *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
}
template <> __device__ __forceinline__ void st<4>(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

// A thread's PT columns of a P = 16*PT wide row: groups of VP adjacent
// columns, the 16 column threads side by side within each group, so each
// group is one vector load and a warp's loads are contiguous.
template <int PT> struct Cols {
  static constexpr int VP = PT < 4 ? PT : 4;
  static __device__ __forceinline__ int col(int tc, int j) {
    return (j / VP) * (16 * VP) + tc * VP + (j % VP);
  }
  static __device__ __forceinline__ void load(const float* row, int tc, float* o) {
#pragma unroll
    for (int g = 0; g < PT / VP; ++g) ld<VP>(row + g * 16 * VP + tc * VP, o + g * VP);
  }
  static __device__ __forceinline__ void store(float* row, int tc, const float* v) {
#pragma unroll
    for (int g = 0; g < PT / VP; ++g) st<VP>(row + g * 16 * VP + tc * VP, v + g * VP);
  }
};

template <int NT, int PT>
constexpr size_t smem_floats(int Q) {
  return (size_t)(16 * NT) * (16 * PT)      // h [N][P]
         + (size_t)(16 * NT) * TQ           // C tile, transposed [N][TQ]
         + (size_t)(16 * NT) * TK           // B tile [N][TK] or [TK][N]
         + (size_t)TK * (16 * PT)           // x tile [TK][P]
         + (size_t)TK * MT_LD               // M tile, transposed [TK][TQ]
         + 2 * (size_t)Q;                   // la, dt of the chunk
}

template <int NT, int PT>
__global__ void __launch_bounds__(THREADS, 2)
ssd_scan_kernel(const float* __restrict__ x, const float* __restrict__ a,
                const float* __restrict__ dt, const float* __restrict__ Bm,
                const float* __restrict__ Cm, float* __restrict__ y,
                float* __restrict__ hout, int S, int H, int Q) {
  constexpr int N = 16 * NT, P = 16 * PT;
  constexpr int VN = NT < 4 ? NT : 4;
  using PC = Cols<PT>;
  extern __shared__ __align__(16) float smem[];
  float* hs = smem;                  // [N][P]
  float* Ct = hs + N * P;            // [N][TQ]
  float* Bt = Ct + N * TQ;           // [N][TK] (scores) / [TK][N] (state)
  float* xs = Bt + N * TK;           // [TK][P]
  float* Mt = xs + TK * P;           // [TK][MT_LD]
  float* la = Mt + TK * MT_LD;       // [Q]
  float* dts = la + Q;               // [Q]

  const int tid = threadIdx.x;
  const int tr = tid >> 4, tc = tid & 15;   // row group, column group
  const int bh = blockIdx.x, bi = bh / H, hi = bh % H;
  const size_t row = (size_t)H * P;         // x, y: one step apart
  const float* xb = x + (size_t)bi * S * row + (size_t)hi * P;
  float* yb = y + (size_t)bi * S * row + (size_t)hi * P;
  const float* ab = a + (size_t)bi * S * H + hi;
  const float* db = dt + (size_t)bi * S * H + hi;
  const float* Bb = Bm + (size_t)bi * S * N;
  const float* Cb = Cm + (size_t)bi * S * N;

  for (int i = tid; i < N * P; i += THREADS) hs[i] = 0.0f;

  for (int s0 = 0; s0 < S; s0 += Q) {
    __syncthreads();   // h written, la/dt of the last chunk no longer read
    for (int i = tid; i < Q; i += THREADS) {
      la[i] = logf(fmaxf(ab[(size_t)(s0 + i) * H], 1e-20f));
      dts[i] = db[(size_t)(s0 + i) * H];
    }
    __syncthreads();
    // la = cumsum(log a), left to right in one thread: the order of the
    // plain version's (and PyTorch's outer-dimension) scan, so both see the
    // same la and hence the same decays; la reaches -500 and below within a
    // chunk, where a reordered sum moves seg = la_q - la_k by ~1e-4.
    if (tid == 0) {
      float run = 0.0f;
      for (int i = 0; i < Q; ++i) {
        run += la[i];
        la[i] = run;
      }
    }
    __syncthreads();
    const float la_last = la[Q - 1];

    for (int q0 = 0; q0 < Q; q0 += TQ) {
      // C rows of the tile, transposed to [n][q] (rows past Q are zero)
      for (int it = tid; it < TQ * (N / 4); it += THREADS) {
        const int ql = it % TQ, n4 = it / TQ;
        float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        if (q0 + ql < Q) ld<4>(Cb + (size_t)(s0 + q0 + ql) * N + 4 * n4, v);
#pragma unroll
        for (int e = 0; e < 4; ++e) Ct[(4 * n4 + e) * TQ + ql] = v[e];
      }
      __syncthreads();

      // off-diagonal: exp(la_q) * (C_q . h_prev)
      float acc[4][PT];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < PT; ++j) acc[i][j] = 0.0f;
#pragma unroll 4
      for (int n = 0; n < N; ++n) {
        float cv[4], hv[PT];
        ld<4>(Ct + n * TQ + 4 * tr, cv);
        PC::load(hs + n * P, tc, hv);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < PT; ++j) acc[i][j] = fmaf(cv[i], hv[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int q = q0 + 4 * tr + i;
        const float e = q < Q ? expf(la[q]) : 0.0f;
#pragma unroll
        for (int j = 0; j < PT; ++j) acc[i][j] *= e;
      }

      // intra-chunk: key tiles at or below the diagonal
      const int kend = min(q0 + TQ, Q);
      for (int k0 = 0; k0 < kend; k0 += TK) {
        for (int it = tid; it < TK * (N / 4); it += THREADS) {
          const int kl = it % TK, n4 = it / TK;
          float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
          if (k0 + kl < Q) ld<4>(Bb + (size_t)(s0 + k0 + kl) * N + 4 * n4, v);
#pragma unroll
          for (int e = 0; e < 4; ++e) Bt[(4 * n4 + e) * TK + kl] = v[e];
        }
        for (int it = tid; it < TK * (P / 4); it += THREADS) {
          const int kl = it / (P / 4), p4 = it % (P / 4);
          float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
          if (k0 + kl < Q) ld<4>(xb + (size_t)(s0 + k0 + kl) * row + 4 * p4, v);
          st<4>(xs + kl * P + 4 * p4, v);
        }
        __syncthreads();

        // scores C_q . B_k for rows 4*tr + i, columns 2*tc + j
        float sc[4][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}, {0.0f, 0.0f}, {0.0f, 0.0f}};
#pragma unroll 4
        for (int n = 0; n < N; ++n) {
          float cv[4], bv[2];
          ld<4>(Ct + n * TQ + 4 * tr, cv);
          ld<2>(Bt + n * TK + 2 * tc, bv);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            sc[i][0] = fmaf(cv[i], bv[0], sc[i][0]);
            sc[i][1] = fmaf(cv[i], bv[1], sc[i][1]);
          }
        }
        // M = scores * exp(la_q - la_k) * dt_k where k <= q < Q, else 0
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int q = q0 + 4 * tr + i;
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int k = k0 + 2 * tc + j;
            float m = 0.0f;
            if (q < Q && k <= q) m = sc[i][j] * expf(la[q] - la[k]) * dts[k];
            Mt[(2 * tc + j) * MT_LD + 4 * tr + i] = m;
          }
        }
        __syncthreads();

#pragma unroll 4
        for (int kk = 0; kk < TK; ++kk) {
          float mv[4], xv[PT];
          ld<4>(Mt + kk * MT_LD + 4 * tr, mv);
          PC::load(xs + kk * P, tc, xv);
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < PT; ++j) acc[i][j] = fmaf(mv[i], xv[j], acc[i][j]);
        }
        __syncthreads();   // Bt, xs, Mt (and, after the last tile, Ct) reused
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int q = q0 + 4 * tr + i;
        if (q < Q) PC::store(yb + (size_t)(s0 + q) * row, tc, acc[i]);
      }
    }

    // state: h = h * exp(la_last) + sum_k B_k^T (dt_k exp(la_last - la_k) x_k)
    float hacc[NT][PT];
#pragma unroll
    for (int i = 0; i < NT; ++i)
#pragma unroll
      for (int j = 0; j < PT; ++j) hacc[i][j] = 0.0f;
    for (int k0 = 0; k0 < Q; k0 += TK) {
      for (int it = tid; it < TK * (N / 4); it += THREADS) {
        const int kl = it / (N / 4), n4 = it % (N / 4);
        float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        if (k0 + kl < Q) ld<4>(Bb + (size_t)(s0 + k0 + kl) * N + 4 * n4, v);
        st<4>(Bt + kl * N + 4 * n4, v);
      }
      for (int it = tid; it < TK * (P / 4); it += THREADS) {
        const int kl = it / (P / 4), p4 = it % (P / 4);
        const int k = k0 + kl;
        float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        if (k < Q) {
          ld<4>(xb + (size_t)(s0 + k) * row + 4 * p4, v);
          const float w = dts[k] * expf(la_last - la[k]);
#pragma unroll
          for (int e = 0; e < 4; ++e) v[e] *= w;
        }
        st<4>(xs + kl * P + 4 * p4, v);
      }
      __syncthreads();
#pragma unroll 4
      for (int kk = 0; kk < TK; ++kk) {
        float bv[NT], xv[PT];
#pragma unroll
        for (int g = 0; g < NT / VN; ++g) ld<VN>(Bt + kk * N + NT * tr + g * VN, bv + g * VN);
        PC::load(xs + kk * P, tc, xv);
#pragma unroll
        for (int i = 0; i < NT; ++i)
#pragma unroll
          for (int j = 0; j < PT; ++j) hacc[i][j] = fmaf(bv[i], xv[j], hacc[i][j]);
      }
      __syncthreads();
    }
    const float decay = expf(la_last);
#pragma unroll
    for (int i = 0; i < NT; ++i) {
      float* hrow = hs + (NT * tr + i) * P;
#pragma unroll
      for (int j = 0; j < PT; ++j) {
        const int p = PC::col(tc, j);
        hrow[p] = hrow[p] * decay + hacc[i][j];
      }
    }
  }
  __syncthreads();
  float* ho = hout + (size_t)bh * N * P;
  for (int i = tid; i < N * P; i += THREADS) ho[i] = hs[i];
}

template <int NT, int PT>
int launch(const void* x, const void* a, const void* dt, const void* B,
           const void* C, void* y, void* hout, int batch, int S, int H, int Q,
           cudaStream_t stream) {
  static size_t allowed = 0;
  const size_t smem = smem_floats<NT, PT>(Q) * sizeof(float);
  cudaError_t err = allow_smem(ssd_scan_kernel<NT, PT>, smem, &allowed);
  if (err != cudaSuccess) {
    cudaGetLastError();   // reported here, not to the next launcher
    return (int)err;
  }
  ssd_scan_kernel<NT, PT><<<batch * H, THREADS, smem, stream>>>(
      (const float*)x, (const float*)a, (const float*)dt, (const float*)B,
      (const float*)C, (float*)y, (float*)hout, S, H, Q);
  return (int)cudaGetLastError();
}

}  // namespace

// (N, P) = (16*NT, 16*PT): mamba2-780m (128, 64) and its reduced test
// config (16, 16).  Other sizes, and a chunk whose shared memory exceeds a
// CTA's, return cudaErrorInvalidValue, which the Python wrapper raises.
extern "C" int ssd_scan_launch(const void* x, const void* a, const void* dt,
                               const void* B, const void* C, void* y, void* hout,
                               int batch, int S, int H, int P, int N, int Q,
                               void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (Q <= 0 || S % Q != 0) return (int)cudaErrorInvalidValue;
  if (N == 128 && P == 64) return launch<8, 4>(x, a, dt, B, C, y, hout, batch, S, H, Q, s);
  if (N == 16 && P == 16) return launch<1, 1>(x, a, dt, B, C, y, hout, batch, S, H, Q, s);
  return (int)cudaErrorInvalidValue;
}
