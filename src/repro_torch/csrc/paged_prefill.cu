// Paged-prefill chunk step over the serving block pools.
//
// Replaces the TPU kernel
// repro/kernels/paged_prefill/kernel.py::paged_prefill_chunk_kernel.
// For each (row b, kv-head h): the lens[b]*g valid query rows of a chunk at
// positions start[b] .. start[b]+lens[b]-1 attend the resident positions
// < start[b] (trie-shared blocks read in place) plus the chunk itself
// causally; the chunk rows j < lens[b] are written into the row's blocks,
// pad rows never, and pad rows of the output are zeros.  Decode rows are
// lens == 1, so one launch serves steps that mix prefilling and decoding
// rows, and a decode row costs one m16 tile of query rows.
//
// Bound on the H100: the resident K/V bytes of the live rows, read once (at
// T = 32, g = 2 the work is ~2 operations per byte: far below the ridge).
// The design (paged_core.cuh): the KV walk split across CTAs, SK = 256 keys
// each, with a merge kernel combining the splits' fp32 partials in a fixed
// order; a two-stage cp.async ring of 64-key tiles; Q·Kᵀ and P·V on the
// tensor cores (mma.sync m16n8k16) for bf16 x bf16, with P split into bf16
// high and low parts so P·V keeps fp32 accuracy; fp32 CUDA-core products
// for the other dtype pairs.  The pool writes are done once per (b, h), by
// the split that holds position start: other splits read only positions
// < start, shared prefix blocks are never written, and only the trash block
// is both read and written (by idle or stalled rows, whose output is
// discarded); paged_core.cuh sets out the argument.
#include "paged_core.cuh"

template <typename TQ, typename TC, int DH>
__global__ void __launch_bounds__(PA_THREADS)
paged_prefill_kernel(const PagedArgs<TQ, TC> a, const PagedProblem p) {
  paged_attend<TQ, TC, DH>(a, p);
}

template <typename TQ, typename TC, int DH>
__global__ void __launch_bounds__(pa_merge_rows(DH) * DH / 8)
paged_prefill_kernel_merge(const PagedArgs<TQ, TC> a, const PagedProblem p) {
  paged_merge<TQ, TC, DH>(a, p);
}

// one head dim's pair of kernels; `allowed` is its shared-memory opt-in
template <typename TQ, typename TC, int DH>
static int launch_dh(const PagedArgs<TQ, TC>& a, const PagedProblem& p,
                     cudaStream_t stream) {
  static size_t allowed = 0;
  return paged_launch_dh<TQ, TC, DH>(paged_prefill_kernel<TQ, TC, DH>,
                                     paged_prefill_kernel_merge<TQ, TC, DH>,
                                     &allowed, a, p, stream);
}

template <typename TQ, typename TC>
static int launch(const void* q, const void* kc, const void* vc, void* kpool,
                  void* vpool, const void* bt, const void* start,
                  const void* lens, void* out, float* ws_acc, float2* ws_mz,
                  const PagedProblem& p, cudaStream_t stream) {
  const PagedArgs<TQ, TC> a{(const TQ*)q, (const TQ*)kc, (const TQ*)vc,
                            (TC*)kpool, (TC*)vpool, (const int*)bt,
                            (const int*)start, (const int*)lens, (TC*)out,
                            ws_acc, ws_mz};
  switch (p.Dh) {
    case 16: return launch_dh<TQ, TC, 16>(a, p, stream);
    case 32: return launch_dh<TQ, TC, 32>(a, p, stream);
    case 64: return launch_dh<TQ, TC, 64>(a, p, stream);
    case 128: return launch_dh<TQ, TC, 128>(a, p, stream);
    case 256: return launch_dh<TQ, TC, 256>(a, p, stream);
  }
  return (int)cudaErrorInvalidValue;   // paged_plan takes no other head dim
}

extern "C" int paged_prefill_chunk_launch(
    const void* q, const void* kc, const void* vc, void* kpool, void* vpool,
    const void* bt, const void* start, const void* lens, void* out, void* ws,
    long long ws_floats, int B, int Hkv, int T, int g, int Dh, int bs, int L,
    float scale, float softcap, int q_dtype, int cache_dtype, void* stream) {
  PagedProblem p;
  p.B = B; p.Hkv = Hkv; p.R = T * g; p.T = T; p.g = g; p.Dh = Dh; p.bs = bs;
  p.L = L; p.scale = scale; p.softcap = softcap;
  p.decode = 0;
  float* ws_acc;
  float2* ws_mz;
  if (!paged_plan(p) || !paged_workspace(p, ws, ws_floats, &ws_acc, &ws_mz))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (q_dtype == DT_F32 && cache_dtype == DT_F32)
    return launch<float, float>(q, kc, vc, kpool, vpool, bt, start, lens, out, ws_acc, ws_mz, p, s);
  if (q_dtype == DT_BF16 && cache_dtype == DT_BF16)
    return launch<__nv_bfloat16, __nv_bfloat16>(q, kc, vc, kpool, vpool, bt, start, lens, out, ws_acc, ws_mz, p, s);
  if (q_dtype == DT_F32 && cache_dtype == DT_BF16)
    return launch<float, __nv_bfloat16>(q, kc, vc, kpool, vpool, bt, start, lens, out, ws_acc, ws_mz, p, s);
  if (q_dtype == DT_BF16 && cache_dtype == DT_F32)
    return launch<__nv_bfloat16, float>(q, kc, vc, kpool, vpool, bt, start, lens, out, ws_acc, ws_mz, p, s);
  return (int)cudaErrorInvalidValue;
}
