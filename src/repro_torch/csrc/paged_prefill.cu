// Paged-prefill chunk step over the serving block pools.
//
// Replaces the TPU kernel
// repro/kernels/paged_prefill/kernel.py::paged_prefill_chunk_kernel.
// For each (row b, kv-head h): the T*g query rows of a chunk at positions
// start[b] .. start[b]+lens[b]-1 attend the resident positions < start[b]
// (trie-shared blocks read in place) plus the chunk itself causally; the
// chunk rows j < lens[b] are then written into the row's blocks, pad rows
// never.  Decode rows are lens == 1, so one launch serves steps that mix
// prefilling and decoding rows.
//
// Bound on the H100: each chunked row reads its resident K and V once and
// does ~4 * T * g * Dh flops per key, so for a 32-token chunk the work is
// ~2 flops per byte read from the pools: still below the card's ridge, so
// bound by those bytes (and by the fp32 CUDA-core rate of this simple
// kernel, which does its dot products without tensor cores; wgmma is later
// work).  The design streams each resident block once per (row, head) CTA
// for all T*g query rows at once, folds the chunk's own K/V from the
// projection outputs without a round trip through the pools, and writes the
// chunk only after every read of the CTA (paged_core.cuh).
#include "paged_core.cuh"

template <typename TQ, typename TC>
__global__ void __launch_bounds__(PA_THREADS)
paged_prefill_kernel(const TQ* __restrict__ q, const TQ* __restrict__ kc,
                     const TQ* __restrict__ vc, TC* __restrict__ kpool,
                     TC* __restrict__ vpool, const int* __restrict__ bt,
                     const int* __restrict__ start, const int* __restrict__ lens,
                     TC* __restrict__ out, const PagedProblem p) {
  const int b = blockIdx.y;
  paged_attend<TQ, TC>(q, kc, vc, kpool, vpool, bt, b, start[b], lens[b], false,
                       out, p);
}

template <typename TQ, typename TC>
static int launch(const void* q, const void* kc, const void* vc, void* kpool,
                  void* vpool, const void* bt, const void* start,
                  const void* lens, void* out, int B, const PagedProblem& p,
                  cudaStream_t stream) {
  const size_t smem = paged_smem_bytes(p.RG, p.Dh);
  static size_t allowed = 0;
  cudaError_t err = allow_smem(paged_prefill_kernel<TQ, TC>, smem, &allowed);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(p.Hkv, B);
  paged_prefill_kernel<TQ, TC><<<grid, PA_THREADS, smem, stream>>>(
      (const TQ*)q, (const TQ*)kc, (const TQ*)vc, (TC*)kpool, (TC*)vpool,
      (const int*)bt, (const int*)start, (const int*)lens, (TC*)out, p);
  return (int)cudaGetLastError();
}

extern "C" int paged_prefill_chunk_launch(
    const void* q, const void* kc, const void* vc, void* kpool, void* vpool,
    const void* bt, const void* start, const void* lens, void* out, int B,
    int Hkv, int T, int g, int Dh, int bs, int L, float scale, float softcap,
    int q_dtype, int cache_dtype, void* stream) {
  PagedProblem p;
  p.Hkv = Hkv; p.R = T * g; p.T = T; p.g = g; p.Dh = Dh; p.bs = bs; p.L = L;
  p.RG = paged_row_group(T * g, Dh);
  p.scale = scale; p.softcap = softcap;
  cudaStream_t s = (cudaStream_t)stream;
  if (q_dtype == DT_F32 && cache_dtype == DT_F32)
    return launch<float, float>(q, kc, vc, kpool, vpool, bt, start, lens, out, B, p, s);
  if (q_dtype == DT_BF16 && cache_dtype == DT_BF16)
    return launch<__nv_bfloat16, __nv_bfloat16>(q, kc, vc, kpool, vpool, bt, start, lens, out, B, p, s);
  if (q_dtype == DT_F32 && cache_dtype == DT_BF16)
    return launch<float, __nv_bfloat16>(q, kc, vc, kpool, vpool, bt, start, lens, out, B, p, s);
  if (q_dtype == DT_BF16 && cache_dtype == DT_F32)
    return launch<__nv_bfloat16, float>(q, kc, vc, kpool, vpool, bt, start, lens, out, B, p, s);
  return (int)cudaErrorInvalidValue;
}
