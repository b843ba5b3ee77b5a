// Paged-attention decode step over the serving block pools.
//
// Replaces the TPU kernel
// repro/kernels/paged_attention/kernel.py::paged_attention_decode_kernel.
// For each (row b, kv-head h): an fp32 online softmax of the g grouped query
// heads over the stored positions < idx[b] (read in place from the row's
// blocks), then the step's new token folded in from the projection output,
// optional softcap c*tanh(s/c), and the new K/V written into block
// bt[b, min(idx/bs, L-1)] at offset idx % bs.  Idle rows (table all trash)
// read and write the trash block 0 and give finite garbage.
//
// Bound on the H100: one step reads each active row's resident K and V once
// (2 * positions * Hkv * Dh * itemsize bytes) and does ~4 * g * Dh flops per
// key, so it is bound by those bytes.  The design reads each resident block
// once per (row, head) CTA with coalesced loads and never materialises the
// dense block-table window the gather path builds.  With B * Hkv CTAs it
// fills the card only at large batch; splitting the KV walk across CTAs when
// B * Hkv < 132 is later work.  The body is shared with the prefill kernel
// (paged_core.cuh, T = 1).
#include "paged_core.cuh"

template <typename TQ, typename TC>
__global__ void __launch_bounds__(PA_THREADS)
paged_decode_kernel(const TQ* __restrict__ q, const TQ* __restrict__ kn,
                    const TQ* __restrict__ vn, TC* __restrict__ kpool,
                    TC* __restrict__ vpool, const int* __restrict__ bt,
                    const int* __restrict__ idx, TC* __restrict__ out,
                    const PagedProblem p) {
  const int b = blockIdx.y;
  paged_attend<TQ, TC>(q, kn, vn, kpool, vpool, bt, b, idx[b], 1, true, out, p);
}

template <typename TQ, typename TC>
static int launch(const void* q, const void* kn, const void* vn, void* kpool,
                  void* vpool, const void* bt, const void* idx, void* out,
                  int B, const PagedProblem& p, cudaStream_t stream) {
  const size_t smem = paged_smem_bytes(p.RG, p.Dh);
  static size_t allowed = 0;
  cudaError_t err = allow_smem(paged_decode_kernel<TQ, TC>, smem, &allowed);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(p.Hkv, B);
  paged_decode_kernel<TQ, TC><<<grid, PA_THREADS, smem, stream>>>(
      (const TQ*)q, (const TQ*)kn, (const TQ*)vn, (TC*)kpool, (TC*)vpool,
      (const int*)bt, (const int*)idx, (TC*)out, p);
  return (int)cudaGetLastError();
}

extern "C" int paged_attention_decode_launch(
    const void* q, const void* kn, const void* vn, void* kpool, void* vpool,
    const void* bt, const void* idx, void* out, int B, int Hkv, int g, int Dh,
    int bs, int L, float scale, float softcap, int q_dtype, int cache_dtype,
    void* stream) {
  PagedProblem p;
  p.Hkv = Hkv; p.R = g; p.T = 1; p.g = g; p.Dh = Dh; p.bs = bs; p.L = L;
  p.RG = paged_row_group(g, Dh);
  p.scale = scale; p.softcap = softcap;
  cudaStream_t s = (cudaStream_t)stream;
  if (q_dtype == DT_F32 && cache_dtype == DT_F32)
    return launch<float, float>(q, kn, vn, kpool, vpool, bt, idx, out, B, p, s);
  if (q_dtype == DT_BF16 && cache_dtype == DT_BF16)
    return launch<__nv_bfloat16, __nv_bfloat16>(q, kn, vn, kpool, vpool, bt, idx, out, B, p, s);
  if (q_dtype == DT_F32 && cache_dtype == DT_BF16)
    return launch<float, __nv_bfloat16>(q, kn, vn, kpool, vpool, bt, idx, out, B, p, s);
  if (q_dtype == DT_BF16 && cache_dtype == DT_F32)
    return launch<__nv_bfloat16, float>(q, kn, vn, kpool, vpool, bt, idx, out, B, p, s);
  return (int)cudaErrorInvalidValue;
}
