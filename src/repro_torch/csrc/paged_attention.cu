// Paged-attention decode step over the serving block pools.
//
// Replaces the TPU kernel
// repro/kernels/paged_attention/kernel.py::paged_attention_decode_kernel.
// For each (row b, kv-head h): an fp32 softmax of the g grouped query heads
// over the stored positions < idx[b] (read in place from the row's blocks)
// and the step's new token folded in from the projection output, optional
// softcap c*tanh(s/c), and the new K/V written into block
// bt[b, min(idx/bs, L-1)] at offset idx % bs.  Idle rows (table all trash)
// skip the walk and give the new token's V: finite, and discarded.
//
// Bound on the H100: one step reads each active row's resident K and V once
// (2 * positions * Hkv * Dh * itemsize bytes) at ~4 * g * Dh operations per
// key, so it is bound by those bytes.  The design is the prefill kernel's
// body at T = 1 (paged_core.cuh): the KV walk split across CTAs (SK = 128
// keys each, so B * Hkv CTAs become up to 16x as many) with a merge kernel
// combining the fp32 partials in split order; the g query rows padded to
// one m16 tile whose 16-key steps the four warps share, merged in shared
// memory in warp order; a two-stage cp.async ring; mma.sync m16n8k16 for
// Q·Kᵀ and for P·V with P split into bf16 high and low parts (bf16 x bf16),
// fp32 CUDA-core products otherwise.  The new K/V is written once per
// (b, h) by the split holding idx, while other splits read positions < idx
// only (paged_core.cuh sets out why that is safe).
#include "paged_core.cuh"

template <typename TQ, typename TC, int DH>
__global__ void __launch_bounds__(PA_THREADS)
paged_decode_kernel(const PagedArgs<TQ, TC> a, const PagedProblem p) {
  paged_attend<TQ, TC, DH>(a, p);
}

template <typename TQ, typename TC, int DH>
__global__ void __launch_bounds__(pa_merge_rows(DH) * DH / 8)
paged_decode_kernel_merge(const PagedArgs<TQ, TC> a, const PagedProblem p) {
  paged_merge<TQ, TC, DH>(a, p);
}

// one head dim's pair of kernels; `allowed` is its shared-memory opt-in
template <typename TQ, typename TC, int DH>
static int launch_dh(const PagedArgs<TQ, TC>& a, const PagedProblem& p,
                     cudaStream_t stream) {
  static size_t allowed = 0;
  return paged_launch_dh<TQ, TC, DH>(paged_decode_kernel<TQ, TC, DH>,
                                     paged_decode_kernel_merge<TQ, TC, DH>,
                                     &allowed, a, p, stream);
}

template <typename TQ, typename TC>
static int launch(const void* q, const void* kn, const void* vn, void* kpool,
                  void* vpool, const void* bt, const void* idx, void* out,
                  float* ws_acc, float2* ws_mz, const PagedProblem& p,
                  cudaStream_t stream) {
  const PagedArgs<TQ, TC> a{(const TQ*)q, (const TQ*)kn, (const TQ*)vn,
                            (TC*)kpool, (TC*)vpool, (const int*)bt,
                            (const int*)idx, nullptr, (TC*)out,
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

// The plan of a launch, for the wrappers (kernels/paged_attention/kernel.py
// sizes the workspace from it and prints it): out = {split keys, splits, row
// groups, workspace floats, attention CTAs, merge CTAs}.  R = T * g query
// rows per (row, kv-head).  cudaErrorInvalidValue for a shape not taken.
extern "C" int paged_plan_query(int B, int Hkv, int R, int T, int Dh, int bs,
                                int L, long long* out) {
  PagedProblem p;
  p.B = B; p.Hkv = Hkv; p.R = R; p.T = T; p.Dh = Dh; p.bs = bs; p.L = L;
  if (!paged_plan(p)) return (int)cudaErrorInvalidValue;
  out[0] = p.SK;
  out[1] = p.NS;
  out[2] = p.NRG;
  out[3] = paged_workspace_floats(p);
  out[4] = (long long)p.Hkv * p.B * p.NS * p.NRG;
  out[5] = p.NS > 1 ? (long long)p.Hkv * p.B * p.NRG * pa_merge_chunks(p.Dh) : 0;
  return 0;
}

extern "C" int paged_attention_decode_launch(
    const void* q, const void* kn, const void* vn, void* kpool, void* vpool,
    const void* bt, const void* idx, void* out, void* ws, long long ws_floats,
    int B, int Hkv, int g, int Dh, int bs, int L, float scale, float softcap,
    int q_dtype, int cache_dtype, void* stream) {
  PagedProblem p;
  p.B = B; p.Hkv = Hkv; p.R = g; p.T = 1; p.g = g; p.Dh = Dh; p.bs = bs;
  p.L = L; p.scale = scale; p.softcap = softcap;
  p.decode = 1;
  float* ws_acc;
  float2* ws_mz;
  if (!paged_plan(p) || !paged_workspace(p, ws, ws_floats, &ws_acc, &ws_mz))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (q_dtype == DT_F32 && cache_dtype == DT_F32)
    return launch<float, float>(q, kn, vn, kpool, vpool, bt, idx, out, ws_acc, ws_mz, p, s);
  if (q_dtype == DT_BF16 && cache_dtype == DT_BF16)
    return launch<__nv_bfloat16, __nv_bfloat16>(q, kn, vn, kpool, vpool, bt, idx, out, ws_acc, ws_mz, p, s);
  if (q_dtype == DT_F32 && cache_dtype == DT_BF16)
    return launch<float, __nv_bfloat16>(q, kn, vn, kpool, vpool, bt, idx, out, ws_acc, ws_mz, p, s);
  if (q_dtype == DT_BF16 && cache_dtype == DT_F32)
    return launch<__nv_bfloat16, float>(q, kn, vn, kpool, vpool, bt, idx, out, ws_acc, ws_mz, p, s);
  return (int)cudaErrorInvalidValue;
}
