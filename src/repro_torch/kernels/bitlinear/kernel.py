"""QAT ternary matmul (bitlinear) on the card: binding of ``csrc/bitlinear.cu``.

Replaces the TPU kernel ``repro/kernels/bitlinear/kernel.py::bitlinear_kernel``:

  y[M, N] = ( q8(x) @ wq ) · ((γ/127) · Δ),
  q8 = clip(rint(x · (127/(γ + 1e-5))), -128, 127),

with wq the ternary weight (per-tensor scale Δ), γ the per-row absmax of x
(fp32 ``[M, 1]``) and int32 accumulation, so the result equals the plain
version bit for bit.

Bound on the H100: at the training shapes the int8 operations at 1979 TOP/s
outweigh the bytes at 3.35 TB/s, so the product runs on the int8 tensor
cores through ``wgmma``, which takes 8-bit operands K-major from shared
memory.  One call is three device kernels (see the .cu): a quantizing pass
over the rows of x (:func:`quantize_rows`, int8 codes ``[M, Kp]`` with Kp =
K rounded up to the GEMM's K tile, zero pad), the weight as K-major codes
``[N, Kp]`` (:func:`weight_kmajor`) and the GEMM on those (:func:`gemm`: a
TMA ring feeding ``wgmma`` s8, 128 x 128 output tiles, two CTAs per SM).
:func:`bitlinear_kernel` and the training op's :func:`bitlinear_forward`
check their operands once and enqueue the three through one C entry point,
with the call's temporaries in a buffer kept per stream: the host's enqueue
time, not the device, sets what a caller sees of a call at the training
shapes.  The launch counter counts one per such call, whatever it launches.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import build

launches = build.LaunchCounter("bitlinear")

_INFO_KEYS = ("k_tile", "bm", "bn", "stages", "threads", "smem_bytes")


@functools.lru_cache(maxsize=None)
def gemm_info() -> dict:
    """The GEMM's K tile, output tile, ring depth, threads and dynamic
    shared memory per CTA, from the .cu (the CPU's ``ref.K_TILE`` is a copy
    of the K tile; tests/test_torch_cuda.py holds the two equal)."""
    out = (ctypes.c_longlong * len(_INFO_KEYS))()
    build.library().bitlinear_gemm_info(out)
    return dict(zip(_INFO_KEYS, out))


def padded_k(k: int) -> int:
    """K rounded up to the GEMM's K tile: the codes' and wt's row pitch."""
    tile = gemm_info()["k_tile"]
    return -(-k // tile) * tile


# -- launches on checked operands ----------------------------------------------

def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _quant(x, gamma_in, gamma_out, codes) -> None:
    m, k = x.shape
    build.check(build.library().bitlinear_quant_launch(
        x.data_ptr(), _ptr(gamma_in), _ptr(gamma_out), codes.data_ptr(), m, k,
        codes.shape[1], build.DTYPE_CODES[x.dtype], build.stream_ptr(x.device)),
        "bitlinear quantizing pass")


def _weight(w, delta, wq, wt) -> None:
    k, n = w.shape
    build.check(build.library().bitlinear_weight_launch(
        w.data_ptr(), _ptr(delta), _ptr(wq), wt.data_ptr(), k, n, wt.shape[1],
        int(delta is not None), build.stream_ptr(w.device)), "bitlinear weight")


def _gemm(codes, wt, gamma, delta, y) -> None:
    build.check(build.library().bitlinear_gemm_launch(
        codes.data_ptr(), wt.data_ptr(), gamma.data_ptr(), delta.data_ptr(),
        y.data_ptr(), codes.shape[0], wt.shape[0], codes.shape[1],
        build.DTYPE_CODES[y.dtype], build.stream_ptr(y.device)), "bitlinear gemm")


def _empty(shape, dtype, dev) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=dev)


_scratch: Dict[Tuple[torch.device, int], torch.Tensor] = {}


def _temporaries(nbytes: int, device: torch.device, stream: int) -> int:
    """Pointer to ``nbytes`` of int8 scratch for a call's temporaries (the
    K-major weight; for :func:`bitlinear_kernel` the codes too): one buffer
    per stream, grown as needed and kept, since the launches of one stream
    run in order."""
    buf = _scratch.get((device, stream))
    if buf is None or buf.numel() < nbytes:
        buf = _empty((nbytes,), torch.int8, device)
        _scratch[(device, stream)] = buf
    return buf.data_ptr()


def _launch(x, gamma_in, gamma_out, codes, w, delta, wq, y) -> None:
    """The whole call through one C entry: codes None -> in the scratch."""
    (m, k), n = x.shape, w.shape[1]
    kp = padded_k(k)
    stream = build.stream_ptr(x.device)
    at = _temporaries((0 if codes is not None else m * kp) + n * kp, x.device,
                      stream)
    codes_ptr = at + n * kp if codes is None else codes.data_ptr()
    build.check(build.library().bitlinear_launch(
        x.data_ptr(), _ptr(gamma_in), _ptr(gamma_out), codes_ptr, w.data_ptr(),
        delta.data_ptr(), _ptr(wq), at, y.data_ptr(), m, k, n, kp,
        build.DTYPE_CODES[x.dtype], int(wq is not None), stream), "bitlinear")
    launches.count += 1


def _check_x(x: torch.Tensor, name: str, empty_batch: bool = False) -> None:
    if x.dim() != 2 or x.shape[1] == 0 or (x.shape[0] == 0 and not empty_batch):
        need = "a 2-D [M, K] with K > 0" if empty_batch else "a non-empty 2-D [M, K]"
        raise ValueError(f"{name}: x {tuple(x.shape)} must be {need}")
    build.dtype_code(x, name)


def _check_scales(m: int, gamma: Optional[torch.Tensor],
                  delta: Optional[torch.Tensor], name: str) -> None:
    if gamma is not None and (gamma.dtype != torch.float32 or gamma.numel() != m):
        raise TypeError(f"{name}: gamma must be fp32 with one value per row of x")
    if delta is not None and (delta.dtype != torch.float32 or delta.numel() != 1):
        raise TypeError(f"{name}: delta must be one fp32 value")


# -- the three device kernels alone ----------------------------------------------

def quantize_rows(x: torch.Tensor, gamma: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [M, K] fp32/bf16 -> (int8 codes [M, Kp] with a zero pad, γ fp32
    [M, 1]); γ is the row absmax unless the caller gives it.  CUDA only."""
    build.require_cuda("bitlinear quantize_rows", x,
                       *(() if gamma is None else (gamma,)))
    _check_x(x, "bitlinear quantize_rows")
    m, k = x.shape
    _check_scales(m, gamma, None, "bitlinear quantize_rows")
    codes = _empty((m, padded_k(k)), torch.int8, x.device)
    g_out = _empty((m, 1), torch.float32, x.device) if gamma is None else None
    _quant(x, gamma, g_out, codes)
    return codes, (gamma if g_out is None else g_out)


def weight_kmajor(w: torch.Tensor, delta: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The weight as K-major int8 codes ``wt [N, Kp]`` (zero pad) and as
    ``wq [K, N]``: from the int8 codes ``w`` (then ``wq`` is ``w``), or from
    the fp32 master weight ``w`` and its absmean scale ``delta``, ternarized
    on the way as ``Q.weight_quant_absmean`` does.  CUDA only."""
    build.require_cuda("bitlinear weight_kmajor", w,
                       *(() if delta is None else (delta,)))
    if w.dim() != 2 or w.shape[0] == 0 or w.shape[1] == 0:
        raise ValueError(f"bitlinear weight_kmajor: weight {tuple(w.shape)} must "
                         "be a non-empty 2-D [K, N]")
    if w.dtype != (torch.int8 if delta is None else torch.float32):
        raise TypeError(f"bitlinear weight_kmajor: the weight must be int8 codes, "
                        f"or fp32 with a delta; got {w.dtype}")
    _check_scales(0, None, delta, "bitlinear weight_kmajor")
    k, n = w.shape
    wq = w if delta is None else _empty((k, n), torch.int8, w.device)
    wt = _empty((n, padded_k(k)), torch.int8, w.device)
    _weight(w, delta, None if delta is None else wq, wt)
    return wt, wq


def gemm(codes: torch.Tensor, wt: torch.Tensor, gamma: torch.Tensor,
         delta: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """codes [M, Kp], wt [N, Kp] int8 -> y [M, N] in ``dtype`` (fp32/bf16):
    ``(codes @ wtᵀ) · ((γ/127) · Δ)`` on the int8 tensor cores.  CUDA only."""
    build.require_cuda("bitlinear gemm", codes, wt, gamma, delta)
    m, kp = codes.shape
    if codes.dtype != torch.int8 or wt.dtype != torch.int8 or wt.dim() != 2 \
            or wt.shape[1] != kp or kp != padded_k(kp) or m == 0 \
            or wt.shape[0] == 0:
        raise ValueError(f"bitlinear gemm: codes {tuple(codes.shape)} "
                         f"{codes.dtype} and wt {tuple(wt.shape)} {wt.dtype} must "
                         "be non-empty int8 with one K pitch, a multiple of "
                         f"{gemm_info()['k_tile']}")
    _check_scales(m, gamma, delta, "bitlinear gemm")
    if dtype not in build.DTYPE_CODES:
        raise TypeError(f"bitlinear gemm: output dtype {dtype} not supported")
    y = _empty((m, wt.shape[0]), dtype, codes.device)
    _gemm(codes, wt, gamma, delta, y)
    return y


# -- the whole call --------------------------------------------------------------

def bitlinear_kernel(x: torch.Tensor, wq: torch.Tensor, gamma: torch.Tensor,
                     delta: torch.Tensor) -> torch.Tensor:
    """x [M, K] fp32/bf16; wq int8 [K, N]; gamma fp32 [M, 1]; delta fp32
    scalar -> y [M, N] in x's dtype.  CUDA tensors only."""
    build.require_cuda("bitlinear_kernel", x, wq, gamma, delta)
    if x.dim() != 2 or wq.dim() != 2:
        raise ValueError(f"bitlinear_kernel: x {tuple(x.shape)} and wq "
                         f"{tuple(wq.shape)} must be 2-D")
    m, k = x.shape
    if wq.shape[0] != k:
        raise ValueError(f"bitlinear_kernel: wq has {wq.shape[0]} rows but x "
                         f"has k={k} columns")
    if wq.dtype != torch.int8:
        raise TypeError(f"bitlinear_kernel: wq must be int8, got {wq.dtype}")
    _check_scales(m, gamma, delta, "bitlinear_kernel")
    build.dtype_code(x, "bitlinear_kernel")
    n = wq.shape[1]
    if m == 0 or n == 0 or k == 0:
        return torch.zeros((m, n), dtype=x.dtype, device=x.device)
    y = _empty((m, n), x.dtype, x.device)
    _launch(x, gamma, None, None, wq, delta, None, y)
    return y


def bitlinear_forward(x: torch.Tensor, w: torch.Tensor, delta: torch.Tensor):
    """The op's forward from the fp32 master weight ``w [K, N]`` and its
    absmean scale: ``(y, codes [M, Kp], γ [M, 1], wq [K, N])``, the last three
    kept for the backward.  An empty batch (M = 0) or N = 0 launches nothing:
    y is empty, and the gradients do not read the values of the codes, γ and
    wq, which are zeros.  CUDA tensors only."""
    build.require_cuda("bitlinear_forward", x, w, delta)
    _check_x(x, "bitlinear_forward", empty_batch=True)
    if w.dim() != 2 or w.shape[0] != x.shape[1]:
        raise ValueError(f"bitlinear_forward: x {tuple(x.shape)} and w "
                         f"{tuple(w.shape)} must be [M, K] and [K, N]")
    if w.dtype != torch.float32:
        raise TypeError(f"bitlinear_forward: the master weight must be fp32, got "
                        f"{w.dtype}")
    _check_scales(0, None, delta, "bitlinear_forward")
    (m, k), n = x.shape, w.shape[1]
    codes = _empty((m, padded_k(k)), torch.int8, x.device)
    gamma = _empty((m, 1), torch.float32, x.device)
    if m == 0 or n == 0:
        return (_empty((m, n), x.dtype, x.device), codes.zero_(), gamma.zero_(),
                torch.zeros((k, n), dtype=torch.int8, device=x.device))
    wq = _empty((k, n), torch.int8, x.device)
    y = _empty((m, n), x.dtype, x.device)
    _launch(x, None, gamma, codes, w, delta, wq, y)
    return y, codes, gamma, wq


def bitlinear_forward_acc(x: torch.Tensor, w: torch.Tensor, delta: torch.Tensor,
                          gamma: torch.Tensor):
    """A row-parallel shard of the op's forward: x [M, K] is the rank's K
    columns of the rows, quantized with the whole rows' ``gamma`` [M, 1]
    (fp32, given), ``w [K, N]`` the rank's K rows of the master weight,
    ternarized with the whole weight's ``delta``.  Returns ``(acc [M, N]
    fp32, codes [M, Kp], wq [K, N])``: the unscaled int32 accumulators,
    exact in fp32 (|acc| <= 128·K < 2**24), for the caller to sum over the
    shards and scale once by ``(γ/127)·Δ``.  The three device kernels of
    :func:`bitlinear_forward`, the GEMM's epilogue scale set to one (γ =
    127, Δ = 1: exactly 1.0).  CUDA tensors only."""
    build.require_cuda("bitlinear_forward_acc", x, w, delta, gamma)
    _check_x(x, "bitlinear_forward_acc", empty_batch=True)
    if w.dim() != 2 or w.shape[0] != x.shape[1]:
        raise ValueError(f"bitlinear_forward_acc: x {tuple(x.shape)} and w "
                         f"{tuple(w.shape)} must be [M, K] and [K, N]")
    if w.dtype != torch.float32:
        raise TypeError(f"bitlinear_forward_acc: the master weight must be fp32, "
                        f"got {w.dtype}")
    (m, k), n = x.shape, w.shape[1]
    _check_scales(m, gamma, delta, "bitlinear_forward_acc")
    kp = padded_k(k)
    codes = _empty((m, kp), torch.int8, x.device)
    if m == 0 or n == 0:
        return (_empty((m, n), torch.float32, x.device), codes.zero_(),
                torch.zeros((k, n), dtype=torch.int8, device=x.device))
    wq = _empty((k, n), torch.int8, x.device)
    wt = _empty((n, kp), torch.int8, x.device)
    acc = _empty((m, n), torch.float32, x.device)
    unit_gamma = torch.full((m, 1), 127.0, dtype=torch.float32, device=x.device)
    unit_delta = torch.ones((1,), dtype=torch.float32, device=x.device)
    _quant(x, gamma.contiguous(), None, codes)
    _weight(w, delta, wq, wt)
    _gemm(codes, wt, unit_gamma, unit_delta, acc)
    launches.count += 1
    return acc, codes, wq
