"""Packed-ternary matmul (w2a8) on the card: binding of ``csrc/w2a8_gemv.cu``.

Replaces the TPU kernel ``repro/kernels/w2a8_gemv/kernel.py::w2a8_kernel``:

  y[M, N] = ( q8(x) @ unpack(wp) ) · (γ/127 · Δ),
  q8 = clip(rint(x · 127/(γ + 1e-5)), -128, 127),   γ = max|x| per row,

with wp uint8 ``[K/4, N]`` (four ternary weights per byte, little-endian
along K) and int32 accumulation, so the result equals the plain version bit
for bit.  The weight stays packed in device memory on both routes.

Bound on the H100: at decode rows (M ≤ 8) the packed weight bytes, K·N/4,
read once (well under a microsecond: latency sets the time); at a chunk
step's rows (M = 8·32 = 256) the int8 operations on the tensor cores and the
bytes are about even.  So the wrapper routes on M (see the .cu):

* ``"splitk"`` (M ≤ ``split_k_max_m()``): one launch over column tiles ×
  K splits, each CTA quantizing only its K slice and unpacking to ``dp4a``,
  the splits' int32 sums meeting by ``atomicAdd`` in a zeroed workspace kept
  per stream (the last split of a tile scales, writes y and zeroes it
  again);
* ``"wgmma"`` (larger M): bitlinear's quantizing pass into a codes buffer
  kept per stream, then int8 ``wgmma`` fed by TMA, the packed tile unpacked
  into the K-major shared-memory operand by a producer warpgroup.

Both routes enter C once per call; the launch counter counts one per call.

``w2a8_forward_acc`` is a row-parallel shard of the product under a
tensor-parallel split (``core/bitlinear.py``): x the rank's K columns, wp its
K/4 packed rows, γ given (the whole rows', maximized over the ranks), and the
fp32 accumulators ``q8(x) @ unpack(wp)`` returned unscaled for the ranks to
sum before the one scale (γ/127)·Δ.  The same routes by M, stopping before
the scale (``w2a8_gemv_acc_launch``); its own launch counter.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import build

launches = build.LaunchCounter("w2a8_gemv")
acc_launches = build.LaunchCounter("w2a8_forward_acc")

ROUTES = {"splitk": 0, "wgmma": 1}
_INFO_KEYS = ("split_k_max_m", "bm", "bn", "k_tile", "stages", "smem_bytes")


@functools.lru_cache(maxsize=None)
def gemm_info() -> dict:
    """The route threshold and the tensor-core route's tiles, ring depth and
    dynamic shared memory per CTA, from the .cu."""
    out = (ctypes.c_longlong * len(_INFO_KEYS))()
    build.library().w2a8_gemv_info(out)
    return dict(zip(_INFO_KEYS, out))


# the threshold and the K tile, read from the .cu on first use (each call
# of the wrapper reads them; serving makes ~200 calls a step)
_SPLIT_K_MAX_M = _K_TILE = 0


def _k_tile() -> int:
    global _K_TILE
    _K_TILE = gemm_info()["k_tile"]
    return _K_TILE


def split_k_max_m() -> int:
    """M at and below which a call takes the split-K route."""
    global _SPLIT_K_MAX_M
    if not _SPLIT_K_MAX_M:
        _SPLIT_K_MAX_M = gemm_info()["split_k_max_m"]
    return _SPLIT_K_MAX_M


def route_for(m: int, n: int, wp_ptr: int) -> str:
    """The route a call of M rows and N columns takes: split-K up to the
    threshold, and where TMA cannot read the packed weight (N not a multiple
    of 16, or the weight at ``wp_ptr`` not 16-byte aligned)."""
    if m <= (_SPLIT_K_MAX_M or split_k_max_m()) or n % 16 or wp_ptr % 16:
        return "splitk"
    return "wgmma"


# buffers kept per (device, stream), since the launches of one stream run
# in order: the split-K workspace (int32, zero between calls) and the codes
# buffer (γ, then the int8 codes [rows_cap, Kp])
_workspace: Dict[Tuple[torch.device, int], torch.Tensor] = {}
_codes: Dict[Tuple[torch.device, int], Tuple[torch.Tensor, int, int]] = {}


def _workspace_ptr(ints: int, device: torch.device, stream: int) -> int:
    buf = _workspace.get((device, stream))
    if buf is None or buf.numel() < ints:
        buf = torch.zeros((max(ints, 1 << 16),), dtype=torch.int32, device=device)
        _workspace[(device, stream)] = buf
    return buf.data_ptr()


def _codes_ptr(m: int, kp: int, device: torch.device, stream: int
               ) -> Tuple[int, int]:
    """(pointer, rows) of a codes buffer of at least m rows of pitch kp: γ
    [rows] fp32, then the codes 1024-aligned (the .cu's ``codes_offset``).
    Its tensor map is encoded once per pitch while the buffer lives."""
    buf, rows, kp_cap = _codes.get((device, stream), (None, 0, 0))
    if rows < m or kp_cap < kp:
        rows, kp_cap = max(m, rows, 256), max(kp, kp_cap)
        offset = (4 * rows + 1023) // 1024 * 1024
        buf = torch.empty((offset + rows * kp_cap,), dtype=torch.uint8,
                          device=device)
        _codes[(device, stream)] = (buf, rows, kp_cap)
    return buf.data_ptr(), rows


def w2a8_kernel(x: torch.Tensor, wp: torch.Tensor, delta: torch.Tensor,
                route: Optional[str] = None) -> torch.Tensor:
    """x [M, K] fp32/bf16; wp uint8 [K//4, N]; delta fp32 scalar -> y [M, N]
    in x's dtype.  ``route`` ("splitk" or "wgmma") overrides the choice by M
    (for tests and timing).  CUDA tensors only."""
    build.require_cuda("w2a8_kernel", x, wp, delta)
    if x.dim() != 2 or wp.dim() != 2:
        raise ValueError(f"w2a8_kernel: x {tuple(x.shape)} and wp "
                         f"{tuple(wp.shape)} must be 2-D")
    m, k = x.shape
    kp, n = wp.shape
    if kp * 4 != k:
        raise ValueError(f"wp has {kp} packed rows but x has k={k} columns; "
                         "wp must have exactly k/4 rows")
    if wp.dtype != torch.uint8:
        raise TypeError(f"w2a8_kernel: wp must be uint8, got {wp.dtype}")
    if delta.dtype != torch.float32 or delta.numel() != 1:
        raise TypeError("w2a8_kernel: delta must be one fp32 value")
    code = build.dtype_code(x, "w2a8_kernel")
    dev = x.device
    y = torch.empty((m, n), dtype=x.dtype, device=dev)
    if m == 0 or n == 0 or k == 0:
        return y.zero_()
    wp_ptr = wp.data_ptr()
    if route is None:
        route = route_for(m, n, wp_ptr)
    elif route not in ROUTES:
        raise ValueError(f"w2a8_kernel: route {route!r} is not one of {sorted(ROUTES)}")
    stream = build.stream_ptr(dev)
    scratch = rows = ws = None
    if route == "wgmma":
        tile = _K_TILE or _k_tile()
        scratch, rows = _codes_ptr(m, -(-k // tile) * tile, dev, stream)
    else:
        ws = _workspace_ptr(m * (n + (n + 127) // 128), dev, stream)
    err = build.library().w2a8_gemv_launch(
        x.data_ptr(), wp_ptr, delta.data_ptr(), y.data_ptr(), m, k, n, code,
        ROUTES[route], scratch, rows or 0, ws, stream)
    if err:
        build.check(err, f"w2a8_gemv ({route})")
    launches.count += 1
    return y


def w2a8_forward_acc(x: torch.Tensor, wp: torch.Tensor, gamma: torch.Tensor,
                     route: Optional[str] = None) -> torch.Tensor:
    """x [M, K] fp32/bf16 (a row shard's columns); wp uint8 [K//4, N] (its
    packed rows); gamma fp32 [M, 1] (the whole rows' absmax) -> acc [M, N]
    fp32, the unscaled integer sums (exact while 128·K_whole < 2**24: the
    caller's bound).  ``route`` as for :func:`w2a8_kernel`.  CUDA tensors
    only."""
    build.require_cuda("w2a8_forward_acc", x, wp, gamma)
    if x.dim() != 2 or wp.dim() != 2:
        raise ValueError(f"w2a8_forward_acc: x {tuple(x.shape)} and wp "
                         f"{tuple(wp.shape)} must be 2-D")
    m, k = x.shape
    kp, n = wp.shape
    if kp * 4 != k:
        raise ValueError(f"w2a8_forward_acc: wp has {kp} packed rows but x has "
                         f"k={k} columns; wp must have exactly k/4 rows")
    if wp.dtype != torch.uint8:
        raise TypeError(f"w2a8_forward_acc: wp must be uint8, got {wp.dtype}")
    if gamma.dtype != torch.float32 or gamma.numel() != m:
        raise TypeError(f"w2a8_forward_acc: gamma must be {m} fp32 values, got "
                        f"{gamma.numel()} {gamma.dtype}")
    code = build.dtype_code(x, "w2a8_forward_acc")
    dev = x.device
    acc = torch.empty((m, n), dtype=torch.float32, device=dev)
    if m == 0 or n == 0 or k == 0:
        return acc.zero_()
    wp_ptr = wp.data_ptr()
    if route is None:
        route = route_for(m, n, wp_ptr)
    elif route not in ROUTES:
        raise ValueError(f"w2a8_forward_acc: route {route!r} is not one of "
                         f"{sorted(ROUTES)}")
    stream = build.stream_ptr(dev)
    scratch = rows = ws = None
    if route == "wgmma":
        tile = _K_TILE or _k_tile()
        scratch, rows = _codes_ptr(m, -(-k // tile) * tile, dev, stream)
    else:
        ws = _workspace_ptr(m * (n + (n + 127) // 128), dev, stream)
    err = build.library().w2a8_gemv_acc_launch(
        x.data_ptr(), wp_ptr, gamma.data_ptr(), acc.data_ptr(), m, k, n, code,
        ROUTES[route], scratch, rows or 0, ws, stream)
    if err:
        build.check(err, f"w2a8_forward_acc ({route})")
    acc_launches.count += 1
    return acc
