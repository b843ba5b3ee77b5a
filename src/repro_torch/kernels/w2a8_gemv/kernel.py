"""Packed-ternary matmul (w2a8) on the card: binding of ``csrc/w2a8_gemv.cu``.

Replaces the TPU kernel ``repro/kernels/w2a8_gemv/kernel.py::w2a8_kernel``:

  y[M, N] = ( q8(x) @ unpack(wp) ) · (γ/127 · Δ),
  q8 = clip(rint(x · 127/(γ + 1e-5)), -128, 127),   γ = max|x| per row,

with wp uint8 ``[K/4, N]`` (four ternary weights per byte, little-endian
along K) and int32 accumulation.  The kernel takes γ itself (a warp
reduction over each row it quantizes) instead of a separate absmax pass.

Bound on the H100: at decode widths (M <= 8) the packed weight bytes,
K·N/4, read once from device memory; the integer work is far below the
card's rate.  Design: one CTA per 32 consecutive output columns and 8
activation rows, coalesced 32-byte sector reads of the packed rows split
across 8 warps along K, int8 codes staged in shared memory, 2-bit unpack in
registers after the load (see the .cu for details).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

launches = build.LaunchCounter("w2a8_gemv")


def w2a8_kernel(x: torch.Tensor, wp: torch.Tensor,
                delta: torch.Tensor) -> torch.Tensor:
    """x [M, K] fp32/bf16; wp uint8 [K//4, N]; delta fp32 scalar -> y [M, N]
    in x's dtype.  CUDA tensors only."""
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
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if m == 0 or n == 0:
        return y
    lib = build.library()
    err = lib.w2a8_gemv_launch(x.data_ptr(), wp.data_ptr(), delta.data_ptr(),
                               y.data_ptr(), m, k, n, code,
                               build.stream_ptr(x.device))
    build.check(err, "w2a8_gemv")
    launches.count += 1
    return y
