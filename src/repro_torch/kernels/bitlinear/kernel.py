"""QAT ternary matmul (bitlinear) on the card: binding of ``csrc/bitlinear.cu``.

Replaces the TPU kernel ``repro/kernels/bitlinear/kernel.py::bitlinear_kernel``:

  y[M, N] = ( q8(x) @ wq ) · ((γ/127) · Δ),
  q8 = clip(rint(x · (127/(γ + 1e-5))), -128, 127),

with wq the ternary weight as int8 ``[K, N]`` (per-tensor scale Δ), γ the
per-row absmax of x (fp32 ``[M, 1]``, from the wrapper) and int32
accumulation, so the result equals the plain version bit for bit.

Bound on the H100: at the training shapes (M = 2048, K, N in 1024..3072)
the int8 operations at 1979 TOP/s and the bytes at 3.35 TB/s take about
the same few microseconds.  Design: 128 x 128 output tiles, 8 warps issuing
``mma.sync`` m16n8k32 s8 on int8 tiles staged in shared memory (x quantized
on the way in, the weight transposed to [n][k]); see the .cu for details.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

launches = build.LaunchCounter("bitlinear")


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
    n = wq.shape[1]
    if wq.dtype != torch.int8:
        raise TypeError(f"bitlinear_kernel: wq must be int8, got {wq.dtype}")
    if gamma.dtype != torch.float32 or gamma.numel() != m:
        raise TypeError("bitlinear_kernel: gamma must be fp32 with one value "
                        "per row of x")
    if delta.dtype != torch.float32 or delta.numel() != 1:
        raise TypeError("bitlinear_kernel: delta must be one fp32 value")
    code = build.dtype_code(x, "bitlinear_kernel")
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if m == 0 or n == 0:
        return y
    lib = build.library()
    err = lib.bitlinear_launch(x.data_ptr(), wq.data_ptr(), gamma.data_ptr(),
                               delta.data_ptr(), y.data_ptr(), m, k, n, code,
                               build.stream_ptr(x.device))
    build.check(err, "bitlinear")
    launches.count += 1
    return y
