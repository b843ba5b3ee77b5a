"""Public wrapper for the packed ternary matmul (inference only).

A CUDA tensor goes to the hand-written kernel (or the call raises); a CPU
tensor goes to the plain PyTorch version.  There is no fallback between them.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.w2a8_gemv.kernel import w2a8_kernel
from repro_torch.kernels.w2a8_gemv.ref import w2a8_ref


def w2a8_matmul(x: torch.Tensor, wp: torch.Tensor,
                delta: torch.Tensor) -> torch.Tensor:
    """x [..., K] float; wp uint8 [K//4, N]; delta scalar -> [..., N]."""
    lead = x.shape[:-1]
    x2d = x.reshape(-1, x.shape[-1])
    if x.device.type == "cuda":
        y = w2a8_kernel(x2d.contiguous(), wp, delta)
    elif x.device.type == "cpu":
        y = w2a8_ref(x2d, wp, delta)
    else:
        raise ValueError(f"w2a8_matmul: unsupported device {x.device}")
    return y.reshape(*lead, wp.shape[-1])
