"""Public wrappers for the packed ternary matmul (inference only), and the
accumulators of a row-parallel shard of it (``w2a8_matmul_acc``).

A CUDA tensor goes to the hand-written kernel (or the call raises); a CPU
tensor goes to the plain PyTorch version; a meta tensor gets an empty
output of the kernel's shape and dtype (a dry run's count).  There is no
fallback between them.  Each goes through ``kernels/boundary.py``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import boundary
from repro_torch.kernels.w2a8_gemv.kernel import w2a8_forward_acc, w2a8_kernel
from repro_torch.kernels.w2a8_gemv.ref import w2a8_forward_acc_ref, w2a8_ref


def w2a8_meta(x: torch.Tensor, wp: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    """The kernel's output on the meta device: y [M, N] in x's dtype."""
    return x.new_empty((x.shape[0], wp.shape[-1]))


def w2a8_matmul(x: torch.Tensor, wp: torch.Tensor,
                delta: torch.Tensor) -> torch.Tensor:
    """x [..., K] float; wp uint8 [K//4, N]; delta scalar -> [..., N]."""
    lead = x.shape[:-1]
    x2d = x.reshape(-1, x.shape[-1])
    if x.device.type == "cuda":
        y = boundary.call("w2a8_gemv", w2a8_kernel, x2d.contiguous(), wp, delta)
    elif x.device.type == "cpu":
        y = boundary.call("w2a8_gemv", w2a8_ref, x2d, wp, delta)
    elif x.device.type == "meta":
        y = boundary.call("w2a8_gemv", w2a8_meta, x2d, wp, delta)
    else:
        raise ValueError(f"w2a8_matmul: unsupported device {x.device}")
    return y.reshape(*lead, wp.shape[-1])


def w2a8_forward_acc_meta(x: torch.Tensor, wp: torch.Tensor,
                          gamma: torch.Tensor) -> torch.Tensor:
    """The accumulators on the meta device: [M, N] fp32."""
    return x.new_empty((x.shape[0], wp.shape[-1]), dtype=torch.float32)


def w2a8_matmul_acc(x2d: torch.Tensor, wp: torch.Tensor,
                    gamma: torch.Tensor) -> torch.Tensor:
    """x [M, K] (a row shard's columns); wp uint8 [K//4, N]; gamma fp32
    [M, 1] -> the unscaled fp32 accumulators [M, N] (``w2a8_forward_acc``)."""
    if x2d.device.type == "cuda":
        return boundary.call("w2a8_forward_acc", w2a8_forward_acc, x2d.contiguous(),
                             wp.contiguous(), gamma.contiguous())
    if x2d.device.type == "cpu":
        return boundary.call("w2a8_forward_acc", w2a8_forward_acc_ref, x2d, wp, gamma)
    if x2d.device.type == "meta":
        return boundary.call("w2a8_forward_acc", w2a8_forward_acc_meta, x2d, wp, gamma)
    raise ValueError(f"w2a8_matmul_acc: unsupported device {x2d.device}")
