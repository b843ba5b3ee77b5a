"""Plain PyTorch version of the w2a8 kernel (same function, same op order).

Unlike the JAX ``w2a8_ref`` (which scales as ``acc·(γ/127)·Δ``) this keeps the
kernel's order ``acc·((γ/127)·Δ)`` (``repro/kernels/w2a8_gemv/kernel.py:45,53``)
so the card's kernel can be held to it bit for bit; the integer products are
summed exactly (see ``core.bitlinear.packed_matmul``).
"""
from __future__ import annotations

import torch

from repro_torch.core import quant as Q


def w2a8_ref(x: torch.Tensor, wp: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    """x [M, K]; wp uint8 [K//4, N]; delta fp32 scalar -> [M, N] in x.dtype."""
    k = x.shape[-1]
    wq = Q.unpack_ternary(wp, k)
    xf = x.to(torch.float32)
    gamma = xf.abs().amax(dim=-1, keepdim=True)
    xq = Q.round_clip(xf * Q.div(127.0, gamma + 1e-5), -128.0, 127.0)
    acc = torch.matmul(xq, wq.to(torch.float32))
    scale = Q.div(gamma, 127.0) * delta.to(torch.float32)
    return (acc * scale).to(x.dtype)
