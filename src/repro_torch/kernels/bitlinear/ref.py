"""Plain PyTorch version of the bitlinear kernel (same function, same op
order).

Like ``repro/kernels/bitlinear/ref.py::bitlinear_ref`` it multiplies the
int8 codes by the ternary weight; unlike it, it scales as the kernel does,
``acc·((γ/127)·Δ)`` (``repro/kernels/bitlinear/kernel.py:51-53``), so the
card's kernel can be held to it bit for bit.  The codes are multiplied as an
fp32 matmul, which is exact: every partial sum is an integer below 2**24
(|code| <= 128, K <= 2**17).
"""
from __future__ import annotations

import torch

from repro_torch.core import quant as Q


def bitlinear_ref(x: torch.Tensor, wq: torch.Tensor, gamma: torch.Tensor,
                  delta: torch.Tensor) -> torch.Tensor:
    """x [M, K]; wq ternary [K, N]; gamma fp32 [M, 1]; delta fp32 scalar ->
    [M, N] in x.dtype."""
    xq = Q.round_clip(x.to(torch.float32) * Q.div(127.0, gamma + 1e-5),
                      -128.0, 127.0)
    acc = torch.matmul(xq, wq.to(torch.float32))
    scale = Q.div(gamma, 127.0) * delta.to(torch.float32)
    return (acc * scale).to(x.dtype)


def bitlinear_full_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """From the unquantized weight (the BitLinear qat forward): fake-quant
    activations and weights, then matmul."""
    xq, gamma = Q.act_quant_absmax_int8(x)
    deq_x = xq.to(torch.float32) * Q.div(gamma, 127.0)
    qw, delta = Q.weight_quant_absmean(w)
    return torch.matmul(deq_x, qw.to(torch.float32) * delta).to(x.dtype)
