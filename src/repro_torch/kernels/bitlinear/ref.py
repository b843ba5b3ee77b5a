"""Plain PyTorch version of the bitlinear kernel (same function, same op
order).

Like ``repro/kernels/bitlinear/ref.py::bitlinear_ref`` it multiplies the
int8 codes by the ternary weight; unlike it, it scales as the kernel does,
``acc·((γ/127)·Δ)`` (``repro/kernels/bitlinear/kernel.py:51-53``), so the
card's kernel can be held to it bit for bit.  The codes are multiplied as an
fp32 matmul, which is exact: every partial sum is an integer below 2**24
(|code| <= 128, K <= 2**17).

Beside it, the plain versions of the card kernel's three parts
(``csrc/bitlinear.cu``): the quantizing pass into K-padded int8 codes, the
K-major padded weight, and the product of the two.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core import quant as Q

# the GEMM's K tile (csrc/bitlinear.cu BK, which the card's wrappers read
# from the .cu; tests/test_torch_cuda.py holds this CPU copy equal to it):
# the codes' and the K-major weight's row pitch is K rounded up to it
K_TILE = 128


def padded_k(k: int) -> int:
    return -(-k // K_TILE) * K_TILE


def bitlinear_ref(x: torch.Tensor, wq: torch.Tensor, gamma: torch.Tensor,
                  delta: torch.Tensor) -> torch.Tensor:
    """x [M, K]; wq ternary [K, N]; gamma fp32 [M, 1]; delta fp32 scalar ->
    [M, N] in x.dtype."""
    xq = Q.round_clip(x.to(torch.float32) * Q.div(127.0, gamma + 1e-5),
                      -128.0, 127.0)
    acc = torch.matmul(xq, wq.to(torch.float32))
    scale = Q.div(gamma, 127.0) * delta.to(torch.float32)
    return (acc * scale).to(x.dtype)


def quantize_rows_ref(x: torch.Tensor, gamma: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [M, K] -> (int8 codes [M, Kp], the pad zeros; γ fp32 [M, 1], the row
    absmax unless given)."""
    xf = x.to(torch.float32)
    if gamma is None:
        gamma = xf.abs().amax(dim=-1, keepdim=True)
    q = Q.round_clip(xf * Q.div(127.0, gamma + 1e-5), -128.0, 127.0)
    m, k = x.shape
    codes = torch.zeros((m, padded_k(k)), dtype=torch.int8, device=x.device)
    codes[:, :k] = q.to(torch.int8)
    return codes, gamma


def weight_kmajor_ref(w: torch.Tensor, delta: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(wt [N, Kp] int8, the pad zeros; wq [K, N] int8) from the int8 codes
    ``w``, or from the master weight ``w`` ternarized with ``delta``."""
    if delta is None:
        wq = w
    else:
        wq = Q.round_clip(w.to(torch.float32) / (delta + Q.EPS), -1.0, 1.0
                          ).to(torch.int8)
    k, n = wq.shape
    wt = torch.zeros((n, padded_k(k)), dtype=torch.int8, device=w.device)
    wt[:, :k] = wq.t()
    return wt, wq


def bitlinear_codes_ref(codes: torch.Tensor, wt: torch.Tensor,
                        gamma: torch.Tensor, delta: torch.Tensor,
                        dtype: torch.dtype) -> torch.Tensor:
    """The GEMM's plain version: codes [M, Kp] and wt [N, Kp] -> y [M, N] in
    ``dtype``; the zero pad adds nothing to the exact sum."""
    acc = torch.matmul(codes.to(torch.float32), wt.to(torch.float32).t())
    scale = Q.div(gamma, 127.0) * delta.to(torch.float32)
    return (acc * scale).to(dtype)


def bitlinear_full_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """From the unquantized weight (the BitLinear qat forward): fake-quant
    activations and weights, then matmul."""
    xq, gamma = Q.act_quant_absmax_int8(x)
    deq_x = xq.to(torch.float32) * Q.div(gamma, 127.0)
    qw, delta = Q.weight_quant_absmean(w)
    return torch.matmul(deq_x, qw.to(torch.float32) * delta).to(x.dtype)
