"""BitLinear (fp / qat forward / packed) and SubLN — port of
``repro/core/bitlinear.py``.

Weights keep the JAX layout ``[in, out]`` (``y = x @ w``), so the bridge
copies them without a transpose.  ``packed`` stores ``w_packed`` uint8
``[in/4, out]`` plus a scalar ``delta`` as buffers; with
``QuantConfig.use_kernel`` the projection runs the w2a8 CUDA kernel.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from repro_torch.core import quant as Q
from repro_torch.nn.module import DEFAULT_POLICY, DTypePolicy, fan_in_init


class BitLinear(nn.Module):
    """y = quant(x) @ quant(w) + b."""

    def __init__(self, in_dim: int, out_dim: int, use_bias: bool = False,
                 quant: Q.QuantConfig = Q.FP,
                 policy: DTypePolicy = DEFAULT_POLICY,
                 gen: Optional[torch.Generator] = None,
                 device: Optional[torch.device] = None):
        super().__init__()
        self.in_dim, self.out_dim = in_dim, out_dim
        self.use_bias, self.quant, self.policy = use_bias, quant, policy
        if gen is not None:
            w = fan_in_init(gen, (in_dim, out_dim), policy.param_dtype, device)
        else:
            w = torch.zeros((in_dim, out_dim), dtype=policy.param_dtype,
                            device=device)
        if quant.mode == "packed":
            p = convert_linear_params_fp_to_packed(w)
            self.register_buffer("w_packed", p["w_packed"])
            self.register_buffer("delta", p["delta"])
        else:
            self.w = nn.Parameter(w, requires_grad=False)
        if use_bias:
            self.b = nn.Parameter(torch.zeros((out_dim,), dtype=policy.param_dtype,
                                              device=device),
                                  requires_grad=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cd = self.policy.compute_dtype
        mode = self.quant.mode
        if mode == "fp":
            y = torch.matmul(x.to(cd), self.w.to(cd))
        elif mode == "qat":
            q, gamma = Q.act_quant_absmax_int8(x.to(cd))
            xq = (q.to(torch.float32) * Q.div(gamma, 127.0)).to(cd)
            wq, delta = Q.weight_quant_absmean(self.w.to(torch.float32))
            y = torch.matmul(xq, (wq.to(torch.float32) * delta).to(cd))
        elif mode == "packed":
            y = packed_matmul(x.to(cd), self.w_packed, self.delta, self.in_dim,
                              use_kernel=self.quant.use_kernel)
        else:
            raise ValueError(f"unknown quant mode {mode!r}")
        if self.use_bias:
            y = y + self.b.to(cd)
        return y


def packed_matmul(x: torch.Tensor, w_packed: torch.Tensor, delta: torch.Tensor,
                  k: int, use_kernel: bool = False) -> torch.Tensor:
    """Ternary matmul with 2-bit packed weights.

    Plain path: unpack -> int8 codes -> exact integer matmul -> rescale.  The
    codes are integers below 2**24 in every partial sum (|x_q| <= 128, K terms),
    so an fp32 matmul of them is exact in any order and on any device; it
    stands in for the int32 matmul that CUDA's torch lacks.
    Kernel path: the fused unpack + GEMV CUDA kernel (kernels/w2a8_gemv)."""
    if use_kernel:
        from repro_torch.kernels.w2a8_gemv import ops as kops
        return kops.w2a8_matmul(x, w_packed, delta)
    wq = Q.unpack_ternary(w_packed, k)
    xq, gamma = Q.act_quant_absmax_int8(x)
    acc = torch.matmul(xq.to(torch.float32), wq.to(torch.float32))
    scale = Q.div(gamma, 127.0) * delta
    return (acc * scale).to(x.dtype)


class SubLN(nn.Module):
    """Eqs. 4-5: RMSNorm with learned scale, inserted before W_out."""

    def __init__(self, dim: int, eps: float = 1e-6,
                 policy: DTypePolicy = DEFAULT_POLICY,
                 device: Optional[torch.device] = None):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones((dim,), dtype=policy.param_dtype,
                                             device=device),
                                  requires_grad=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.to(torch.float32)
        var = torch.mean(xf * xf, dim=-1, keepdim=True)
        y = xf * torch.rsqrt(var + self.eps)
        return (y * self.scale.to(torch.float32)).to(x.dtype)


def convert_linear_params_fp_to_packed(w: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Offline conversion of a trained QAT weight [K, N] to the packed form."""
    qw, delta = Q.weight_quant_absmean(w)
    return {"w_packed": Q.pack_ternary(qw.to(torch.int8)),
            "delta": delta.to(torch.float32)}
