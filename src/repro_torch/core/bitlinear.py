"""BitLinear (fp / qat / packed) and SubLN — port of
``repro/core/bitlinear.py``.

Weights keep the JAX layout ``[in, out]`` (``y = x @ w``), so the bridge
copies them without a transpose.  ``fp`` and ``qat`` hold a trainable
``w`` (and ``b``); ``qat`` runs, in the JAX package's order, the bitlinear
CUDA kernel with ``QuantConfig.use_kernel`` (whose backward is the same
STE), else the bf16 absmean path with ``low_precision_quant``, else the
fake-quant forward of ``QuantConfig.scheme`` with STE gradients.  ``packed`` stores ``w_packed`` uint8 ``[in/4, out]`` plus
a scalar ``delta`` as buffers; with ``use_kernel`` the projection runs the
w2a8 CUDA kernel.  ``axes`` are the weight's logical axes (``[in, out]``,
supplied by the caller as in JAX); ``param_axes()`` names each tensor's.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.core import quant as Q
from repro_torch.distributed.sharding import constrain
from repro_torch.nn.module import Axes, DEFAULT_POLICY, DTypePolicy, fan_in_init


class BitLinear(nn.Module):
    """y = quant(x) @ quant(w) + b."""

    def __init__(self, in_dim: int, out_dim: int, use_bias: bool = False,
                 quant: Q.QuantConfig = Q.FP,
                 policy: DTypePolicy = DEFAULT_POLICY,
                 gen: Optional[torch.Generator] = None,
                 device: Optional[torch.device] = None,
                 axes: Tuple[str, str] = ("embed", "mlp")):
        super().__init__()
        self.in_dim, self.out_dim = in_dim, out_dim
        self.use_bias, self.quant, self.policy = use_bias, quant, policy
        self.axes = axes
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
            self.w = nn.Parameter(w)
        if use_bias:
            self.b = nn.Parameter(torch.zeros((out_dim,), dtype=policy.param_dtype,
                                              device=device))

    def param_axes(self) -> Dict[str, Axes]:
        a_in, a_out = self.axes
        if self.quant.mode == "packed":
            ax: Dict[str, Axes] = {"w_packed": (a_in, a_out), "delta": ()}
        else:
            ax = {"w": (a_in, a_out)}
        if self.use_bias:
            ax["b"] = (a_out,)
        return ax

    def forward(self, x: torch.Tensor,
                act_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``act_scale`` (mean |x| per input channel) feeds the awq and gptq
        weight schemes of the plain QAT path; no caller passes it, as in the
        JAX package, so they run with a unit scale."""
        cd = self.policy.compute_dtype
        quant = self.quant
        if quant.mode == "fp":
            y = torch.matmul(x.to(cd), self.w.to(cd))
        elif quant.mode == "qat":
            if quant.use_kernel:
                from repro_torch.kernels.bitlinear import ops as kops
                y = kops.bitlinear_matmul(x.to(cd), self.w.to(torch.float32),
                                          scheme=quant.scheme)
            else:
                xq = Q.fake_quant_act(x.to(cd))
                if quant.low_precision_quant and quant.scheme == "absmean":
                    wq = Q.fake_quant_weight_lp(self.w.to(cd))
                else:
                    wq = Q.fake_quant_weight(self.w.to(torch.float32),
                                             scheme=quant.scheme,
                                             act_scale=act_scale,
                                             block=quant.block)
                y = torch.matmul(xq, constrain(wq.to(cd), self.axes))
        elif quant.mode == "packed":
            y = packed_matmul(x.to(cd), self.w_packed, self.delta, self.in_dim,
                              use_kernel=quant.use_kernel)
        else:
            raise ValueError(f"unknown quant mode {quant.mode!r}")
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
                 device: Optional[torch.device] = None,
                 axis_name: str = "embed"):
        super().__init__()
        self.eps, self.axis_name = eps, axis_name
        self.scale = nn.Parameter(torch.ones((dim,), dtype=policy.param_dtype,
                                             device=device))

    def param_axes(self) -> Dict[str, Axes]:
        return {"scale": (self.axis_name,)}

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
