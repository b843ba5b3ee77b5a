"""Public wrapper: the QAT bitlinear matmul with its STE backward.

The forward runs the bitlinear kernel on a CUDA tensor (or the call raises)
and the plain PyTorch version on a CPU tensor; there is no fallback between
them.  The backward is the straight-through estimate of both quantizers
(``repro/kernels/bitlinear/ops.py:53-63``):

  dx = g @ (Δ·wq)ᵀ ,   dw = x_deqᵀ @ g

in fp32 with ``torch.matmul`` (the JAX backward is plain jnp, outside the
kernel).  The JAX package returns ``dx`` in fp32 even for a bf16 ``x``;
autograd casts it to ``x.dtype`` here.
"""
from __future__ import annotations

import torch

from repro_torch.core import quant as Q
from repro_torch.kernels.bitlinear.kernel import bitlinear_kernel
from repro_torch.kernels.bitlinear.ref import bitlinear_ref


def _fwd_2d(x2d: torch.Tensor, w: torch.Tensor, scheme: str):
    if scheme != "absmean":
        raise NotImplementedError(f"bitlinear kernel path: scheme {scheme!r} is "
                                  "not ported; only 'absmean' is")
    gamma = x2d.to(torch.float32).abs().amax(dim=-1, keepdim=True)
    qw, delta = Q.weight_quant_absmean(w)
    wq = qw.to(torch.int8)
    if x2d.device.type == "cuda":
        y = bitlinear_kernel(x2d.contiguous(), wq, gamma, delta)
    elif x2d.device.type == "cpu":
        y = bitlinear_ref(x2d, wq, gamma, delta)
    else:
        raise ValueError(f"bitlinear_matmul: unsupported device {x2d.device}")
    return y, gamma, wq, delta


class _BitLinearMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x2d, w, scheme):
        y, gamma, wq, delta = _fwd_2d(x2d, w, scheme)
        ctx.save_for_backward(x2d, gamma, wq, delta)
        return y

    @staticmethod
    def backward(ctx, g):
        x2d, gamma, wq, delta = ctx.saved_tensors
        g2d = g.to(torch.float32)
        w_deq = wq.to(torch.float32) * delta
        # STE through the activation quantizer: dequantized activations for dw
        xq = Q.round_clip(x2d.to(torch.float32) * Q.div(127.0, gamma + 1e-5),
                          -128.0, 127.0)
        x_deq = xq * Q.div(gamma, 127.0)
        dx = torch.matmul(g2d, w_deq.t())
        dw = torch.matmul(x_deq.t(), g2d)
        return dx, dw, None


def bitlinear_matmul(x: torch.Tensor, w: torch.Tensor,
                     scheme: str = "absmean") -> torch.Tensor:
    """x [..., K] float; w [K, N] float (the unquantized master weight) ->
    [..., N] in x's dtype."""
    lead = x.shape[:-1]
    y = _BitLinearMatmul.apply(x.reshape(-1, x.shape[-1]), w, scheme)
    return y.reshape(*lead, w.shape[-1])
