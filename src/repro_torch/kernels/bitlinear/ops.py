"""Public wrapper: the QAT bitlinear matmul with its STE backward.

The forward runs the bitlinear kernel on a CUDA tensor (or the call raises)
and the plain PyTorch version on a CPU tensor; there is no fallback between
them.  The backward is the straight-through estimate of
both quantizers (``repro/kernels/bitlinear/ops.py:53-63``):

  dx = g @ (Δ·wq)ᵀ ,   dw = x_deqᵀ @ g ,   x_deq = codes · (γ/127)

in fp32 with ``torch.matmul`` (the JAX backward is plain jnp, outside the
kernel).  The forward's int8 activation codes are kept for it (1 byte per
element instead of x's 2 or 4): they are the values the JAX backward
recomputes from x and γ, so the gradients are the same bit for bit.  The JAX
package returns ``dx`` in fp32 even for a bf16 ``x``; autograd casts it to
``x.dtype`` here.
"""
from __future__ import annotations

import torch

from repro_torch.core import quant as Q
from repro_torch.kernels.bitlinear.kernel import bitlinear_forward
from repro_torch.kernels.bitlinear.ref import bitlinear_ref


def _fwd_2d(x2d: torch.Tensor, w: torch.Tensor, scheme: str):
    """-> (y, int8 codes [M, >= K], γ [M, 1], wq [K, N] int8, Δ); the card's
    codes carry the GEMM's zero K pad, the CPU's none."""
    if scheme != "absmean":
        # the kernel takes one per-tensor scale; the JAX route quantizes any
        # scheme's weight with absmean instead of refusing it
        raise ValueError(f"bitlinear kernel path takes the 'absmean' weight "
                         f"scheme only, not {scheme!r}; run {scheme!r} with "
                         "QuantConfig(use_kernel=False)")
    if x2d.device.type == "cuda":
        delta = Q.absmean_scale(w)
        y, codes, gamma, wq = bitlinear_forward(x2d.contiguous(), w.contiguous(),
                                                delta)
    elif x2d.device.type == "cpu":
        xq, gamma = Q.act_quant_absmax_int8(x2d)
        qw, delta = Q.weight_quant_absmean(w)
        codes, wq = xq.to(torch.int8), qw.to(torch.int8)
        y = bitlinear_ref(x2d, wq, gamma, delta)
    else:
        raise ValueError(f"bitlinear_matmul: unsupported device {x2d.device}")
    return y, codes, gamma, wq, delta


class _BitLinearMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x2d, w, scheme):
        y, codes, gamma, wq, delta = _fwd_2d(x2d, w, scheme)
        ctx.save_for_backward(codes, gamma, wq, delta)
        return y

    @staticmethod
    def backward(ctx, g):
        codes, gamma, wq, delta = ctx.saved_tensors
        g2d = g.to(torch.float32)
        w_deq = wq.to(torch.float32) * delta
        # STE through the activation quantizer: the saved codes, dequantized
        x_deq = codes[:, :wq.shape[0]].to(torch.float32) * Q.div(gamma, 127.0)
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
