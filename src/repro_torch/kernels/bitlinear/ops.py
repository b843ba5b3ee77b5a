"""Public wrapper: the QAT bitlinear matmul with its STE backward.

The forward runs the bitlinear kernel on a CUDA tensor (or the call raises),
the plain PyTorch version on a CPU tensor, and on a meta tensor returns
empty outputs of the kernel's shapes (a dry run's count); there is no
fallback between them.  Each computes Δ = mean|W| first, as the CUDA route
does before its launch, and runs the rest through ``kernels/boundary.py``.
The backward is the straight-through estimate of
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
from repro_torch.kernels import boundary
from repro_torch.kernels.bitlinear.kernel import bitlinear_forward
from repro_torch.kernels.bitlinear.ref import bitlinear_ref, padded_k


def bitlinear_forward_ref(x2d: torch.Tensor, w: torch.Tensor, delta: torch.Tensor):
    """``bitlinear_forward`` in plain PyTorch: (y, codes [M, K], γ, wq)."""
    xq, gamma = Q.act_quant_absmax_int8(x2d)
    # weight_quant_absmean's codes, from the Δ it would compute
    qw = Q.round_clip(w.to(torch.float32) / (delta + Q.EPS), -1.0, 1.0)
    codes, wq = xq.to(torch.int8), qw.to(w.dtype).to(torch.int8)
    return bitlinear_ref(x2d, wq, gamma, delta), codes, gamma, wq


def bitlinear_forward_meta(x2d: torch.Tensor, w: torch.Tensor, delta: torch.Tensor):
    """``bitlinear_forward``'s outputs on the meta device: y [M, N] in x's
    dtype, the codes [M, Kp] int8 with the GEMM's K pad, γ [M, 1] fp32 and
    wq [K, N] int8."""
    m, k = x2d.shape
    return (x2d.new_empty((m, w.shape[1])),
            x2d.new_empty((m, padded_k(k)), dtype=torch.int8),
            x2d.new_empty((m, 1), dtype=torch.float32),
            w.new_empty(w.shape, dtype=torch.int8))


_FORWARDS = {"cuda": bitlinear_forward, "cpu": bitlinear_forward_ref,
             "meta": bitlinear_forward_meta}


def _fwd_2d(x2d: torch.Tensor, w: torch.Tensor, scheme: str):
    """-> (y, int8 codes [M, >= K], γ [M, 1], wq [K, N] int8, Δ); the card's
    codes carry the GEMM's zero K pad (and so do meta's), the CPU's none."""
    if scheme != "absmean":
        # the kernel takes one per-tensor scale; the JAX route quantizes any
        # scheme's weight with absmean instead of refusing it
        raise ValueError(f"bitlinear kernel path takes the 'absmean' weight "
                         f"scheme only, not {scheme!r}; run {scheme!r} with "
                         "QuantConfig(use_kernel=False)")
    impl = _FORWARDS.get(x2d.device.type)
    if impl is None:
        raise ValueError(f"bitlinear_matmul: unsupported device {x2d.device}")
    delta = Q.absmean_scale(w)
    y, codes, gamma, wq = boundary.call("bitlinear", impl, x2d.contiguous(),
                                        w.contiguous(), delta)
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
