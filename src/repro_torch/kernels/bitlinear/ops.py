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

Under a tensor-parallel split (``shard=(kind, split)``, from
``core/bitlinear.py``) the weight is the rank's shard and Δ the whole
weight's (a float64 sum of |W| over the shards, ``Q.absmean_scale``):

* ``"col"`` (the out axis split): the kernel on the rank's N columns, γ
  local (K is whole), so each output column is the unsharded layer's;
* ``"row"`` (the in axis split): x is the rank's K columns; γ is the rows'
  absmax maximized over the shards, the kernel returns the unscaled
  accumulators (:func:`kernel.bitlinear_forward_acc`), which sum exactly
  over the shards (*g*), then are scaled once by ``(γ/127)·Δ``: the
  unsharded output bit for bit.

The backward stays rank-local (the gradient of the row-parallel sum is the
identity); ``dx`` of a column-parallel layer is summed by the caller's *f*.
A given ``delta`` (columns picked from a weight used whole, ``BitLinear.
forward_cols``) is the whole weight's Δ, used as it is.
"""
from __future__ import annotations

import torch

from repro_torch.core import quant as Q
from repro_torch.kernels import boundary
from repro_torch.kernels.bitlinear.kernel import (bitlinear_forward,
                                                 bitlinear_forward_acc)
from repro_torch.kernels.bitlinear.ref import (bitlinear_ref, padded_k,
                                              quantize_rows_ref)

# the largest whole K whose accumulators stay exact in fp32 (128·K < 2**24)
MAX_ROW_K = (1 << 24) // 128 - 1


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


def bitlinear_forward_acc_ref(x2d: torch.Tensor, w: torch.Tensor,
                              delta: torch.Tensor, gamma: torch.Tensor):
    """``bitlinear_forward_acc`` in plain PyTorch: (acc fp32 [M, N], codes
    [M, K], wq)."""
    codes, _ = quantize_rows_ref(x2d, gamma)
    codes = codes[:, :x2d.shape[1]]
    wq = Q.round_clip(w.to(torch.float32) / (delta + Q.EPS), -1.0, 1.0
                      ).to(torch.int8)
    acc = torch.matmul(codes.to(torch.float32), wq.to(torch.float32))
    return acc, codes, wq


def bitlinear_forward_acc_meta(x2d: torch.Tensor, w: torch.Tensor,
                               delta: torch.Tensor, gamma: torch.Tensor):
    m, k = x2d.shape
    return (x2d.new_empty((m, w.shape[1]), dtype=torch.float32),
            x2d.new_empty((m, padded_k(k)), dtype=torch.int8),
            w.new_empty(w.shape, dtype=torch.int8))


_FORWARDS = {"cuda": bitlinear_forward, "cpu": bitlinear_forward_ref,
             "meta": bitlinear_forward_meta}
_ACC_FORWARDS = {"cuda": bitlinear_forward_acc, "cpu": bitlinear_forward_acc_ref,
                 "meta": bitlinear_forward_acc_meta}


def _whole_scale(w: torch.Tensor, split) -> torch.Tensor:
    """Δ of the whole weight from the rank's shard ``w`` (both routes split
    the weight over ``"model"``); the unsharded call on one rank."""
    if split.size == 1:
        return Q.absmean_scale(w)
    return Q.absmean_scale(w, (split.sum64, w.numel() * split.size))


def _fwd_2d(x2d: torch.Tensor, w: torch.Tensor, scheme: str, shard=None,
            delta=None):
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
    if shard is None:
        delta = Q.absmean_scale(w) if delta is None else delta
    else:
        kind, split = shard
        delta = _whole_scale(w, split)
        if kind == "row":
            return _row_2d(x2d, w, delta, split)
    y, codes, gamma, wq = boundary.call("bitlinear", impl, x2d.contiguous(),
                                        w.contiguous(), delta)
    return y, codes, gamma, wq, delta


def _row_2d(x2d: torch.Tensor, w: torch.Tensor, delta: torch.Tensor, split):
    """The row-parallel forward (see the module's docstring)."""
    k_whole = x2d.shape[1] * split.size
    if x2d.shape[1] == 0 or k_whole > MAX_ROW_K:
        raise ValueError(
            f"bitlinear row-parallel shard: K {x2d.shape[1]} of {k_whole} over "
            f"{split.size} ranks; the kernel takes a non-empty K slice of a "
            f"whole K <= {MAX_ROW_K}, where the summed int32 accumulators stay "
            "exact in fp32")
    gamma = split.all_max(x2d.to(torch.float32).abs().amax(dim=-1, keepdim=True))
    impl = _ACC_FORWARDS[x2d.device.type]
    acc, codes, wq = boundary.call("bitlinear", impl, x2d.contiguous(),
                                   w.contiguous(), delta, gamma)
    acc = split.acc_sum(acc)
    y = (acc * (Q.div(gamma, 127.0) * delta)).to(x2d.dtype)
    return y, codes, gamma, wq, delta


class _BitLinearMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x2d, w, scheme, shard, delta):
        y, codes, gamma, wq, delta = _fwd_2d(x2d, w, scheme, shard, delta)
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
        return dx, dw, None, None, None


def bitlinear_matmul(x: torch.Tensor, w: torch.Tensor,
                     scheme: str = "absmean", shard=None,
                     delta=None) -> torch.Tensor:
    """x [..., K] float; w [K, N] float (the unquantized master weight) ->
    [..., N] in x's dtype.  ``shard``: ``("col" | "row", split)`` for a
    tensor-parallel shard of the layer; ``delta``: Δ of the weight ``w``'s
    columns were picked from (see the module's docstring)."""
    lead = x.shape[:-1]
    y = _BitLinearMatmul.apply(x.reshape(-1, x.shape[-1]), w, scheme, shard, delta)
    return y.reshape(*lead, w.shape[-1])
