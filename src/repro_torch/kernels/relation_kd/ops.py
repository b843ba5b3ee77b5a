"""Public wrapper: the relation-KD loss, kernel forward + blocked backward.

The forward runs the relation_kd kernel on CUDA tensors (or the call raises),
the plain PyTorch version on CPU tensors and, on meta tensors, returns an
empty [BH, L] (a dry run's count); there is no fallback between them.  Each
goes through ``kernels/boundary.py``.  The kernel is forward-only; the backward (``repro/kernels/
relation_kd/ops.py:49-77``) recomputes P_s and P_t in row blocks, never the
full L×L at once, in plain PyTorch:

  ∂KL_i/∂s_rel(i,k) = P_s(i,k) - P_t(i,k)        (teacher detached)
  ⇒ with W = (P_s - P_t)/temp · d(mean)/d(row):  g_s = W s + Wᵀ s,

then autograd chains through the L2 normalize and the head re-split.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core.quant import div
from repro_torch.kernels import boundary
from repro_torch.kernels.relation_kd.kernel import relation_kl_rows_kernel
from repro_torch.kernels.relation_kd.ref import prep_states, relation_kl_rows_ref

BWD_BLOCK = 512


def relation_kl_rows_meta(s: torch.Tensor, t: torch.Tensor,
                          temp: float = 1.0) -> torch.Tensor:
    """The kernel's output on the meta device: fp32 [BH, L]."""
    return s.new_empty(s.shape[:2], dtype=torch.float32)


_IMPLS = {"cuda": relation_kl_rows_kernel, "cpu": relation_kl_rows_ref,
          "meta": relation_kl_rows_meta}


def relation_kl_rows(s: torch.Tensor, t: torch.Tensor,
                     temp: float = 1.0) -> torch.Tensor:
    """KL rows [BH, L] of normalized s, t [BH, L, D]: the kernel on CUDA
    tensors, the plain version on CPU tensors, empty on meta."""
    impl = _IMPLS.get(s.device.type)
    if impl is None:
        raise ValueError(f"relation_kl_rows: unsupported device {s.device}")
    return boundary.call("relation_kd", impl, s.contiguous(), t.contiguous(), temp)


class _RelationMeanKL(torch.autograd.Function):
    """Mean over the (BH, L) rows of KL; s, t [BH, L, D] normalized."""

    @staticmethod
    def forward(ctx, s, t, temp, block):
        ctx.temp, ctx.block = temp, block
        ctx.save_for_backward(s, t)
        return torch.mean(relation_kl_rows(s, t, temp))

    @staticmethod
    def backward(ctx, g):
        s, t = ctx.saved_tensors
        temp = ctx.temp
        bh, l, _ = s.shape
        scale = g / (bh * l)                      # d(mean)/d(row KL)
        grad = torch.zeros_like(s)
        for r0 in range(0, l, min(ctx.block, l)):
            sl = s[:, r0:r0 + ctx.block]
            tl = t[:, r0:r0 + ctx.block]
            s_rel = div(torch.einsum("bld,bmd->blm", sl, s), temp)
            t_rel = div(torch.einsum("bld,bmd->blm", tl, t), temp)
            w = div(torch.softmax(s_rel, dim=-1) - torch.softmax(t_rel, dim=-1),
                     temp) * scale
            # row term: rows of this block get W @ s; column term: all rows
            # get Wᵀ @ s_rows
            grad[:, r0:r0 + ctx.block] += torch.einsum("blm,bmd->bld", w, s)
            grad += torch.einsum("blm,bld->bmd", w, sl)
        return grad, None, None, None


def relation_kd_loss(student_states: torch.Tensor, teacher_states: torch.Tensor,
                     split_heads: int = 4, temperature: float = 1.0,
                     alphas: Tuple[float, float, float] = (1.0, 1.0, 1.0)
                     ) -> torch.Tensor:
    """[3, B, H, L, Dh] x2 -> scalar Eq. 11 loss (kernel path, 3 launches)."""
    total = torch.zeros((), dtype=torch.float32, device=student_states.device)
    for i in range(3):
        s = prep_states(student_states[i], split_heads)
        t = prep_states(teacher_states[i], split_heads).detach()
        total = total + alphas[i] * _RelationMeanKL.apply(
            s, t, float(temperature), BWD_BLOCK)
    return total
