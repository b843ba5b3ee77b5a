"""Public wrapper: the model-layout SSD scan, kernel forward + recomputed
backward.

The forward runs the ssd_scan kernel on CUDA tensors (or the call raises)
and the port's ``ref.ssd_chunked`` on CPU tensors, which is what the
JAX model computes; there is no fallback between them.  The backward
recomputes through the plain ``ssd_chunked`` in fp32 and takes its
gradient (``repro/kernels/ssd_scan/ops.py:41-52``, plain jnp there, plain
PyTorch here, on whichever device the operands are).  The chunked form is
linear in S, so the recompute costs one more forward.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.ssd_scan.kernel import ssd_scan_kernel
from repro_torch.kernels.ssd_scan.ref import ssd_chunked


class _SSDScan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, a, dt, B, C, chunk):
        ctx.chunk = chunk
        ctx.save_for_backward(x, a, dt, B, C)
        if x.device.type == "cuda":
            y, _ = ssd_scan_kernel(x.contiguous(), a.contiguous(), dt.contiguous(),
                                   B.contiguous(), C.contiguous(), chunk)
        elif x.device.type == "cpu":
            y, _ = ssd_chunked(x, a, dt, B, C, chunk=chunk)
        else:
            raise ValueError(f"ssd_scan: unsupported device {x.device}")
        return y

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        with torch.enable_grad():
            ins = [t.detach().to(torch.float32).requires_grad_(True) for t in saved]
            y, _ = ssd_chunked(*ins, chunk=ctx.chunk)
            grads = torch.autograd.grad(y, ins, g.to(torch.float32))
        return (*(gr.to(t.dtype) for gr, t in zip(grads, saved)), None)


def ssd_scan(x: torch.Tensor, a: torch.Tensor, dt: torch.Tensor,
             B: torch.Tensor, C: torch.Tensor, chunk: int = 256) -> torch.Tensor:
    """Model layout: x [b,s,h,p], a/dt [b,s,h], B/C [b,s,n] -> y [b,s,h,p]."""
    return _SSDScan.apply(x, a, dt, B, C, chunk)
