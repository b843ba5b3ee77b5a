"""Public wrapper: the model-layout SSD scan, kernel forward + recomputed
backward.

The forward runs the ssd_scan kernel on CUDA tensors (or the call raises),
the port's ``ref.ssd_chunked`` on CPU tensors, which is what the JAX model
computes, and on meta tensors returns an empty y (a dry run's count); there
is no fallback between them.  Each goes through ``kernels/boundary.py``.  The backward
recomputes through the plain ``ssd_chunked`` in fp32 and takes its
gradient (``repro/kernels/ssd_scan/ops.py:41-52``, plain jnp there, plain
PyTorch here, on whichever device the operands are).  The chunked form is
linear in S, so the recompute costs one more forward.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import boundary
from repro_torch.kernels.ssd_scan.kernel import ssd_scan_kernel
from repro_torch.kernels.ssd_scan.ref import ssd_chunked


def ssd_scan_meta(x, a, dt, B, C, chunk):
    """The kernel's outputs on the meta device: y [b, S, H, P] and the final
    state [b·H, N, P], fp32."""
    b, _, h, p = x.shape
    return x.new_empty(x.shape), x.new_empty((b * h, B.shape[-1], p))


def _ssd_chunked(x, a, dt, B, C, chunk):
    return ssd_chunked(x, a, dt, B, C, chunk=chunk)


_IMPLS = {"cuda": ssd_scan_kernel, "cpu": _ssd_chunked, "meta": ssd_scan_meta}


class _SSDScan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, a, dt, B, C, chunk):
        ctx.chunk = chunk
        ctx.save_for_backward(x, a, dt, B, C)
        impl = _IMPLS.get(x.device.type)
        if impl is None:
            raise ValueError(f"ssd_scan: unsupported device {x.device}")
        y, _ = boundary.call("ssd_scan", impl, x.contiguous(), a.contiguous(),
                             dt.contiguous(), B.contiguous(), C.contiguous(), chunk)
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
