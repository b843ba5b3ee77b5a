"""Mamba2 SSD chunked scan on the card: binding of ``csrc/ssd_scan.cu``.

Replaces the TPU kernel ``repro/kernels/ssd_scan/kernel.py::ssd_scan_kernel``:
per (batch row, head) and chunk of Q steps (Q the largest divisor of S that
is at most ``chunk``), with la = cumsum(log(max(a, 1e-20))),

  y_q    = Σ_{k≤q} (C_q·B_k) exp(la_q − la_k) dt_k x_k + exp(la_q) C_q·h
  h_next = h exp(la_last) + Σ_k B_k (dt_k exp(la_last − la_k)) x_k,

returning y and the final state h.  The operands stay in the model's layout
(x [b, S, H, P], a/dt [b, S, H], B/C [b, S, N]): the kernel reads B and C
once per head instead of the TPU wrapper's per-head copies; the TPU
kernel's [BH, S, P] layout is the case H = 1.

Bound on the H100: the work the function needs, Q(Q+1)·P + 4·Q·N·P
operations per (bh, chunk) (the causal half of M·x, C·h, the state update)
plus Q(Q+1)·N per (b, chunk) (the causal half of C·Bᵀ, shared by the
heads), outweighs the bytes.  The products run on the tensor cores as
3xTF32 (one TF32 product misses the 1e-4 tolerance), so the bound is three
times those operations at the TF32 rate.  Design: the stages of
``ref.ssd_stages`` as three kernels launched from one C entry (la and the
per-step factors beside C·Bᵀ once per batch row and chunk; the chunk
states and their carry; the output per 64 query rows), with their
intermediates in a workspace the wrapper allocates; see the .cu.  The (d_state, head_dim)
pairs it is built for, and the shared memory a chunk length needs, are the
.cu's to decide: a launch it refuses raises here.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ssd_scan.ref import chunk_len

launches = build.LaunchCounter("ssd_scan")

_REFUSED = 1   # cudaErrorInvalidValue: a size the launcher is not built for
# the (d_state, head_dim) instances of the .cu: mamba2-780m's, jamba's, the
# reduced configs'
BUILT = ((128, 64), (128, 128), (16, 16))


def _refused(n: int, p: int, q: int) -> ValueError:
    return ValueError(f"ssd_scan_kernel: (d_state, head_dim) = ({n}, {p}) with "
                      f"chunk length {q} is not built or does not fit in shared "
                      f"memory; built: {BUILT} (csrc/ssd_scan.cu::ssd_scan_launch)")


def ssd_scan_kernel(x: torch.Tensor, a: torch.Tensor, dt: torch.Tensor,
                    B: torch.Tensor, C: torch.Tensor, chunk: int = 256
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [b, S, H, P]; a, dt [b, S, H]; B, C [b, S, N]; all fp32 ->
    (y [b, S, H, P], final state fp32 [b·H, N, P]).  CUDA tensors only."""
    build.require_cuda("ssd_scan_kernel", x, a, dt, B, C)
    for i, t in enumerate((x, a, dt, B, C)):
        if t.dtype != torch.float32:
            raise TypeError(f"ssd_scan_kernel: operand {i} must be fp32, got "
                            f"{t.dtype}")
    if x.dim() != 4:
        raise ValueError(f"ssd_scan_kernel: x {tuple(x.shape)} must be "
                         "[b, S, H, P]")
    b, s, h, p = x.shape
    n = B.shape[-1]
    if (a.shape != (b, s, h) or dt.shape != (b, s, h)
            or B.shape != (b, s, n) or C.shape != (b, s, n)):
        raise ValueError(f"ssd_scan_kernel: a {tuple(a.shape)}, dt "
                         f"{tuple(dt.shape)}, B {tuple(B.shape)}, C "
                         f"{tuple(C.shape)} do not match x {tuple(x.shape)}")
    y = torch.empty_like(x)
    hout = torch.empty((b * h, n, p), dtype=torch.float32, device=x.device)
    if x.numel() == 0:
        return y, hout.zero_()
    q = chunk_len(s, chunk)
    lib = build.library()
    floats = lib.ssd_scan_workspace(b, s, h, p, n, q)
    if floats < 0:
        raise _refused(n, p, q)
    ws = torch.empty((floats,), dtype=torch.float32, device=x.device)
    err = lib.ssd_scan_launch(x.data_ptr(), a.data_ptr(), dt.data_ptr(),
                              B.data_ptr(), C.data_ptr(), y.data_ptr(),
                              hout.data_ptr(), ws.data_ptr(), b, s, h, p, n, q,
                              build.stream_ptr(x.device))
    if err == _REFUSED:
        raise _refused(n, p, q)
    build.check(err, "ssd_scan")
    launches.count += 1
    return y, hout
