"""MiniLM relation-KL rows on the card: binding of ``csrc/relation_kd.cu``.

Replaces the TPU kernel
``repro/kernels/relation_kd/kernel.py::relation_kl_rows_kernel``: per
relation row i,

  KL_i = Σ_j P_t(i,j) (log P_t(i,j) - log P_s(i,j)),
  P_t = softmax_j(t_i·t_j / temp),  P_s = softmax_j(s_i·s_j / temp),

streamed over j tiles with five running values per row, never forming the
L×L relation matrices.  No probability clamp, as in the TPU kernel.

Bound on the H100: the two fp32 relation products (2·2·BH·L²·D operations
at 67 TFLOP/s) outweigh the bytes.  Design: one CTA per (bh, 32-row tile),
32-column j tiles, D streamed through shared memory in 32-wide chunks; see
the .cu for details.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

launches = build.LaunchCounter("relation_kd")


def relation_kl_rows_kernel(s: torch.Tensor, t: torch.Tensor,
                            temp: float = 1.0) -> torch.Tensor:
    """s, t: fp32 [BH, L, D] L2-normalized relation vectors -> KL rows
    fp32 [BH, L].  CUDA tensors only."""
    build.require_cuda("relation_kl_rows_kernel", s, t)
    if s.dim() != 3 or s.shape != t.shape:
        raise ValueError(f"relation_kl_rows_kernel: s {tuple(s.shape)} and t "
                         f"{tuple(t.shape)} must be one [BH, L, D] shape")
    if s.dtype != torch.float32 or t.dtype != torch.float32:
        raise TypeError("relation_kl_rows_kernel: s and t must be fp32, got "
                        f"{s.dtype} and {t.dtype}")
    bh, l, d = s.shape
    out = torch.empty((bh, l), dtype=torch.float32, device=s.device)
    if out.numel() == 0:
        return out
    lib = build.library()
    err = lib.relation_kd_launch(s.data_ptr(), t.data_ptr(), out.data_ptr(),
                                 bh, l, d, float(temp),
                                 build.stream_ptr(s.device))
    build.check(err, "relation_kd")
    launches.count += 1
    return out
