"""MiniLM relation-KL rows on the card: binding of ``csrc/relation_kd.cu``.

Replaces the TPU kernel
``repro/kernels/relation_kd/kernel.py::relation_kl_rows_kernel``: per
relation row i,

  KL_i = Σ_j P_t(i,j) (log P_t(i,j) - log P_s(i,j)),
  P_t = softmax_j(t_i·t_j / temp),  P_s = softmax_j(s_i·s_j / temp),

streamed over j tiles with five running values per row, never forming the
L×L relation matrices.  No probability clamp, as in the TPU kernel.

Bound on the H100: the two relation products (2·2·BH·L²·D operations), run
on the tensor cores as 3xTF32 (three TF32 products for each fp32 one, at
495 TFLOP/s), outweigh the bytes.  Design: CTAs of 64 rows i walk 64-column
j tiles, both relation tiles from TF32 ``wgmma`` on operands split once
into their TF32 parts in shared memory, D streamed in 32-float chunks by
``cp.async``, fresh accumulators every 16 floats of D, the online update in
registers; with too few row tiles for two CTAs an SM the j walk is split
across CTAs (:func:`plan`, the ``.cu``'s) and the last CTA of a row tile
merges the splits' partials in split order, from buffers kept per stream.  See the
``.cu`` for details; ``ref.py::relation_kl_rows_split_ref`` is its plain
model.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, Tuple

import torch

from repro_torch.kernels import build

launches = build.LaunchCounter("relation_kd")

_PLAN_KEYS = ("block_rows", "block_cols", "splits", "tiles_per_split",
              "workspace_floats", "counters", "ctas")


@functools.lru_cache(maxsize=None)
def plan(bh: int, l: int, d: int) -> dict:
    """The launch plan of ``csrc/relation_kd.cu::relation_plan`` for
    [BH, L, D]: rows i a CTA owns, columns a j tile holds, splits of the j
    walk, j tiles in each split, fp32 floats of the splits' partials,
    counters (one per row tile) and CTAs."""
    out = (ctypes.c_longlong * len(_PLAN_KEYS))()
    if build.library().relation_kd_plan_query(bh, l, d, out):
        raise ValueError(f"relation_kl_rows_kernel: [BH={bh}, L={l}, D={d}] is "
                         "not taken (csrc/relation_kd.cu::relation_plan: BH "
                         "in 1..65535, L >= 1)")
    return dict(zip(_PLAN_KEYS, out))


# kept per (device, stream), since the launches of one stream run in order:
# the splits' partials (fp32, any content) and the row tiles' counters
# (int32, zero between calls: the CTA that merges a row tile zeroes its
# counter again)
_partials: Dict[Tuple[torch.device, int], torch.Tensor] = {}
_counters: Dict[Tuple[torch.device, int], torch.Tensor] = {}


def _buffer(kept: dict, n: int, dtype: torch.dtype, device: torch.device,
            stream: int) -> Tuple[int, int]:
    """(pointer, elements) of a buffer of at least ``n`` zeros at
    allocation, grown as needed, or (0, 0) for none."""
    if n == 0:
        return 0, 0
    buf = kept.get((device, stream))
    if buf is None or buf.numel() < n:
        buf = torch.zeros((n,), dtype=dtype, device=device)
        kept[(device, stream)] = buf
    return buf.data_ptr(), buf.numel()


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
    stream = build.stream_ptr(s.device)
    p = plan(bh, l, d)
    part, n_part = _buffer(_partials, p["workspace_floats"], torch.float32,
                           s.device, stream)
    counters, n_counters = _buffer(_counters, p["counters"], torch.int32,
                                   s.device, stream)
    err = build.library().relation_kd_launch(
        s.data_ptr(), t.data_ptr(), out.data_ptr(), part, n_part, counters,
        n_counters, bh, l, d, float(temp), stream)
    build.check(err, "relation_kd")
    launches.count += 1
    return out
