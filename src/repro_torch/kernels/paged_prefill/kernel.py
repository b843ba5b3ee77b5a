"""Paged-prefill chunk step on the card: binding of ``csrc/paged_prefill.cu``
(body shared with the decode kernel in ``csrc/paged_core.cuh``).

Replaces the TPU kernel
``repro/kernels/paged_prefill/kernel.py::paged_prefill_chunk_kernel``.  Per
(row, kv-head): the ``lens·g`` valid query rows of a chunk at positions
``start .. start+lens-1`` attend the resident positions ``< start`` (read in
place, trie-shared blocks included) plus the chunk causally, and the chunk
rows ``j < lens`` are written into the row's blocks.  Pad rows are never
written and their output rows are zeros (computed for no key: the engine
reads only position ``lens-1`` of each row, and nothing else reads them);
decode rows are ``lens == 1`` and cost one 16-row tile.

Bound on the H100: the resident K/V bytes of the chunked rows, read once
(at T = 32 the work is ~2 operations per byte read: far under the ridge).
The design: the KV walk split across CTAs (256-key splits, at most 16, from
the table width alone: ``paged_core.cuh::paged_plan``) with the chunk's keys
folded into the split that holds ``start``; a second kernel merges the splits' fp32 partials in split
order.  That split alone writes the pools, while the others read positions
``< start``: disjoint slots, shared prefix blocks are never written, and
only the trash block is read and written by rows whose output is discarded
(``paged_core.cuh``).  A two-stage ``cp.async`` ring streams 64-key tiles;
bf16 x bf16 runs Q·Kᵀ and P·V on the tensor cores (``mma.sync``), with P
split into bf16 high and low parts so P·V keeps fp32 accuracy; the other
dtype pairs use fp32 CUDA-core products.  Head dims 16, 32, 64, 128 and
256 are built.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.paged_attention.kernel import (check_aligned, check_pools,
                                                        dtype_code, plan, workspace)

launches = build.LaunchCounter("paged_prefill_chunk")


def paged_prefill_chunk_kernel(
        q: torch.Tensor, k_chunk: torch.Tensor, v_chunk: torch.Tensor,
        k_pool: torch.Tensor, v_pool: torch.Tensor,
        block_tables: torch.Tensor, start: torch.Tensor, lens: torch.Tensor,
        scale: float, softcap: float = 0.0
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """q [B, Hkv, T*g, Dh] (row r = chunk position r//g); k_chunk/v_chunk
    [B, Hkv, T, Dh]; pools [N, Hkv, bs, Dh]; block_tables int32 [B, L];
    start/lens int32 [B] (1 <= lens <= T).  Returns (out [B, Hkv, T*g, Dh] in
    pool dtype, k_pool, v_pool) with the chunk K/V written in place."""
    name = "paged_prefill_chunk_kernel"
    build.require_cuda(name, q, k_chunk, v_chunk, k_pool, v_pool,
                       block_tables, start, lens)
    if q.dim() != 4 or k_chunk.dim() != 4:
        raise ValueError(f"{name}: q and k_chunk must be 4-D")
    b, hkv, tg, dh = q.shape
    t = k_chunk.shape[2]
    if t < 1 or tg % t or k_chunk.shape != (b, hkv, t, dh) \
            or v_chunk.shape != k_chunk.shape:
        raise ValueError(f"{name}: q {tuple(q.shape)} / chunk "
                         f"{tuple(k_chunk.shape)} shapes disagree")
    if k_chunk.dtype != q.dtype or v_chunk.dtype != q.dtype:
        raise TypeError(f"{name}: q, k_chunk, v_chunk must share one dtype")
    check_pools(name, k_pool, v_pool, block_tables, b, hkv, dh)
    for nm, v in (("start", start), ("lens", lens)):
        if v.dtype != torch.int32 or v.shape != (b,):
            raise ValueError(f"{name}: {nm} must be int32 [B={b}]")
    bs, n_log = k_pool.shape[2], block_tables.shape[1]
    codes = dtype_code(name, q), dtype_code(name, k_pool)
    out = torch.empty((b, hkv, tg, dh), dtype=k_pool.dtype, device=q.device)
    if b == 0:
        return out, k_pool, v_pool
    check_aligned(name, q, k_chunk, v_chunk, k_pool, v_pool, out)
    stream = build.stream_ptr(q.device)
    ws, ws_floats = workspace(plan(b, hkv, tg, t, dh, bs, n_log)["workspace_floats"],
                              q.device, stream)
    err = build.library().paged_prefill_chunk_launch(
        q.data_ptr(), k_chunk.data_ptr(), v_chunk.data_ptr(), k_pool.data_ptr(),
        v_pool.data_ptr(), block_tables.data_ptr(), start.data_ptr(),
        lens.data_ptr(), out.data_ptr(), ws, ws_floats, b, hkv, t, tg // t, dh,
        bs, n_log, float(scale), float(softcap), *codes, stream)
    build.check(err, "paged_prefill_chunk")
    launches.count += 1
    return out, k_pool, v_pool
