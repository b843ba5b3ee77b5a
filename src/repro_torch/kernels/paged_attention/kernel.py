"""Paged-attention decode step on the card: binding of
``csrc/paged_attention.cu`` (body shared with the prefill kernel in
``csrc/paged_core.cuh``).

Replaces the TPU kernel
``repro/kernels/paged_attention/kernel.py::paged_attention_decode_kernel``.
Per (row, kv-head): fp32 online softmax of the g grouped query heads over the
stored positions ``< idx[b]`` read in place from the row's pool blocks, the
new token folded in from the projection output, optional softcap, and the new
K/V written into block ``bt[b, min(idx//bs, L-1)]`` at offset ``idx % bs``.
The TPU kernel's ordered grid axis over blocks (carry in VMEM scratch)
becomes a loop over key tiles inside one CTA; its aliased pool outputs become
in-place stores into the pool tensors.

Bound on the H100: the resident K/V bytes of the active rows, read once.
The design reads each resident block once per (row, head) CTA and never
builds the dense block-table window.  At B·Hkv CTAs it fills the card only
at large batch; a split of the KV walk across CTAs is later work.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import build

launches = build.LaunchCounter("paged_attention_decode")

MAX_ROWS_TIMES_DH = 32 * 256   # csrc/paged_core.cuh: PA_ACC * PA_THREADS


def check_pools(name: str, k_pool: torch.Tensor, v_pool: torch.Tensor,
                block_tables: torch.Tensor, b: int, hkv: int, dh: int) -> None:
    """Shape / dtype checks shared by the two paged kernels."""
    if k_pool.dim() != 4 or k_pool.shape != v_pool.shape:
        raise ValueError(f"{name}: pools must be equal [N, Hkv, bs, Dh], got "
                         f"{tuple(k_pool.shape)} and {tuple(v_pool.shape)}")
    if k_pool.dtype != v_pool.dtype:
        raise TypeError(f"{name}: pool dtypes differ ({k_pool.dtype}, "
                        f"{v_pool.dtype})")
    if k_pool.shape[1] != hkv or k_pool.shape[3] != dh:
        raise ValueError(f"{name}: pools {tuple(k_pool.shape)} do not match "
                         f"Hkv={hkv}, Dh={dh}")
    if block_tables.dtype != torch.int32 or block_tables.dim() != 2 \
            or block_tables.shape[0] != b or block_tables.shape[1] < 1:
        raise ValueError(f"{name}: block_tables must be int32 [B={b}, L>=1], "
                         f"got {block_tables.dtype} {tuple(block_tables.shape)}")
    if dh > MAX_ROWS_TIMES_DH:
        raise ValueError(f"{name}: head_dim {dh} exceeds {MAX_ROWS_TIMES_DH}")


def paged_attention_decode_kernel(
        q: torch.Tensor, k_new: torch.Tensor, v_new: torch.Tensor,
        k_pool: torch.Tensor, v_pool: torch.Tensor,
        block_tables: torch.Tensor, idx: torch.Tensor,
        scale: float, softcap: float = 0.0
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """q [B, Hkv, g, Dh]; k_new/v_new [B, Hkv, Dh]; pools [N, Hkv, bs, Dh];
    block_tables int32 [B, L]; idx int32 [B].  Returns (out [B, Hkv, g, Dh]
    in pool dtype, k_pool, v_pool) with the new K/V written in place."""
    name = "paged_attention_decode_kernel"
    build.require_cuda(name, q, k_new, v_new, k_pool, v_pool, block_tables, idx)
    if q.dim() != 4:
        raise ValueError(f"{name}: q must be [B, Hkv, g, Dh], got {tuple(q.shape)}")
    b, hkv, g, dh = q.shape
    if k_new.shape != (b, hkv, dh) or v_new.shape != (b, hkv, dh):
        raise ValueError(f"{name}: k_new/v_new must be [B, Hkv, Dh] = "
                         f"{(b, hkv, dh)}")
    if k_new.dtype != q.dtype or v_new.dtype != q.dtype:
        raise TypeError(f"{name}: q, k_new, v_new must share one dtype")
    check_pools(name, k_pool, v_pool, block_tables, b, hkv, dh)
    if idx.dtype != torch.int32 or idx.shape != (b,):
        raise ValueError(f"{name}: idx must be int32 [B={b}]")
    bs, n_log = k_pool.shape[2], block_tables.shape[1]
    out = torch.empty((b, hkv, g, dh), dtype=k_pool.dtype, device=q.device)
    if b == 0:
        return out, k_pool, v_pool
    lib = build.library()
    err = lib.paged_attention_decode_launch(
        q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(), k_pool.data_ptr(),
        v_pool.data_ptr(), block_tables.data_ptr(), idx.data_ptr(),
        out.data_ptr(), b, hkv, g, dh, bs, n_log, float(scale), float(softcap),
        build.dtype_code(q, name), build.dtype_code(k_pool, name),
        build.stream_ptr(q.device))
    build.check(err, "paged_attention_decode")
    launches.count += 1
    return out, k_pool, v_pool
