"""Paged-attention decode step on the card: binding of
``csrc/paged_attention.cu`` (body shared with the prefill kernel in
``csrc/paged_core.cuh``).

Replaces the TPU kernel
``repro/kernels/paged_attention/kernel.py::paged_attention_decode_kernel``.
Per (row, kv-head): fp32 softmax of the g grouped query heads over the
stored positions ``< idx[b]`` read in place from the row's pool blocks, the
new token folded in from the projection output, optional softcap, and the new
K/V written into block ``bt[b, min(idx//bs, L-1)]`` at offset ``idx % bs``.
The TPU kernel's ordered grid axis over blocks (carry in VMEM scratch)
becomes a KV walk split across CTAs (:func:`plan`) whose fp32 partials
(m, z, acc) a second kernel merges in split order; its aliased pool outputs
become in-place stores, done once per (row, head) by the split that holds
``idx`` while the other splits read only positions ``< idx`` (the argument is
in ``paged_core.cuh``).  Idle rows (``block_tables[b, 0] == 0``, the trash
block) skip the walk and give a finite output that the engine discards.

Bound on the H100: the resident K/V bytes of the active rows, read once.
The design: 128-key splits (up to 16 per row; the plan and the workspace
layout are the ``.cuh``'s, read here through :func:`plan`; the workspace is
one buffer per stream, kept across calls), a two-stage ``cp.async`` ring
of 64-key tiles, and for bf16 x bf16 ``mma.sync`` tensor-core products with
P split into bf16 high and low parts for P·V (one rounding of P to bf16
would cost more than the one-ulp tolerance); fp32 CUDA-core products for the
other dtype pairs.  Head dims 64, 128 and 256 are built (at 256 the
tensor-core path reloads Q's fragments from shared memory per tile rather
than holding them in registers beside the 128 accumulators); others raise.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, Tuple

import torch

from repro_torch.kernels import build

launches = build.LaunchCounter("paged_attention_decode")

_PLAN_KEYS = ("split_keys", "splits", "row_groups", "workspace_floats", "ctas",
              "merge_ctas")


@functools.lru_cache(maxsize=None)
def plan(b: int, hkv: int, rows: int, t: int, dh: int, bs: int, n_log: int) -> dict:
    """The launch plan of a paged kernel, as ``csrc/paged_core.cuh::paged_plan``
    makes it from host-known shapes (no device sync): keys per split, splits,
    row groups of query rows, fp32 floats of workspace, attention and merge
    CTAs.  ``rows`` = T·g query rows per (row, kv-head); ValueError for a
    shape the kernels do not take (head dims other than 64, 128 and 256)."""
    out = (ctypes.c_longlong * len(_PLAN_KEYS))()
    if build.library().paged_plan_query(b, hkv, rows, t, dh, bs, n_log, out):
        raise ValueError(f"paged kernels: B={b} Hkv={hkv} rows={rows} T={t} "
                         f"head_dim {dh} bs={bs} L={n_log} is not taken "
                         "(csrc/paged_core.cuh::paged_plan: head dims 64, 128 "
                         "and 256)")
    return dict(zip(_PLAN_KEYS, out))


_workspaces: Dict[Tuple[torch.device, int], torch.Tensor] = {}


def workspace(floats: int, device: torch.device, stream: int) -> Tuple[int, int]:
    """(pointer, floats) of an fp32 buffer of at least ``floats`` for the
    splits' partials, or (0, 0) for none: one buffer per stream, grown as
    needed and kept, since the launches of one stream run in order."""
    if floats == 0:
        return 0, 0
    ws = _workspaces.get((device, stream))
    if ws is None or ws.numel() < floats:
        ws = torch.empty((floats,), dtype=torch.float32, device=device)
        _workspaces[(device, stream)] = ws
    return ws.data_ptr(), ws.numel()


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


def dtype_code(name: str, t: torch.Tensor) -> int:
    """The kernels' code for ``t``'s dtype, or ValueError naming it."""
    code = build.DTYPE_CODES.get(t.dtype)
    if code is None:
        raise ValueError(f"{name}: dtype {t.dtype} is not taken (float32 and "
                         "bfloat16 are)")
    return code


def check_aligned(name: str, *tensors: torch.Tensor) -> None:
    """Operands on 16-byte boundaries (the kernels copy 16-byte pieces)."""
    for i, t in enumerate(tensors):
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: operand {i} is not 16-byte aligned")


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
    codes = dtype_code(name, q), dtype_code(name, k_pool)
    out = torch.empty((b, hkv, g, dh), dtype=k_pool.dtype, device=q.device)
    if b == 0:
        return out, k_pool, v_pool
    check_aligned(name, q, k_new, v_new, k_pool, v_pool, out)
    stream = build.stream_ptr(q.device)
    ws, ws_floats = workspace(plan(b, hkv, g, 1, dh, bs, n_log)["workspace_floats"],
                              q.device, stream)
    err = build.library().paged_attention_decode_launch(
        q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(), k_pool.data_ptr(),
        v_pool.data_ptr(), block_tables.data_ptr(), idx.data_ptr(),
        out.data_ptr(), ws, ws_floats, b, hkv, g, dh, bs, n_log, float(scale),
        float(softcap), *codes, stream)
    build.check(err, "paged_attention_decode")
    launches.count += 1
    return out, k_pool, v_pool
