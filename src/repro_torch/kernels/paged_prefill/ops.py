"""Public wrapper: paged-prefill chunk attention over the serving block pools
(``nn/attention.py:Attention.decode_chunk`` with ``attn_impl="fused"``).

A CUDA tensor goes to the hand-written kernel (or the call raises); a CPU
tensor goes to the plain PyTorch version.  ``paged_prefill_chunk_plain``
takes the plain version on any device: it is the ``attn_impl="gather"``
path.  Inference only.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels.paged_prefill.kernel import paged_prefill_chunk_kernel
from repro_torch.kernels.paged_prefill.ref import paged_prefill_chunk_ref


def paged_prefill_chunk(q: torch.Tensor, k_chunk: torch.Tensor,
                        v_chunk: torch.Tensor, k_pool: torch.Tensor,
                        v_pool: torch.Tensor, block_tables: torch.Tensor,
                        start: torch.Tensor, lens: torch.Tensor,
                        softcap: float = 0.0
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """q [B, T, Hq, Dh] (RoPE'd); k_chunk/v_chunk [B, T, Hkv, Dh]; pools
    [N, Hkv, bs, Dh]; block_tables int32 [B, L]; start/lens int32 [B].

    Chunk token ``j`` of row ``b`` is written at position ``start[b] + j``
    (iff ``j < lens[b]``) and attends positions ``<= start[b] + j``.
    Returns (ctx [B, T, Hq, Dh] in pool dtype, k_pool, v_pool)."""
    if q.device.type == "cuda":
        return _run(paged_prefill_chunk_kernel, q, k_chunk, v_chunk, k_pool,
                    v_pool, block_tables, start, lens, softcap)
    if q.device.type == "cpu":
        return paged_prefill_chunk_plain(q, k_chunk, v_chunk, k_pool, v_pool,
                                         block_tables, start, lens, softcap)
    raise ValueError(f"paged_prefill_chunk: unsupported device {q.device}")


def paged_prefill_chunk_plain(q: torch.Tensor, k_chunk: torch.Tensor,
                              v_chunk: torch.Tensor, k_pool: torch.Tensor,
                              v_pool: torch.Tensor, block_tables: torch.Tensor,
                              start: torch.Tensor, lens: torch.Tensor,
                              softcap: float = 0.0
                              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`paged_prefill_chunk` through the plain version, on any
    device."""
    return _run(paged_prefill_chunk_ref, q, k_chunk, v_chunk, k_pool, v_pool,
                block_tables, start, lens, softcap)


def _run(impl, q, k_chunk, v_chunk, k_pool, v_pool, block_tables, start, lens,
         softcap):
    b, t, hq, dh = q.shape
    hkv = k_pool.shape[1]
    g = hq // hkv
    # query row r = j*g + gi for chunk position j, grouped head gi
    qg = q.reshape(b, t, hkv, g, dh).permute(0, 2, 1, 3, 4).reshape(b, hkv, t * g, dh)
    kc = k_chunk.permute(0, 2, 1, 3).contiguous()
    vc = v_chunk.permute(0, 2, 1, 3).contiguous()
    scale = float(1.0 / (dh ** 0.5))
    out, k_pool, v_pool = impl(qg.contiguous(), kc, vc, k_pool, v_pool,
                               block_tables, start, lens, scale, float(softcap))
    out = out.reshape(b, hkv, t, g, dh).permute(0, 2, 1, 3, 4)
    return out.reshape(b, t, hq, dh), k_pool, v_pool
