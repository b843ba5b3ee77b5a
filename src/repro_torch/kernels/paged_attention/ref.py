"""Plain PyTorch version of the paged decode kernel (mirrors the JAX
``repro/kernels/paged_attention/ref.py``): scatter the new K/V into the row's
current block, gather the whole block table into a dense
``[B, Hkv, L*bs, Dh]`` window, run masked dense softmax attention over
positions ``<= idx``.  The pools are updated in place, as by the kernel."""
from __future__ import annotations

import torch

NEG_INF = -2.0e38


def paged_attention_decode_ref(q: torch.Tensor, k_new: torch.Tensor,
                               v_new: torch.Tensor, k_pool: torch.Tensor,
                               v_pool: torch.Tensor, block_tables: torch.Tensor,
                               idx: torch.Tensor, scale: float,
                               softcap: float = 0.0):
    """Same contract as kernel.paged_attention_decode_kernel."""
    bs = k_pool.shape[2]
    nlog = block_tables.shape[1]
    bid, off = decode_slots(block_tables, idx, bs)
    k_pool[bid, :, off] = k_new.to(k_pool.dtype)
    v_pool[bid, :, off] = v_new.to(v_pool.dtype)
    k, v = window(k_pool, block_tables), window(v_pool, block_tables)
    idx = idx.long()
    s = torch.einsum("bkgd,bktd->bkgt", q.to(torch.float32),
                     k.to(torch.float32)) * scale
    if softcap > 0.0:
        s = softcap * torch.tanh(s / softcap)
    t = nlog * bs
    mask = (torch.arange(t, device=q.device)[None] <= idx[:, None])[:, None, None]
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgt,bktd->bkgd", w, v.to(torch.float32))
    return out.to(k_pool.dtype), k_pool, v_pool


def decode_slots(block_tables: torch.Tensor, idx: torch.Tensor, bs: int):
    """(pool block, offset), each [B], where row ``b`` stores its token at
    position ``idx[b]``: block ``block_tables[b, min(idx // bs, L-1)]`` (a
    table cut short of ``idx`` clamps into its last block)."""
    idx = idx.long()
    blk = torch.clamp(idx // bs, max=block_tables.shape[1] - 1)
    return torch.gather(block_tables.long(), 1, blk[:, None])[:, 0], idx % bs


def window(pool: torch.Tensor, block_tables: torch.Tensor) -> torch.Tensor:
    """Each row's block table gathered from ``pool`` [N, Hkv, bs, Dh] into a
    dense [B, Hkv, L*bs, Dh] window."""
    b, nlog = block_tables.shape
    _, hkv, bs, dh = pool.shape
    return (pool[block_tables.long()].permute(0, 2, 1, 3, 4)
            .reshape(b, hkv, nlog * bs, dh))
