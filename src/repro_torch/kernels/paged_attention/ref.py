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
    b, hkv, g, dh = q.shape
    bs = k_pool.shape[2]
    nlog = block_tables.shape[1]
    bt = block_tables.long()
    idx = idx.long()
    blk = torch.clamp(idx // bs, max=nlog - 1)
    bid = torch.gather(bt, 1, blk[:, None])[:, 0]
    off = idx % bs
    k_pool[bid, :, off] = k_new.to(k_pool.dtype)
    v_pool[bid, :, off] = v_new.to(v_pool.dtype)
    k = k_pool[bt].permute(0, 2, 1, 3, 4).reshape(b, hkv, nlog * bs, dh)
    v = v_pool[bt].permute(0, 2, 1, 3, 4).reshape(b, hkv, nlog * bs, dh)
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
