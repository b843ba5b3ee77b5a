"""Plain PyTorch version of the paged prefill-chunk kernel (mirrors the JAX
``repro/kernels/paged_prefill/ref.py``): scatter the chunk's K/V into the
rows' pool blocks (pad rows to the trash block), gather the block table into
a dense ``[B, Hkv, L*bs, Dh]`` window, and run masked dense softmax attention
where chunk token ``j`` attends positions ``<= start + j``.  The pools are
updated in place, as by the kernel; unlike the kernel, pad rows land in the
trash block, which nothing attends."""
from __future__ import annotations

import torch

NEG_INF = -2.0e38
TRASH_BLOCK = 0           # serving/paged.py convention: block 0 is reserved


def paged_prefill_chunk_ref(q: torch.Tensor, k_chunk: torch.Tensor,
                            v_chunk: torch.Tensor, k_pool: torch.Tensor,
                            v_pool: torch.Tensor, block_tables: torch.Tensor,
                            start: torch.Tensor, lens: torch.Tensor,
                            scale: float, softcap: float = 0.0):
    """Same contract as kernel.paged_prefill_chunk_kernel."""
    b, hkv, tg, dh = q.shape
    t = k_chunk.shape[2]
    bs = k_pool.shape[2]
    nlog = block_tables.shape[1]
    g = tg // t
    dev = q.device
    bt = block_tables.long()
    ar = torch.arange(t, device=dev)
    pos = start.long()[:, None] + ar[None]                          # [B, T]
    valid = ar[None] < lens.long()[:, None]
    blk = torch.clamp(pos // bs, max=nlog - 1)
    bid = torch.gather(bt, 1, blk)
    bid = torch.where(valid, bid, torch.full_like(bid, TRASH_BLOCK))
    off = pos % bs
    kf = k_chunk.permute(0, 2, 1, 3).reshape(b * t, hkv, dh)
    vf = v_chunk.permute(0, 2, 1, 3).reshape(b * t, hkv, dh)
    k_pool[bid.reshape(-1), :, off.reshape(-1)] = kf.to(k_pool.dtype)
    v_pool[bid.reshape(-1), :, off.reshape(-1)] = vf.to(v_pool.dtype)

    k = k_pool[bt].permute(0, 2, 1, 3, 4).reshape(b, hkv, nlog * bs, dh)
    v = v_pool[bt].permute(0, 2, 1, 3, 4).reshape(b, hkv, nlog * bs, dh)
    qg = q.reshape(b, hkv, t, g, dh)
    s = torch.einsum("bktgd,bkpd->bktgp", qg.to(torch.float32),
                     k.to(torch.float32)) * scale
    if softcap > 0.0:
        s = softcap * torch.tanh(s / softcap)
    kvp = torch.arange(nlog * bs, device=dev)
    mask = (kvp[None, None] <= pos[:, :, None])[:, None, :, None]
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bktgp,bkpd->bktgd", w, v.to(torch.float32))
    return out.reshape(b, hkv, tg, dh).to(k_pool.dtype), k_pool, v_pool
