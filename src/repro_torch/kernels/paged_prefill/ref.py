"""Plain PyTorch version of the paged prefill-chunk kernel (mirrors the JAX
``repro/kernels/paged_prefill/ref.py``): scatter the chunk's K/V into the
rows' pool blocks (pad rows to the trash block), gather the block table into
a dense ``[B, Hkv, L*bs, Dh]`` window, and run masked dense softmax attention
where chunk token ``j`` attends positions ``<= start + j``.  The pools are
updated in place, as by the kernel; unlike the kernel, pad rows land in the
trash block, which nothing attends."""
from __future__ import annotations

import torch

from repro_torch.kernels.paged_attention.ref import window

NEG_INF = -2.0e38
TRASH_BLOCK = 0           # serving/paged.py convention: block 0 is reserved


def chunk_slots(block_tables: torch.Tensor, start: torch.Tensor,
                lens: torch.Tensor, t: int, bs: int):
    """(pool block, offset, position), each [B, T], of chunk token ``j`` of
    row ``b`` at position ``start[b] + j``: block
    ``block_tables[b, min(pos // bs, L-1)]``, or the trash block for a pad
    token ``j >= lens[b]``."""
    ar = torch.arange(t, device=block_tables.device)
    pos = start.long()[:, None] + ar[None]
    blk = torch.clamp(pos // bs, max=block_tables.shape[1] - 1)
    bid = torch.gather(block_tables.long(), 1, blk)
    bid = torch.where(ar[None] < lens.long()[:, None], bid,
                      torch.full_like(bid, TRASH_BLOCK))
    return bid, pos % bs, pos


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
    bid, off, pos = chunk_slots(block_tables, start, lens, t, bs)
    kf = k_chunk.permute(0, 2, 1, 3).reshape(b * t, hkv, dh)
    vf = v_chunk.permute(0, 2, 1, 3).reshape(b * t, hkv, dh)
    k_pool[bid.reshape(-1), :, off.reshape(-1)] = kf.to(k_pool.dtype)
    v_pool[bid.reshape(-1), :, off.reshape(-1)] = vf.to(v_pool.dtype)

    k, v = window(k_pool, block_tables), window(v_pool, block_tables)
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


def paged_prefill_chunk_split_ref(q: torch.Tensor, k_chunk: torch.Tensor,
                                  v_chunk: torch.Tensor, k_pool: torch.Tensor,
                                  v_pool: torch.Tensor,
                                  block_tables: torch.Tensor, start: torch.Tensor,
                                  lens: torch.Tensor, scale: float,
                                  softcap: float = 0.0, split_keys: int = 256):
    """The kernel's split KV walk in plain PyTorch (fp32), for the CPU tests.

    Same contract as :func:`paged_prefill_chunk_ref`, computed as
    ``csrc/paged_core.cuh`` computes it: row ``b``'s resident positions
    ``< start`` (none for an idle row, ``block_tables[b, 0] == 0``) are cut
    into splits of ``split_keys`` positions over the table's ``L*bs``; the
    chunk's own keys (rounded to the pool dtype, as the plain version reads
    them back) join the split that holds ``start``.  Each split gives a
    partial ``(m, z, acc)`` per valid query row (row max, sum of weights,
    weighted sum of values); the partials merge in split order.  Only rows
    ``r < lens*g`` are computed, pad rows are zeros, and only the chunk rows
    ``j < lens`` are written into the pools."""
    b, hkv, tg, dh = q.shape
    t = k_chunk.shape[2]
    bs = k_pool.shape[2]
    nlog = block_tables.shape[1]
    g = tg // t
    n_splits = -(-nlog * bs // split_keys)
    out = torch.zeros((b, hkv, tg, dh), dtype=torch.float32, device=q.device)
    writes = []
    for bi in range(b):
        st, nl = int(start[bi]), min(int(lens[bi]), t)
        nq = nl * g
        row_bt = block_tables[bi].long()
        nres = 0 if int(row_bt[0]) == TRASH_BLOCK else max(0, min(st, nlog * bs))
        pos = torch.arange(nres, device=q.device)
        blk, off = row_bt[pos // bs], pos % bs
        kr = k_pool[blk, :, off].permute(1, 0, 2).float()        # [Hkv, nres, Dh]
        vr = v_pool[blk, :, off].permute(1, 0, 2).float()
        kc = k_chunk[bi, :, :nl].to(k_pool.dtype).float()
        vc = v_chunk[bi, :, :nl].to(v_pool.dtype).float()
        qf = q[bi, :, :nq].float()                                # [Hkv, nq, Dh]
        tok = torch.arange(nq, device=q.device) // g
        parts = []
        for s in range(n_splits):
            lo, hi = s * split_keys, min((s + 1) * split_keys, nres)
            keys, vals = kr[:, lo:hi], vr[:, lo:hi]
            mask = torch.ones((nq, keys.shape[1]), dtype=torch.bool, device=q.device)
            if s == min(st // split_keys, n_splits - 1):
                keys, vals = torch.cat([keys, kc], 1), torch.cat([vals, vc], 1)
                causal = torch.arange(nl, device=q.device)[None] <= tok[:, None]
                mask = torch.cat([mask, causal], 1)
            if keys.shape[1] == 0:
                continue                                          # z = 0: no weight
            sc = torch.einsum("hrd,hkd->hrk", qf, keys) * scale
            if softcap > 0.0:
                sc = softcap * torch.tanh(sc / softcap)
            sc = torch.where(mask, sc, torch.full_like(sc, NEG_INF))
            m = sc.amax(-1)
            w = torch.where(mask, torch.exp(sc - m[..., None]), torch.zeros_like(sc))
            parts.append((m, w.sum(-1), torch.einsum("hrk,hkd->hrd", w, vals)))
        live = [pt for pt in parts if bool((pt[1] > 0).any())]
        big_m = torch.stack([torch.where(z > 0, m, torch.full_like(m, NEG_INF))
                             for m, z, _ in live]).amax(0)
        acc = torch.zeros((hkv, nq, dh), dtype=torch.float32, device=q.device)
        z_all = torch.zeros((hkv, nq), dtype=torch.float32, device=q.device)
        for m, z, a in live:                                      # split order
            e = torch.where(z > 0, torch.exp(m - big_m), torch.zeros_like(m))
            acc = acc + a * e[..., None]
            z_all = z_all + z * e
        out[bi, :, :nq] = acc / z_all[..., None]
        for j in range(nl):
            lb = (st + j) // bs
            if lb <= nlog - 1:
                writes.append((bi, j, int(row_bt[lb]), (st + j) % bs))
    for bi, j, blk_id, o in writes:
        k_pool[blk_id, :, o] = k_chunk[bi, :, j].to(k_pool.dtype)
        v_pool[blk_id, :, o] = v_chunk[bi, :, j].to(v_pool.dtype)
    return out.to(k_pool.dtype), k_pool, v_pool
