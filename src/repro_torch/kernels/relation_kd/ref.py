"""Plain PyTorch version of the relation-KL rows: the L×L relation
matrices materialized (``repro/kernels/relation_kd/ref.py``); and a plain
model of the card kernel's split walk and merge."""
from __future__ import annotations

import torch

from repro_torch.core.distill import _prep
from repro_torch.core.quant import div


def relation_kl_rows_ref(s: torch.Tensor, t: torch.Tensor,
                         temp: float = 1.0) -> torch.Tensor:
    """s, t: [BH, L, D] (already normalized) -> KL(t_row ‖ s_row) [BH, L]."""
    s_rel = div(torch.einsum("bld,bmd->blm", s, s), temp)
    t_rel = div(torch.einsum("bld,bmd->blm", t, t), temp)
    s_logp = torch.log_softmax(s_rel, dim=-1)
    t_logp = torch.log_softmax(t_rel, dim=-1)
    t_prob = torch.exp(t_logp)
    return torch.sum(t_prob * (t_logp - s_logp), dim=-1)


NEG = -1e30   # the TPU kernel's mask value for columns past L


def relation_kl_rows_split_ref(s: torch.Tensor, t: torch.Tensor,
                               temp: float = 1.0, split_cols: int = 0,
                               block: int = 64, mm=torch.matmul) -> torch.Tensor:
    """Plain model of the card kernel's walk (``csrc/relation_kd.cu``): the
    columns cut into splits of ``split_cols`` (0: one split), each walked in
    tiles of ``block`` with the five running values (m_t, z_t, m_s, z_s, u),
    then the splits merged in split order (m = max over the splits; z and u
    rescaled by exp(m_split - m) and summed from split 0 on) and each row
    finished as ``u/z_t + (m_s - m_t) + log(z_s/z_t)``, z clamped at 1e-30.
    ``mm`` takes the relation products (the tests pass emulated TF32
    products).  s, t: [BH, L, D] normalized -> [BH, L]."""
    l = s.shape[1]
    split_cols = split_cols or l
    t_rel = div(mm(t, t.transpose(-1, -2)), temp)
    s_rel = div(mm(s, s.transpose(-1, -2)), temp)
    parts = []
    for c0 in range(0, l, split_cols):
        c1 = min(l, c0 + split_cols)
        m_t = m_s = torch.full(t_rel.shape[:-1], NEG)
        z_t = z_s = u = torch.zeros_like(m_t)
        for j0 in range(c0, c1, block):
            cols = slice(j0, min(c1, j0 + block))
            tv, sv = t_rel[..., cols], s_rel[..., cols]
            mt = torch.maximum(m_t, tv.amax(-1))
            ms = torch.maximum(m_s, sv.amax(-1))
            pt = torch.exp(tv - mt[..., None])
            ct = torch.exp(m_t - mt)
            z_t = z_t * ct + pt.sum(-1)
            z_s = z_s * torch.exp(m_s - ms) + torch.exp(sv - ms[..., None]).sum(-1)
            u = u * ct + (pt * (tv - sv)).sum(-1)
            m_t, m_s = mt, ms
        parts.append((m_t, z_t, m_s, z_s, u))
    m_t = torch.stack([p[0] for p in parts]).amax(0)
    m_s = torch.stack([p[2] for p in parts]).amax(0)
    z_t = z_s = u = torch.zeros_like(m_t)
    for pm_t, pz_t, pm_s, pz_s, pu in parts:
        ct = torch.exp(pm_t - m_t)
        z_t = z_t + pz_t * ct
        z_s = z_s + pz_s * torch.exp(pm_s - m_s)
        u = u + pu * ct
    z_t, z_s = torch.clamp(z_t, min=1e-30), torch.clamp(z_s, min=1e-30)
    return div(u, z_t) + (m_s - m_t) + torch.log(div(z_s, z_t))


def prep_states(states: torch.Tensor, split_heads: int) -> torch.Tensor:
    """[B, H, L, Dh] -> normalized resplit [B*split, L, D] (the ops.py prep)."""
    x = _prep(states, split_heads)
    b, h, l, d = x.shape
    return x.reshape(b * h, l, d)

