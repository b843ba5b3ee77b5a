"""Plain PyTorch version of the relation-KL rows: the L×L relation
matrices materialized (``repro/kernels/relation_kd/ref.py``)."""
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


def prep_states(states: torch.Tensor, split_heads: int) -> torch.Tensor:
    """[B, H, L, Dh] -> normalized resplit [B*split, L, D] (the ops.py prep)."""
    x = _prep(states, split_heads)
    b, h, l, d = x.shape
    return x.reshape(b * h, l, d)

