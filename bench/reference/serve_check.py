"""The served model's check: the reference runs once over each sampled
request's prompt and served tokens, and each served token is judged by how
far its logit lies below the reference's best at that position (0 where
the served token is the reference's argmax; valid for greedy tokens).  The
control reads, at the same positions, the gap of the token that the
lower-precision reference puts first."""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch

from reference import dense
from reference.common import Round, exact, fp32_matmuls


def _logits(w, cfg, seqs: List[List[int]], starts: List[int], rnd: Round,
            device) -> List[torch.Tensor]:
    """Each sequence's fp32 logits [len - start, V] from its position
    ``start`` on, the shorter ones right-padded in a batch of like lengths
    (a causal model's earlier positions do not see the pad)."""
    out: List[torch.Tensor] = [None] * len(seqs)
    order = sorted(range(len(seqs)), key=lambda i: len(seqs[i]))
    budget = 4096                       # positions a reference batch holds
    i = 0
    while i < len(order):
        n = max(1, budget // max(1, len(seqs[order[i]])))
        group = order[i:i + n]
        i += n
        s = max(len(seqs[j]) for j in group)
        toks = torch.zeros((len(group), s), dtype=torch.long, device=device)
        for r, j in enumerate(group):
            toks[r, :len(seqs[j])] = torch.tensor(seqs[j], device=device)
        lo = min(starts[j] for j in group)
        logits, _ = dense.forward(w, cfg, toks, student=True, rnd=rnd, head_from=lo)
        for r, j in enumerate(group):
            out[j] = logits[r, starts[j] - lo:len(seqs[j]) - lo]
    return out


@torch.no_grad()
def gaps(w: Dict[str, torch.Tensor], cfg: dict,
         served: Sequence[Tuple[List[int], List[int]]], device,
         control: Round = None) -> List[List[float]]:
    """For each (prompt, served tokens): the gap at each served token —
    the reference's best logit minus the served token's (or, with
    ``control``, minus the logit of the token the control puts first)."""
    seqs = [list(p) + list(t[:-1]) for p, t in served]
    starts = [len(p) - 1 for p, _ in served]
    with fp32_matmuls():
        ref = _logits(w, cfg, seqs, starts, exact, device)
        low = (_logits(w, cfg, seqs, starts, control, device)
               if control is not None else None)
    out = []
    for j, (p, t) in enumerate(served):
        rows = ref[j]
        best = rows.max(dim=-1).values
        if low is None:
            pick = torch.tensor(t, device=device)
        else:
            pick = low[j].argmax(dim=-1)
        got = rows.gather(-1, pick[:, None])[:, 0]
        out.append((best - got).tolist())
    return out
