"""BitDistill stage-3 losses (Eqs. 8-14) — port of ``repro/core/distill.py``.

* ``logits_distill_loss``     — temperature-softened KL(teacher ‖ student), Eq. 8.
* ``attention_relation_loss`` — MiniLM multi-head Q/K/V relation KL, Eq. 10-12
                                (Algorithm 1: head re-split, L2 normalize,
                                R·Rᵀ, softmax, batchmean KL).
* ``bitdistill_loss``         — L = L_CE + λ·L_LD + γ·L_AD, Eq. 13.

With ``use_kernel`` the relation loss runs the relation_kd CUDA kernel
(kernels/relation_kd), which computes the same quantity without forming the
L×L relation matrices.  Teacher-side tensors are detached (the JAX
``stop_gradient``).

Under a tensor-parallel split of more than one rank
(``distributed/tensor_parallel.py``) the logits are the rank's vocabulary
columns, and the CE and the logits KL are vocabulary-parallel: the row
maximum maximized over ``"model"``, the sum of exponentials summed (*g*),
and the label's logit read on the rank that owns it (summed, *g*), so every
rank gets the whole vocabulary's values (within ~1e-7 relative of
``log_softmax``'s).  The pad columns arrive at -1e30, masked by the model
by their global index.  The relation loss takes states gathered whole over
the heads, so it is the unsplit computation on every rank.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from repro_torch.core.quant import div
from repro_torch.distributed import tensor_parallel as tp

CLAMP = 1e-8


def _vocab_split():
    """The active split when it shards the vocabulary over ranks, else None."""
    split = tp.active()
    return split if split is not None and split.size > 1 else None


def _log_softmax(z: torch.Tensor, split) -> torch.Tensor:
    """fp32 log-softmax over the last axis, whose columns are split over
    ``"model"`` under ``split``: z - (m + log Σ exp(z - m)).  The whole
    rows' log-sum-exp enters each rank's columns through *f*: a rank's
    terms give its part of the log-sum-exp's gradient, summed over the
    ranks before it reaches their exponentials through *g*."""
    if split is None:
        return torch.log_softmax(z, dim=-1)
    m = split.all_max(torch.amax(z, dim=-1, keepdim=True))
    zm = z - m
    s = tp.reduce_from(torch.sum(torch.exp(zm), dim=-1, keepdim=True))
    return zm - tp.copy_to(torch.log(s))


def _nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    split = _vocab_split()
    logp = _log_softmax(logits.to(torch.float32), split)
    if split is None:
        return -torch.gather(logp, -1, labels.long()[..., None])[..., 0]
    n = logp.shape[-1]
    local = labels.long() - split.rank * n
    own = (local >= 0) & (local < n)
    picked = torch.gather(logp, -1, torch.where(own, local, 0)[..., None])[..., 0]
    return -tp.reduce_from(torch.where(own, picked, torch.zeros_like(picked)))


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Token-mean CE.  logits [..., V], labels [...] int, mask [...] {0,1}."""
    nll = _nll(logits, labels)
    if mask is None:
        return torch.mean(nll)
    mask = mask.to(torch.float32)
    return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)


def nll_sum(logits: torch.Tensor, labels: torch.Tensor,
            mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The numerator of ``softmax_cross_entropy``: the (masked) sum of the
    tokens' NLL, for a mean whose denominator is counted elsewhere (a
    sharded step's rows of a batch)."""
    nll = _nll(logits, labels)
    return torch.sum(nll if mask is None else nll * mask.to(torch.float32))


def kl_divergence(p_logits: torch.Tensor, q_logits: torch.Tensor) -> torch.Tensor:
    """KL(P ‖ Q) per row from logits; fp32; [..., V] -> [...]."""
    split = _vocab_split()
    p_log = _log_softmax(p_logits.to(torch.float32), split)
    q_log = _log_softmax(q_logits.to(torch.float32), split)
    p = torch.exp(p_log)
    kl = torch.sum(p * (p_log - q_log), dim=-1)
    return kl if split is None else tp.reduce_from(kl)


def logits_distill_loss(student_logits: torch.Tensor,
                        teacher_logits: torch.Tensor, tau: float = 5.0,
                        mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Eq. 8: mean_t KL( softmax(z_T/τ) ‖ softmax(z_S/τ) ), no τ² rescale."""
    if mask is None:
        return torch.mean(_token_kl(student_logits, teacher_logits, tau))
    return logits_distill_sum(student_logits, teacher_logits, tau, mask) / \
        torch.clamp(torch.sum(mask.to(torch.float32)), min=1.0)


def _token_kl(student_logits, teacher_logits, tau):
    return kl_divergence(div(teacher_logits.detach().to(torch.float32), tau),
                         div(student_logits.to(torch.float32), tau))


def logits_distill_sum(student_logits: torch.Tensor,
                       teacher_logits: torch.Tensor, tau: float = 5.0,
                       mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The numerator of ``logits_distill_loss``: the (masked) sum of the
    tokens' KL, for a sharded step's rows of a batch."""
    kl = _token_kl(student_logits, teacher_logits, tau)
    return torch.sum(kl if mask is None else kl * mask.to(torch.float32))


# ---------------------------------------------------------------------------
# Algorithm 1: multi-head attention relation distillation
# ---------------------------------------------------------------------------

def _resplit_heads(states: torch.Tensor, split_heads: int) -> torch.Tensor:
    """[B, H, L, Dh] -> [B, split_heads, L, D] with D = H*Dh/split_heads
    (transpose -> [B, L, H, Dh] -> reshape [B, L, split, D] -> transpose)."""
    b, h, l, dh = states.shape
    if (h * dh) % split_heads:
        raise ValueError(f"H*Dh = {h * dh} is not divisible by "
                         f"split_heads = {split_heads}")
    d = h * dh // split_heads
    x = states.permute(0, 2, 1, 3).reshape(b, l, split_heads, d)
    return x.permute(0, 2, 1, 3)


def _l2_normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    n = torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True))
    return x / torch.clamp(n, min=eps)


def _prep(states: torch.Tensor, split_heads: int) -> torch.Tensor:
    return _l2_normalize(_resplit_heads(states.to(torch.float32), split_heads))


def relation_kl(s_states: torch.Tensor, t_states: torch.Tensor,
                split_heads: int, temperature: float = 1.0,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """KL between relation matrices of one state kind: batchmean over the
    (B·split_heads·L) rows of KL(t_row ‖ s_row).  states [B, H, L, Dh];
    ``mask`` [B, L] excludes padded rows and columns."""
    s = _prep(s_states, split_heads)
    t = _prep(t_states, split_heads).detach()
    s_rel = div(torch.einsum("bhld,bhmd->bhlm", s, s), temperature)
    t_rel = div(torch.einsum("bhld,bhmd->bhlm", t, t), temperature)
    if mask is not None:
        colmask = mask[:, None, None, :].to(torch.bool)
        s_rel = torch.where(colmask, s_rel, torch.full_like(s_rel, -1e30))
        t_rel = torch.where(colmask, t_rel, torch.full_like(t_rel, -1e30))
    s_logp = torch.log(torch.clamp(torch.softmax(s_rel, dim=-1), min=CLAMP))
    t_prob = torch.clamp(torch.softmax(t_rel, dim=-1), min=CLAMP)
    kl_rows = torch.sum(t_prob * (torch.log(t_prob) - s_logp), dim=-1)
    if mask is not None:
        rowmask = mask[:, None, :].expand(kl_rows.shape).to(torch.float32)
        return torch.sum(kl_rows * rowmask) / torch.clamp(torch.sum(rowmask), min=1.0)
    return torch.mean(kl_rows)


def relation_kl_blocked(s_states: torch.Tensor, t_states: torch.Tensor,
                        split_heads: int, temperature: float = 1.0,
                        block: int = 512) -> torch.Tensor:
    """Row-blocked Eq. 12: the value of relation_kl with peak memory
    O(block·L) instead of O(L²)."""
    s = _prep(s_states, split_heads)
    t = _prep(t_states, split_heads).detach()
    b, h, l, d = s.shape
    s2, t2 = s.reshape(b * h, l, d), t.reshape(b * h, l, d)
    blk = min(block, l)
    total = torch.zeros((), dtype=torch.float32, device=s.device)
    for r0 in range(0, l, blk):
        sl, tl = s2[:, r0:r0 + blk], t2[:, r0:r0 + blk]
        s_rel = div(torch.einsum("bld,bmd->blm", sl, s2), temperature)
        t_rel = div(torch.einsum("bld,bmd->blm", tl, t2), temperature)
        s_logp = torch.log(torch.clamp(torch.softmax(s_rel, dim=-1), min=CLAMP))
        t_prob = torch.clamp(torch.softmax(t_rel, dim=-1), min=CLAMP)
        kl = torch.sum(t_prob * (torch.log(t_prob) - s_logp), dim=-1)
        total = total + torch.sum(kl)
    return total / (b * h * l)


def attention_relation_loss(student_states: torch.Tensor,
                            teacher_states: torch.Tensor,
                            split_heads: int = 4,
                            temperature: float = 1.0,
                            mask: Optional[torch.Tensor] = None,
                            alphas: Tuple[float, float, float] = (1.0, 1.0, 1.0),
                            use_kernel: bool = False,
                            blocked: bool = False) -> torch.Tensor:
    """Eq. 11 / Algorithm 1.  states: [3, B, H, L, Dh] stacked (Q, K, V).
    The kernel path, like the JAX one, takes no mask."""
    if use_kernel:
        from repro_torch.kernels.relation_kd import ops as kops
        return kops.relation_kd_loss(student_states, teacher_states,
                                     split_heads=split_heads,
                                     temperature=temperature, alphas=alphas)
    total = torch.zeros((), dtype=torch.float32, device=student_states.device)
    for i in range(3):
        if blocked and mask is None:
            kl = relation_kl_blocked(student_states[i], teacher_states[i],
                                     split_heads, temperature)
        else:
            kl = relation_kl(student_states[i], teacher_states[i],
                             split_heads, temperature, mask)
        total = total + alphas[i] * kl
    return total


# ---------------------------------------------------------------------------
# Eq. 13: the stage-3 objective
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DistillConfig:
    """Paper defaults: τ=5; classification λ=10, γ=1e5; summarization λ=1, γ=1e3."""
    tau: float = 5.0
    lambda_ld: float = 10.0
    gamma_ad: float = 1e5
    distill_layer: int = -1        # -1 -> last attention layer (Fig. 3b)
    split_heads: int = 4
    relation_temperature: float = 1.0
    alphas: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    use_ld: bool = True
    use_ad: bool = True
    use_kernel: bool = False
    blocked: bool = False          # row-blocked AD (large L)


def bitdistill_loss(student_logits: torch.Tensor,
                    teacher_logits: Optional[torch.Tensor],
                    student_states: Optional[torch.Tensor],
                    teacher_states: Optional[torch.Tensor],
                    labels: torch.Tensor,
                    loss_mask: Optional[torch.Tensor],
                    cfg: DistillConfig, den=None, n: int = 1
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """L = L_CE + λ L_LD + γ L_AD.  Returns (loss, metrics).

    ``den`` and ``n`` (a sharded step's rows of a batch): the CE and the
    logits KL are the rows' sums over ``den``, the whole batch's mask count,
    and the relation loss (a mean over the rows) is divided by the ``n``
    ranks the batch is split over, so that each term summed over those
    ranks is the whole batch's."""
    if den is None:
        ce = softmax_cross_entropy(student_logits, labels, loss_mask)
    else:
        ce = nll_sum(student_logits, labels, loss_mask) / den
    metrics = {"loss_ce": ce}
    loss = ce
    if cfg.use_ld and teacher_logits is not None:
        if den is None:
            ld = logits_distill_loss(student_logits, teacher_logits, cfg.tau,
                                     loss_mask)
        else:
            ld = logits_distill_sum(student_logits, teacher_logits, cfg.tau,
                                    loss_mask) / den
        loss = loss + cfg.lambda_ld * ld
        metrics["loss_ld"] = ld
    if cfg.use_ad and student_states is not None and teacher_states is not None:
        ad = attention_relation_loss(
            student_states, teacher_states, cfg.split_heads,
            cfg.relation_temperature, mask=None, alphas=cfg.alphas,
            use_kernel=cfg.use_kernel, blocked=cfg.blocked)
        if n > 1:
            ad = ad / n
        loss = loss + cfg.gamma_ad * ad
        metrics["loss_ad"] = ad
    metrics["loss"] = loss
    return loss, metrics
