"""The distillation step in plain PyTorch (BitDistill stage 3, Eq. 13):

  L = CE(student) + λ · KL(softmax(z_T/τ) ‖ softmax(z_S/τ))
      + γ · Σ_{q,k,v} mean_rows KL(softmax(R_T) ‖ softmax(R_S)),

CE and the logits KL as means over the loss mask's tokens (no τ²), the
relation term (MiniLM, Algorithm 1) over the states of one attention
layer: each of q, k, v re-split into ``split_heads`` heads, each row
L2-normalized, R = X·Xᵀ / temperature, the KL of each row, averaged over
the (batch · split_heads · L) rows.  The teacher is the full-precision
model; the student the ternary one with SubLN.  Then AdamW as the program
configures it: the gradient's global norm clipped to ``grad_clip``, fp32
moments, bias correction, decoupled weight decay on tensors of rank 2 or
more where a block's tensors count one rank more (stacked over the layers),
``p -= lr · (m̂ / (√v̂ + ε) + wd · p)``.

The batch is run a row at a time, each row's gradient added: the same
sums, in pieces that fit beside nothing else on the card."""
from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch

from reference import dense, ssm
from reference.common import Round, exact, fp32_matmuls


def _model(cfg):
    return dense if cfg["family"] == "dense" else ssm


def log_softmax_kl(p_logits: torch.Tensor, q_logits: torch.Tensor) -> torch.Tensor:
    """KL(softmax(p) ‖ softmax(q)) per row."""
    lp = torch.log_softmax(p_logits, dim=-1)
    lq = torch.log_softmax(q_logits, dim=-1)
    return torch.sum(torch.exp(lp) * (lp - lq), dim=-1)


def relation_rows(s_states, t_states, split_heads: int, temp: float):
    """Σ over the rows of KL(t_row ‖ s_row) of the three kinds, and the
    row count of one kind."""
    total = 0.0
    rows = 0
    for i in range(3):
        def prep(x):
            b, h, l, dh = x.shape
            y = x.permute(0, 2, 1, 3).reshape(b, l, split_heads, h * dh // split_heads)
            y = y.permute(0, 2, 1, 3)
            return y / torch.clamp(torch.linalg.vector_norm(y, dim=-1, keepdim=True),
                                   min=1e-12)
        s, t = prep(s_states[i]), prep(t_states[i]).detach()
        rs = s @ s.transpose(-1, -2) / temp
        rt = t @ t.transpose(-1, -2) / temp
        total = total + log_softmax_kl(rt, rs).sum()
        rows = s.shape[0] * s.shape[1] * s.shape[2]
    return total, rows


def loss_parts(cfg, dcfg, teacher_w, params, batch, rows: slice, den: float,
               total_rows: int, rnd: Round):
    """The block ``rows``' share of each loss term (sums over the whole
    batch's denominators)."""
    model = _model(cfg)
    tok = batch["tokens"][rows]
    lab = batch["labels"][rows].long()
    mask = batch["loss_mask"][rows]
    collect = dcfg.get("distill_layer") if dcfg.get("use_ad", True) else None
    with torch.no_grad():
        t_logits, t_states = model.forward(teacher_w, cfg, tok, student=False, rnd=rnd,
                                           collect=collect)
    s_logits, s_states = model.forward(params, cfg, tok, student=True, rnd=rnd,
                                       collect=collect)
    nll = -torch.log_softmax(s_logits, dim=-1).gather(-1, lab[..., None])[..., 0]
    ce = torch.sum(nll * mask) / den
    tau = float(dcfg["tau"])
    ld = torch.sum(log_softmax_kl(t_logits / tau, s_logits / tau) * mask) / den
    parts = {"loss_ce": ce, "loss_ld": ld}
    if collect is not None:
        rel, n = relation_rows(s_states, t_states, int(dcfg["split_heads"]),
                               float(dcfg["relation_temperature"]))
        parts["loss_ad"] = rel / (n * total_rows / tok.shape[0])
    return parts


def adamw(params, grads, m, v, step: int, opt: dict) -> None:
    b1, b2, eps = opt["b1"], opt["b2"], opt["eps"]
    gnorm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
    scale = torch.clamp(opt["grad_clip"] / torch.clamp(gnorm, min=1e-12), max=1.0)
    bc1, bc2 = 1 - b1 ** step, 1 - b2 ** step
    with torch.no_grad():
        for k, p in params.items():
            g = grads[k] * scale
            m[k].mul_(b1).add_((1 - b1) * g)
            v[k].mul_(b2).add_((1 - b2) * g * g)
            upd = (m[k] / bc1) / (torch.sqrt(v[k] / bc2) + eps)
            rank = p.dim() + (1 if k.startswith("stack.layers.") else 0)
            if opt["weight_decay"] > 0 and rank >= 2:
                upd = upd + opt["weight_decay"] * p
            p.sub_(opt["lr"] * upd)


def steps(cfg: dict, traffic: dict, teacher_w: Dict[str, torch.Tensor],
          student_w: Dict[str, torch.Tensor], batches: List[dict],
          rnd: Round = exact) -> dict:
    """The first ``len(batches)`` steps from the master weights: each step's
    loss terms, every tensor's first gradient as the optimizer takes it
    (clipped), its change over the steps, and the first gradient's norm."""
    dcfg, opt = traffic["distill"], traffic["optimizer"]
    params = {k: t.detach().clone().requires_grad_(True) for k, t in student_w.items()}
    m = {k: torch.zeros_like(t) for k, t in params.items()}
    v = {k: torch.zeros_like(t) for k, t in params.items()}
    losses, first = [], None
    with fp32_matmuls():
        for step, batch in enumerate(batches, start=1):
            b = batch["tokens"].shape[0]
            den = float(torch.clamp(batch["loss_mask"].sum(), min=1.0))
            grads = {k: torch.zeros_like(t) for k, t in params.items()}
            sums: Dict[str, float] = {}
            for r in range(b):
                parts = loss_parts(cfg, dcfg, teacher_w, params, batch,
                                   slice(r, r + 1), den, b, rnd)
                loss = parts["loss_ce"] + float(dcfg["lambda_ld"]) * parts["loss_ld"]
                if "loss_ad" in parts:
                    loss = loss + float(dcfg["gamma_ad"]) * parts["loss_ad"]
                gs = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
                for (k, _), g in zip(params.items(), gs):
                    if g is not None:
                        grads[k] += g
                for k, val in parts.items():
                    sums[k] = sums.get(k, 0.0) + float(val.detach())
                del parts, loss, gs
            losses.append(sums)
            if first is None:
                gnorm = math.sqrt(sum(float(torch.sum(g * g)) for g in grads.values()))
                clip = min(1.0, opt["grad_clip"] / max(gnorm, 1e-12))
                first = {k: float(torch.linalg.vector_norm(g)) * clip
                         for k, g in grads.items()}
                raw = {k: float(torch.linalg.vector_norm(g)) for k, g in grads.items()}
            adamw(params, grads, m, v, step, opt)
            del grads
    change = {k: float(torch.linalg.vector_norm(params[k].detach() - student_w[k]))
              for k in params}
    return {"losses": losses, "grad": first, "grad_raw": raw, "change": change,
            "sizes": {k: t.numel() for k, t in params.items()}}


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float],
              keep: Optional[List[str]] = None) -> Dict[str, float]:
    """|‖prog‖ - ‖ref‖| / max(‖ref‖, the median tensor's ‖ref‖), by tensor."""
    names = keep if keep is not None else list(ref)
    med = sorted(ref[k] for k in names)[len(names) // 2]
    return {k: abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30) for k in names}


def compare(losses: List[Dict[str, float]], grad: Dict[str, float],
            change: Dict[str, float], ref: dict) -> (Dict[str, float], dict):
    """The numbers ``correct`` compares, of a run's checked steps (each
    step's loss terms, the first gradient's and the change's norms by
    tensor) against :func:`steps`' ``ref``, and where the worst tensors
    are.  ``grad_gap`` and ``change_gap`` are the worst tensor's gaps;
    ``change_gap_largest`` is the gap of the tensor with the most values,
    which no small tensor's noise moves.  The change leaves out the tensors
    whose reference gradient is under a thousandth of the median tensor's:
    AdamW moves them by round-off alone."""
    out = {}
    for term in ref["losses"][0]:
        out[term + "_gap"] = max(abs(p[term] - r[term]) / max(abs(r[term]), 1e-30)
                                 for p, r in zip(losses, ref["losses"]))
    g = leaf_gaps(grad, ref["grad"])
    grad_at = max(g, key=g.get)
    out["grad_gap"] = g[grad_at]
    raw = ref["grad_raw"]
    med = sorted(raw.values())[len(raw) // 2]
    moved = [k for k, v in raw.items() if v >= 1e-3 * med]
    c = leaf_gaps(change, ref["change"], moved)
    change_at = max(c, key=c.get)
    out["change_gap"] = c[change_at]
    out["change_gap_largest"] = c[max(moved, key=ref["sizes"].get)]
    return out, {"grad_worst_leaf": grad_at, "change_worst_leaf": change_at,
                 "left_out": sorted(set(raw) - set(moved))}
