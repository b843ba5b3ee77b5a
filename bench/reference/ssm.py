"""Mamba2 as arXiv:2405.21060 defines it (pre-norm residual blocks of
in_proj -> causal depthwise conv + SiLU -> SSD -> D skip -> gate by SiLU(z)
-> RMSNorm -> out_proj; tied embeddings), with BitDistill's student changes:
ternary in_proj / out_proj on int8 activations (the gated norm before
out_proj is the SubLN).  The SSD is computed in its chunked (dual) form,
written here from the paper: within a chunk the masked "attention"
``(C·Bᵀ ∘ exp(segsum(dt·A))) · (dt·x)``, across chunks the states carried
by their decays.  fp32; ``rnd`` as in ``reference/dense.py``."""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from reference.common import Round, exact, fp_linear, rms_norm, silu, ternary_linear


def segsum(x: torch.Tensor) -> torch.Tensor:
    """x [..., T] -> [..., T, T]: out[i, j] = sum x[j+1..i] for j <= i, -inf
    above the diagonal."""
    t = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    out = cs[..., :, None] - cs[..., None, :]
    mask = torch.ones(t, t, dtype=torch.bool, device=x.device).tril()
    return out.masked_fill(~mask, float("-inf"))


def ssd(x, a_dt, dt, B, C, chunk: int) -> torch.Tensor:
    """x [b, s, h, p], a_dt = dt·A and dt [b, s, h], B, C [b, s, n] ->
    y [b, s, h, p] from a zero state (h_t = exp(dt_t A) h_{t-1} + dt_t x_t
    B_tᵀ, y_t = h_t C_t)."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    q = min(chunk, s)
    while s % q:
        q -= 1
    c = s // q
    X = (x * dt[..., None]).reshape(b, c, q, h, p)
    A = a_dt.reshape(b, c, q, h).permute(0, 3, 1, 2)               # [b,h,c,q]
    Bc, Cc = B.reshape(b, c, q, n), C.reshape(b, c, q, n)
    acum = torch.cumsum(A, dim=-1)
    L = torch.exp(segsum(A))                                       # [b,h,c,q,q]
    cb = Cc @ Bc.transpose(-1, -2)                                 # [b,c,q,q]
    m = cb[:, None] * L                                            # [b,h,c,q,q]
    y = torch.einsum("bhcls,bcshp->bclhp", m, X)
    decay = torch.exp(acum[..., -1:] - acum)                       # [b,h,c,q]
    states = torch.einsum("bcln,bhcl,bclhp->bchpn", Bc, decay, X)
    carry = torch.zeros((b, h, p, n), dtype=x.dtype, device=x.device)
    ins = []
    for i in range(c):
        ins.append(carry)
        carry = carry * torch.exp(acum[:, :, i, -1])[..., None, None] + states[:, i]
    ins = torch.stack(ins, dim=1)                                  # [b,c,h,p,n]
    y = y + torch.einsum("bcln,bchpn,bhcl->bclhp", Cc, ins, torch.exp(acum))
    return y.reshape(b, s, h, p)


def forward(w: Dict[str, torch.Tensor], cfg: dict, tokens: torch.Tensor,
            student: bool = True, rnd: Round = exact,
            collect: Optional[int] = None, head_from: int = 0
            ) -> Tuple[torch.Tensor, None]:
    """tokens [B, S] -> (fp32 logits [B, S - head_from, V], None)."""
    if collect is not None:
        raise ValueError("a Mamba2 stack has no attention states")
    lin = ternary_linear if student else fp_linear
    b, s = tokens.shape
    d, n, hd = cfg["d_model"], cfg["d_state"], cfg["headdim"]
    di = cfg["expand"] * d
    h = di // hd
    k = cfg["d_conv"]
    eps = cfg["norm_epsilon"]
    table = w["embed.table"]
    x = rnd(table[tokens])
    for l in range(cfg["n_layer"]):
        p = f"stack.layers.{l}.mamba."
        u = rnd(rms_norm(x, w[f"stack.layers.{l}.norm1.scale"], eps))
        zxbcdt = rnd(lin(u, w[p + "in_proj.w"]))
        z, xbc, dtr = zxbcdt[..., :di], zxbcdt[..., di:2 * di + 2 * n], zxbcdt[..., 2 * di + 2 * n:]
        conv = F.conv1d(F.pad(xbc.transpose(1, 2), (k - 1, 0)),
                        w[p + "conv_w"].t()[:, None, :], w[p + "conv_b"],
                        groups=xbc.shape[-1]).transpose(1, 2)
        xbc = rnd(silu(conv))
        xs = xbc[..., :di].reshape(b, s, h, hd)
        Bm, Cm = xbc[..., di:di + n], xbc[..., di + n:]
        dt = F.softplus(dtr + w[p + "dt_bias"])
        a_dt = dt * -torch.exp(w[p + "A_log"])
        y = ssd(xs, a_dt, dt, Bm, Cm, cfg["chunk_size"]) + w[p + "D"][:, None] * xs
        y = rnd(rnd(y.reshape(b, s, di)) * rnd(silu(z)))
        y = rnd(rms_norm(y, w[p + "norm.scale"], 1e-6))
        x = rnd(x + rnd(lin(y, w[p + "out_proj.w"])))
    x = rnd(rms_norm(x[:, head_from:], w["final_norm.scale"], eps))
    return x @ rnd(table).t(), None
