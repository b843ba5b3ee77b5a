"""A dense decoder as Qwen3 defines it (pre-norm blocks, grouped-query
attention with RMSNorm on each head's q and k, split-half RoPE, SwiGLU,
tied embeddings), with BitDistill's student changes: ternary projections
on int8 activations and SubLN before ``o_proj`` and ``down_proj``.  fp32
throughout; ``rnd`` rounds each activation the way a lower precision would
hold it (the control), and is the identity otherwise."""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from reference.common import (Round, causal_attention, exact, fp_linear, rms_norm,
                              rope, silu, ternary_linear)


def forward(w: Dict[str, torch.Tensor], cfg: dict, tokens: torch.Tensor,
            student: bool = True, rnd: Round = exact,
            collect: Optional[int] = None, head_from: int = 0
            ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """tokens [B, S] -> (fp32 logits [B, S - head_from, V] of the positions
    from ``head_from`` on, the q, k, v states
    [3, B, H, S, Dh] of layer ``collect`` with the kv heads repeated, or
    None)."""
    lin = ternary_linear if student else fp_linear
    b, s = tokens.shape
    hq, hkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    dh, eps, theta = cfg["head_dim"], cfg["rms_norm_eps"], float(cfg["rope_theta"])
    pos = torch.arange(s, device=tokens.device)
    table = w["embed.table"]
    x = rnd(table[tokens])
    states = None
    for l in range(cfg["num_hidden_layers"]):
        p = f"stack.layers.{l}."
        h = rnd(rms_norm(x, w[p + "norm1.scale"], eps))
        q = rnd(lin(h, w[p + "attn.wq.w"])).reshape(b, s, hq, dh)
        k = rnd(lin(h, w[p + "attn.wk.w"])).reshape(b, s, hkv, dh)
        v = rnd(lin(h, w[p + "attn.wv.w"])).reshape(b, s, hkv, dh)
        q = rnd(rope(rnd(rms_norm(q, w[p + "attn.q_norm.scale"], eps)), pos, theta))
        k = rnd(rope(rnd(rms_norm(k, w[p + "attn.k_norm.scale"], eps)), pos, theta))
        if l == collect:
            g = hq // hkv
            states = torch.stack([q.permute(0, 2, 1, 3),
                                  k.repeat_interleave(g, 2).permute(0, 2, 1, 3),
                                  v.repeat_interleave(g, 2).permute(0, 2, 1, 3)])
        ctx = rnd(causal_attention(q, k, v)).reshape(b, s, hq * dh)
        if student:
            ctx = rnd(rms_norm(ctx, w[p + "attn.subln.scale"], 1e-6))
        x = rnd(x + rnd(lin(ctx, w[p + "attn.wo.w"])))
        h = rnd(rms_norm(x, w[p + "norm2.scale"], eps))
        hh = rnd(rnd(lin(h, w[p + "mlp.up.w"])) * rnd(silu(rnd(lin(h, w[p + "mlp.gate.w"])))))
        if student:
            hh = rnd(rms_norm(hh, w[p + "mlp.subln.scale"], 1e-6))
        x = rnd(x + rnd(lin(hh, w[p + "mlp.down.w"])))
    x = rnd(rms_norm(x[:, head_from:], w["final_norm.scale"], eps))
    return x @ rnd(table).t(), states
