"""Grouped-query self-attention with BitLinear projections, qk_norm, RoPE,
SubLN, and decode over the paged KV pools — port of ``repro/nn/attention.py``.

Layouts: activations [B, S, D]; per-head tensors [B, S, H, Dh]; paged pools
``{"k","v"}`` [num_blocks, Hkv, block_size, Dh], updated in place (the JAX
module returns new pools; here the step's K/V are stored into the caller's
tensors).  All softmax math in fp32.  Contiguous-cache ``decode``, the
blocked (flash-style) forward, cross-attention and ``collect_states`` come
with later slices.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.core import quant as Q
from repro_torch.core.bitlinear import BitLinear, SubLN
from repro_torch.kernels.paged_attention import ops as pa_ops
from repro_torch.kernels.paged_prefill import ops as pp_ops
from repro_torch.nn.layers import RMSNorm, apply_rope
from repro_torch.nn.module import DEFAULT_POLICY, DTypePolicy

NEG_INF = -2.0e38
Cache = Dict[str, torch.Tensor]


class Attention(nn.Module):
    def __init__(self, d_model: int, n_heads: int, n_kv_heads: int,
                 head_dim: int, qkv_bias: bool = False, qk_norm: bool = False,
                 rope_theta: float = 10000.0, logit_softcap: float = 0.0,
                 subln: bool = False, scores_dtype: str = "float32",
                 quant: Q.QuantConfig = Q.FP,
                 policy: DTypePolicy = DEFAULT_POLICY,
                 gen: Optional[torch.Generator] = None,
                 device: Optional[torch.device] = None):
        super().__init__()
        if n_heads % n_kv_heads:
            raise ValueError(f"n_heads={n_heads} is not a multiple of "
                             f"n_kv_heads={n_kv_heads}")
        if scores_dtype != "float32":
            raise ValueError(f"scores_dtype={scores_dtype!r}: only fp32 scores "
                             "are ported")
        self.n_heads, self.n_kv_heads, self.head_dim = n_heads, n_kv_heads, head_dim
        self.rope_theta, self.logit_softcap = rope_theta, logit_softcap
        q_dim, kv_dim = n_heads * head_dim, n_kv_heads * head_dim
        self.q_dim = q_dim
        lin = dict(quant=quant, policy=policy, gen=gen, device=device)
        self.wq = BitLinear(d_model, q_dim, qkv_bias, **lin)
        self.wk = BitLinear(d_model, kv_dim, qkv_bias, **lin)
        self.wv = BitLinear(d_model, kv_dim, qkv_bias, **lin)
        self.wo = BitLinear(q_dim, d_model, False, **lin)
        self.subln = SubLN(q_dim, policy=policy, device=device) if subln else None
        if qk_norm:
            self.q_norm = RMSNorm(head_dim, policy=policy, device=device)
            self.k_norm = RMSNorm(head_dim, policy=policy, device=device)
        else:
            self.q_norm = self.k_norm = None

    # -- projections ----------------------------------------------------------

    def _project_q(self, x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
        b, s, _ = x.shape
        q = self.wq(x).reshape(b, s, self.n_heads, self.head_dim)
        if self.q_norm is not None:
            q = self.q_norm(q)
        return apply_rope(q, positions, self.rope_theta)

    def _project_kv(self, x: torch.Tensor, positions: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        b, s, _ = x.shape
        k = self.wk(x).reshape(b, s, self.n_kv_heads, self.head_dim)
        v = self.wv(x).reshape(b, s, self.n_kv_heads, self.head_dim)
        if self.k_norm is not None:
            k = self.k_norm(k)
        return apply_rope(k, positions, self.rope_theta), v

    # -- attention core --------------------------------------------------------

    def _attend(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                mask: Optional[torch.Tensor]) -> torch.Tensor:
        """q [B,S,Hq,Dh]; k/v [B,T,Hkv,Dh]; mask [B,1,S,T] bool (True =
        keep)."""
        b, s, hq, dh = q.shape
        g = hq // self.n_kv_heads
        qg = q.reshape(b, s, self.n_kv_heads, g, dh).permute(0, 2, 3, 1, 4)
        kf, vf = k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3)
        scores = torch.einsum("bkgsd,bktd->bkgst", qg.to(torch.float32),
                              kf.to(torch.float32))
        scores = scores / math.sqrt(dh)
        if self.logit_softcap > 0.0:
            scores = self.logit_softcap * torch.tanh(scores / self.logit_softcap)
        if mask is not None:
            scores = torch.where(mask[:, :, None], scores,
                                 torch.full_like(scores, NEG_INF))
        w = torch.softmax(scores, dim=-1)
        out = torch.einsum("bkgst,bktd->bkgsd", w, vf.to(torch.float32))
        return out.permute(0, 3, 1, 2, 4).reshape(b, s, hq, dh).to(v.dtype)

    def _out(self, ctx: torch.Tensor) -> torch.Tensor:
        """ctx [B, S, Hq, Dh] -> SubLN + output projection."""
        b, s = ctx.shape[:2]
        flat = ctx.reshape(b, s, self.q_dim)
        if self.subln is not None:
            flat = self.subln(flat)
        return self.wo(flat)

    # -- full-sequence forward ------------------------------------------------

    def forward(self, x: torch.Tensor,
                positions: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Causal self-attention over x [B, S, D] (the JAX ``apply``)."""
        b, s, _ = x.shape
        if positions is None:
            positions = torch.arange(s, device=x.device)[None].expand(b, s)
        q = self._project_q(x, positions)
        k, v = self._project_kv(x, positions)
        ar = torch.arange(s, device=x.device)
        mask = (ar[None, :] <= ar[:, None])[None, None].expand(b, 1, s, s)
        return self._out(self._attend(q, k, v, mask))

    # -- decode over the paged pools ---------------------------------------------

    def decode(self, x: torch.Tensor, cache: Cache, cache_index: torch.Tensor,
               block_tables: torch.Tensor, attn_impl: str = "gather"
               ) -> Tuple[torch.Tensor, Cache]:
        """One token per row: x [B, 1, D]; ``cache_index`` int32 [B] holds each
        row's write position; row ``b``'s position ``i`` lives in pool block
        ``block_tables[b, i // bs]`` at offset ``i % bs``.

        ``attn_impl="fused"`` runs the paged decode kernel (the plain PyTorch
        version for CPU tensors); ``"gather"`` runs that plain version on any
        device: it writes the new K/V, gathers the whole table into a dense
        window and runs masked dense attention."""
        b = x.shape[0]
        idx = cache_index.to(torch.int32).reshape(-1).expand(b).contiguous()
        positions = idx[:, None]
        q = self._project_q(x, positions)
        k_new, v_new = self._project_kv(x, positions)           # [B, 1, Hkv, Dh]
        attend = _pick(attn_impl, pa_ops.paged_attention_decode,
                       pa_ops.paged_attention_decode_plain)
        ctx, _, _ = attend(q[:, 0], k_new[:, 0], v_new[:, 0], cache["k"],
                           cache["v"], block_tables, idx,
                           softcap=self.logit_softcap)
        return self._out(ctx[:, None]), cache

    def decode_chunk(self, x: torch.Tensor, cache: Cache, start: torch.Tensor,
                     lens: torch.Tensor, block_tables: torch.Tensor,
                     attn_impl: str = "gather") -> Tuple[torch.Tensor, Cache]:
        """Chunked-prefill step: x [B, T, D]; token ``j`` of row ``b`` is
        written at ``start[b] + j`` (iff ``j < lens[b]``; pad positions are
        never written into owned blocks) and attends positions
        ``<= start[b] + j``.  Decode rows are ``lens == 1``.  ``attn_impl`` as
        in :meth:`decode` (``"fused"``: the paged prefill kernel)."""
        b, t, _ = x.shape
        start = start.to(torch.int32).reshape(-1).expand(b).contiguous()
        lens = lens.to(torch.int32).reshape(-1).expand(b).contiguous()
        positions = start[:, None] + torch.arange(t, dtype=torch.int32,
                                                  device=x.device)[None]
        q = self._project_q(x, positions)
        k_new, v_new = self._project_kv(x, positions)
        attend = _pick(attn_impl, pp_ops.paged_prefill_chunk,
                       pp_ops.paged_prefill_chunk_plain)
        ctx, _, _ = attend(q, k_new, v_new, cache["k"], cache["v"],
                           block_tables, start, lens, softcap=self.logit_softcap)
        return self._out(ctx), cache

    def init_cache(self, batch: int, max_len: int, dtype: torch.dtype,
                   device: Optional[torch.device] = None) -> Cache:
        shape = (batch, self.n_kv_heads, max_len, self.head_dim)
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)}


def _pick(attn_impl: str, fused, gather):
    if attn_impl == "fused":
        return fused
    if attn_impl == "gather":
        return gather
    raise ValueError(f"unknown attn_impl {attn_impl!r} "
                     "(expected 'fused' or 'gather')")
