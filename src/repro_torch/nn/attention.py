"""Grouped-query attention with BitLinear projections, qk_norm, RoPE, SubLN,
cross-attention, and decode over the paged KV pools or the contiguous cache
— port of ``repro/nn/attention.py``.

Layouts: activations [B, S, D]; per-head tensors [B, S, H, Dh]; paged pools
``{"k","v"}`` [num_blocks, Hkv, block_size, Dh] and the contiguous cache
``{"k","v"}`` [B, Hkv, max_len, Dh], both updated in place (the JAX module
returns new ones; here the step's K/V are stored into the caller's
tensors).  Softmax statistics in fp32.  ``scores_dtype="bfloat16"`` is
JAX's bf16 scores mode (the operands of both products rounded to bf16,
fp32 accumulation, the exp and the weights in bf16); ``impl="blocked"`` is
JAX's flash-style forward, which streams ``block_kv`` keys at a time with
an online softmax in fp32 and runs only in the full-sequence forward.
``causal=False`` is the encoder's unmasked self-attention; ``cross=True``
takes K/V from a memory (encoder output, image embeddings) without RoPE or
a causal mask, and decodes over a static cache [B, Hkv, T, Dh] holding the
projected memory (``models/lm.py::CausalLM.init_cache``).

Under a tensor-parallel split (``distributed/tensor_parallel.py``) the full
forward computes the rank's ``n_heads / tp`` query heads (RoPE and qk_norm
per head, so local): *f* on x, column-parallel q/k/v, SubLN and a
row-parallel ``wo`` (*g*).  Where the plan replicates the kv projections
(``"kv_heads"`` fewer than, or not divisible by, the ranks) each rank
projects every kv head and its query heads read their own; the kv weights'
gradients are then partial sums, reduced by the split.  The head counts
of the attention core are read from the tensors, so it runs on either.
The distill states are gathered whole over the heads.  A cross layer
splits the same way, its K/V projected from the memory (which enters
through *f* too, so that its gradient sums over the ranks).

``decode`` under a split runs on the rank's share of the contiguous cache,
placed by the plan from ``cache_axes()`` (``Split.cache_spec``):

* kv heads split (they divide over ``"model"``): the rank projects, stores
  and attends its kv heads with its query heads; ``wo`` row-parallel;
* positions split (``"kv_seq"``): every rank projects the new K/V whole and
  the rank holding position ``cache_index[b]`` stores it; the query heads
  are gathered whole, each rank attends its positions and the ranks merge
  by log-sum-exp (the rows' maximum maximized over the position axes, then
  the denominators at that maximum summed, and the numerators: with bf16
  scores each weight normalized and rounded to bf16 first, as
  :meth:`Attention._attend` rounds it); the rank keeps its heads' context
  for SubLN and ``wo``;
* whole: each rank attends its query heads over their kv heads.

Where the positions are split over more than one rank
(``tensor_parallel.exact``) the merge takes its exact form: the scores
and the weighted sums of products summed in float64 and rounded once, so
that no cut of the positions, nor the order of the ranks' sums, moves a
value (``exact_sum`` gives an unsharded decode the same form).  With the
heads split, or the cache whole, no sum crosses the ranks: a rank attends
as the unsharded decode does.

A cross layer's static cache takes the same placement and writes nothing.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.core import quant as Q
from repro_torch.core.bitlinear import BitLinear, SubLN
from repro_torch.distributed import tensor_parallel as tp
from repro_torch.kernels.paged_attention import ops as pa_ops
from repro_torch.kernels.paged_attention import ref as pa_ref
from repro_torch.kernels.paged_prefill import ops as pp_ops
from repro_torch.kernels.paged_prefill import ref as pp_ref
from repro_torch.nn.layers import RMSNorm, apply_rope
from repro_torch.nn.module import Axes, DEFAULT_POLICY, DTypePolicy, child_axes

NEG_INF = -2.0e38
BF16_MASK = -3.0e38          # JAX's mask fill under bf16 scores
Cache = Dict[str, torch.Tensor]
_SCORES_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class Attention(nn.Module):
    def __init__(self, d_model: int, n_heads: int, n_kv_heads: int,
                 head_dim: int, qkv_bias: bool = False, qk_norm: bool = False,
                 rope_theta: float = 10000.0, use_rope: bool = True,
                 causal: bool = True, cross: bool = False,
                 logit_softcap: float = 0.0, subln: bool = False,
                 scores_dtype: str = "float32",
                 impl: str = "dense", block_kv: int = 1024,
                 quant: Q.QuantConfig = Q.FP,
                 policy: DTypePolicy = DEFAULT_POLICY,
                 gen: Optional[torch.Generator] = None,
                 device: Optional[torch.device] = None):
        super().__init__()
        if n_heads % n_kv_heads:
            raise ValueError(f"n_heads={n_heads} is not a multiple of "
                             f"n_kv_heads={n_kv_heads}")
        if scores_dtype not in _SCORES_DTYPES:
            raise ValueError(f"scores_dtype={scores_dtype!r}: 'float32' or "
                             "'bfloat16'")
        if impl not in ("dense", "blocked"):
            raise ValueError(f"attn_impl={impl!r}: 'dense' or 'blocked'")
        if block_kv < 1:
            raise ValueError(f"block_kv={block_kv} must be at least 1")
        self.n_heads, self.n_kv_heads, self.head_dim = n_heads, n_kv_heads, head_dim
        self.scores_dtype = _SCORES_DTYPES[scores_dtype]
        self.impl, self.block_kv = impl, block_kv
        self.rope_theta, self.logit_softcap = rope_theta, logit_softcap
        # a contiguous decode in the exact form a split over more than one
        # rank takes (``_attend_merged``) off a split too: an unsharded
        # reference of a split's decode (``models/lm.py::set_exact``)
        self.exact_sum = False
        # a cross layer's K/V come from the memory: no RoPE and no causal mask
        self.rope = use_rope and not cross
        self.causal, self.cross = causal, cross
        q_dim, kv_dim = n_heads * head_dim, n_kv_heads * head_dim
        self.q_dim = q_dim
        lin = dict(quant=quant, policy=policy, gen=gen, device=device)
        self.wq = BitLinear(d_model, q_dim, qkv_bias, axes=("embed", "heads"), **lin)
        self.wk = BitLinear(d_model, kv_dim, qkv_bias, axes=("embed", "kv_heads"),
                            **lin)
        self.wv = BitLinear(d_model, kv_dim, qkv_bias, axes=("embed", "kv_heads"),
                            **lin)
        self.wo = BitLinear(q_dim, d_model, False, axes=("heads", "embed"), **lin)
        self.subln = SubLN(q_dim, policy=policy, device=device,
                           axis_name="heads") if subln else None
        if qk_norm:
            self.q_norm = RMSNorm(head_dim, policy=policy, device=device,
                                  axis_name="head_dim")
            self.k_norm = RMSNorm(head_dim, policy=policy, device=device,
                                  axis_name="head_dim")
        else:
            self.q_norm = self.k_norm = None

    def param_axes(self) -> Dict[str, Axes]:
        return child_axes(self)

    # -- projections ----------------------------------------------------------

    def _project_q(self, x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
        b, s, _ = x.shape
        q = self.wq(x).reshape(b, s, -1, self.head_dim)
        if self.q_norm is not None:
            q = self.q_norm(q)
        return apply_rope(q, positions, self.rope_theta) if self.rope else q

    def _project_kv(self, x: torch.Tensor, positions: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        b, s, _ = x.shape
        k = self.wk(x).reshape(b, s, -1, self.head_dim)
        v = self.wv(x).reshape(b, s, -1, self.head_dim)
        if self.k_norm is not None:
            k = self.k_norm(k)
        if self.rope:
            k = apply_rope(k, positions, self.rope_theta)
        return k, v

    def project_memory(self, memory: torch.Tensor) -> Cache:
        """A cross layer's static cache: the memory [B, T, D] projected to
        ``{"k","v"}`` [B, Hkv, T, Dh] (JAX ``CausalLM._seed_cross``)."""
        k, v = self._project_kv(memory, None)
        return {"k": k.permute(0, 2, 1, 3), "v": v.permute(0, 2, 1, 3)}

    # -- attention core --------------------------------------------------------

    def _attend(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                mask: Optional[torch.Tensor], kv_layout: str = "bshd"
                ) -> torch.Tensor:
        """q [B,S,Hq,Dh]; k/v [B,T,Hkv,Dh] ("bshd") or [B,Hkv,T,Dh] ("bhsd",
        the cache layout); mask [B,1,S,T] bool (True = keep).

        With bf16 scores (JAX's ``sd != float32`` branch) both products take
        bf16-rounded operands and accumulate in fp32 (a product of two bf16
        values is exact in fp32, so the CPU and the card agree up to the
        order of the sums); the row max is subtracted in fp32, the exp and
        the weights are bf16, the row sum fp32."""
        b, s, hq, dh = q.shape
        hkv = k.shape[2 if kv_layout == "bshd" else 1]
        g = hq // hkv
        sd = self.scores_dtype
        qg = q.reshape(b, s, hkv, g, dh).permute(0, 2, 3, 1, 4)
        if kv_layout == "bshd":
            kf, vf = k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3)
        else:
            kf, vf = k, v
        f32 = torch.float32
        scores = torch.einsum("bkgsd,bktd->bkgst", qg.to(sd).to(f32),
                              kf.to(sd).to(f32))
        scores = scores / math.sqrt(dh)
        if self.logit_softcap > 0.0:
            scores = self.logit_softcap * torch.tanh(scores / self.logit_softcap)
        if mask is not None:
            fill = NEG_INF if sd == f32 else BF16_MASK
            scores = torch.where(mask[:, :, None], scores,
                                 torch.full_like(scores, fill))
        if sd == f32:
            w = torch.softmax(scores, dim=-1)
        else:
            m = torch.amax(scores, dim=-1, keepdim=True)
            e = torch.exp((scores - m).to(sd).to(f32)).to(sd)
            z = torch.sum(e.to(f32), dim=-1, keepdim=True)
            w = (e.to(f32) / z.to(sd).to(f32)).to(sd).to(f32)
        out = torch.einsum("bkgst,bktd->bkgsd", w, vf.to(sd).to(f32))
        return out.permute(0, 3, 1, 2, 4).reshape(b, s, hq, dh).to(v.dtype)

    def _attend_blocked(self, q: torch.Tensor, k: torch.Tensor,
                        v: torch.Tensor, mask: Optional[torch.Tensor]
                        ) -> torch.Tensor:
        """The flash-style forward (JAX ``_attend_blocked``): K/V padded to
        whole blocks of ``min(block_kv, T)`` keys and walked one block at a
        time with an online softmax, the (max, sum, acc) carry in fp32;
        peak memory O(S·block) instead of O(S·T).  Scores are fp32 whatever
        ``scores_dtype`` says, as in JAX.  Gradients come from autograd
        through the loop (JAX differentiates through its ``lax.scan``)."""
        b, s, hq, dh = q.shape
        t, hkv = k.shape[1], k.shape[2]
        g = hq // hkv
        blk = min(self.block_kv, t)
        nb = -(-t // blk)
        pad = nb * blk - t
        f32 = torch.float32
        kp = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        vp = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
        colmask = None if mask is None else torch.nn.functional.pad(mask, (0, pad))
        qg = (q.reshape(b, s, hkv, g, dh)
              .permute(0, 2, 3, 1, 4).to(f32))                # [b,kv,g,s,dh]
        scale = (1.0 / torch.sqrt(torch.tensor(float(dh), dtype=f32))).item()
        shape = (b, hkv, g, s, 1)
        m = torch.full(shape, NEG_INF, dtype=f32, device=q.device)
        z = torch.zeros(shape, dtype=f32, device=q.device)
        acc = torch.zeros(shape[:-1] + (dh,), dtype=f32, device=q.device)
        cols = torch.arange(blk, device=q.device)
        for i in range(nb):
            lo = i * blk
            kb = kp[:, lo:lo + blk].permute(0, 2, 1, 3).to(f32)   # [b,kv,blk,dh]
            vb = vp[:, lo:lo + blk].permute(0, 2, 1, 3).to(f32)
            sc = torch.einsum("bkgsd,bktd->bkgst", qg, kb) * scale
            if self.logit_softcap > 0.0:
                sc = self.logit_softcap * torch.tanh(sc / self.logit_softcap)
            valid = (lo + cols) < t
            keep = valid if colmask is None else \
                colmask[..., lo:lo + blk][:, :, None] & valid
            sc = torch.where(keep, sc, torch.full_like(sc, NEG_INF))
            m_new = torch.maximum(m, torch.amax(sc, dim=-1, keepdim=True))
            c = torch.exp(m - m_new)
            p = torch.exp(sc - m_new)
            z = z * c + torch.sum(p, dim=-1, keepdim=True)
            acc = acc * c + torch.einsum("bkgst,bktd->bkgsd", p, vb)
            m = m_new
        out = acc / torch.clamp_min(z, 1e-30)
        return out.permute(0, 3, 1, 2, 4).reshape(b, s, hq, dh).to(v.dtype)

    def _out(self, ctx: torch.Tensor) -> torch.Tensor:
        """ctx [B, S, Hq, Dh] -> SubLN + output projection."""
        b, s = ctx.shape[:2]
        flat = ctx.reshape(b, s, -1)
        if self.subln is not None:
            flat = self.subln(flat)
        return self.wo(flat)

    # -- full-sequence forward ------------------------------------------------

    def forward(self, x: torch.Tensor,
                positions: Optional[torch.Tensor] = None,
                memory: Optional[torch.Tensor] = None,
                memory_mask: Optional[torch.Tensor] = None,
                collect_states: bool = False):
        """Attention over x [B, S, D] (the JAX ``apply``): causal
        self-attention, unmasked with ``causal=False``, or with ``cross``
        over K/V projected from ``memory`` [B, T, D], keeping the memory
        positions where ``memory_mask`` [B, T] (bool) is True (all of them
        when it is None).

        With ``collect_states`` returns ``(y, {"q","k","v"})``, each
        [B, H, S, Dh] with the kv heads repeated to n_heads: the layout
        Algorithm 1 distills."""
        b, s, _ = x.shape
        if positions is None:
            positions = torch.arange(s, device=x.device)[None].expand(b, s)
        split = tp.active()
        if split is not None:
            x = tp.copy_to(x)
        q = self._project_q(x, positions)
        if self.cross:
            if memory is None:
                raise ValueError("cross-attention needs memory [B, T, D]")
            k, v = self._project_kv(tp.copy_to(memory), None)
            mask = None if memory_mask is None else memory_mask[:, None, None, :]
        else:
            k, v = self._project_kv(x, positions)
            mask = None
        if split is not None and q.shape[2] != self.n_heads \
                and k.shape[2] == self.n_kv_heads:
            # replicated kv projections: the rank's query heads' own
            lo, hi = split.kv_range(self.n_heads, self.n_kv_heads)
            k, v = k[:, :, lo:hi], v[:, :, lo:hi]
        if not self.cross and self.causal:
            ar = torch.arange(s, device=x.device)
            mask = (ar[None, :] <= ar[:, None])[None, None].expand(b, 1, s, s)
        attend = (self._attend_blocked if self.impl == "blocked" and s > 1
                  else self._attend)
        y = self._out(attend(q, k, v, mask))
        if not collect_states:
            return y
        g = q.shape[2] // k.shape[2]
        rep = (lambda a: torch.repeat_interleave(a, g, dim=2)) if g > 1 else (lambda a: a)
        return y, {"q": tp.gather_heads(q.permute(0, 2, 1, 3), 1),
                   "k": tp.gather_heads(rep(k).permute(0, 2, 1, 3), 1),
                   "v": tp.gather_heads(rep(v).permute(0, 2, 1, 3), 1)}

    # -- decode over the paged pools or the contiguous cache -----------------------

    def decode(self, x: torch.Tensor, cache: Cache, cache_index: torch.Tensor,
               block_tables: Optional[torch.Tensor] = None,
               attn_impl: str = "gather") -> Tuple[torch.Tensor, Cache]:
        """One token per row: x [B, 1, D]; ``cache_index`` int32 [B] holds each
        row's write position.

        ``block_tables=None``: the contiguous cache [B, Hkv, max_len, Dh];
        row ``b`` writes its K/V at ``cache_index[b]`` and attends its
        positions ``<= cache_index[b]`` with dense attention (``attn_impl``
        is not read).  Otherwise row ``b``'s position ``i`` lives in pool
        block ``block_tables[b, i // bs]`` at offset ``i % bs``:
        ``attn_impl="fused"`` runs the paged decode kernel (the plain PyTorch
        version for CPU tensors), whose scores are fp32 whatever
        ``scores_dtype`` says, as JAX's kernel's are; ``"gather"`` writes the
        new K/V, gathers the whole table into a dense window and runs masked
        dense attention: with fp32 scores through the kernel's plain version
        (on any device), with bf16 scores through :meth:`_attend`, as JAX's
        gather route does.  A cross layer projects q alone and attends its
        whole static cache [B, Hkv, T, Dh] without a mask; it writes
        nothing.  Under a split, the rank's share of the contiguous cache
        (see the module's docstring)."""
        b = x.shape[0]
        idx = cache_index.to(torch.int32).reshape(-1).expand(b).contiguous()
        positions = idx[:, None]
        split = tp.active()
        if split is not None:
            if block_tables is not None:
                raise ValueError("a decode under a split runs on the contiguous "
                                 "cache (the paged pools take no plan)")
            return self._decode_split(x, cache, idx, split)
        q = self._project_q(x, positions)
        if self.cross:
            # the static cache of the projected memory, read whole, unmasked
            if self.exact_sum:
                ctx = self._attend_merged(q, cache["k"], cache["v"], None, exact=True)
            else:
                ctx = self._attend(q, cache["k"], cache["v"], None, kv_layout="bhsd")
            return self._out(ctx), cache
        k_new, v_new = self._project_kv(x, positions)           # [B, 1, Hkv, Dh]
        if block_tables is None:
            kc, vc = cache["k"], cache["v"]
            rows, at = torch.arange(b, device=x.device), idx.long()
            kc[rows, :, at] = k_new[:, 0].to(kc.dtype)
            vc[rows, :, at] = v_new[:, 0].to(vc.dtype)
            t = kc.shape[2]
            mask = (torch.arange(t, device=x.device)[None, :] <= idx[:, None]
                    )[:, None, None, :]
            if self.exact_sum:
                ctx = self._attend_merged(q, kc, vc, mask, exact=True)
            else:
                ctx = self._attend(q, kc, vc, mask, kv_layout="bhsd")
            return self._out(ctx), cache
        attend = _pick(attn_impl, pa_ops.paged_attention_decode,
                       pa_ops.paged_attention_decode_plain)
        if attn_impl == "gather" and self.scores_dtype != torch.float32:
            bid, off = pa_ref.decode_slots(block_tables, idx, cache["k"].shape[2])
            k, v = self._paged_window(cache, block_tables, bid, off,
                                      k_new[:, 0], v_new[:, 0])
            mask = torch.arange(k.shape[2], device=x.device)[None, :] <= idx[:, None]
            ctx = self._attend(q, k, v, mask[:, None, None, :], kv_layout="bhsd")
            return self._out(ctx), cache
        ctx, _, _ = attend(q[:, 0], k_new[:, 0], v_new[:, 0], cache["k"],
                           cache["v"], block_tables, idx,
                           softcap=self.logit_softcap)
        return self._out(ctx[:, None]), cache

    def _decode_split(self, x: torch.Tensor, cache: Cache, idx: torch.Tensor,
                      split) -> Tuple[torch.Tensor, Cache]:
        """:meth:`decode` on the rank's share of the contiguous cache (see
        the module's docstring)."""
        b = x.shape[0]
        x = tp.copy_to(x)
        positions = idx[:, None]
        q = self._project_q(x, positions)                      # the rank's heads
        kc, vc = cache["k"], cache["v"]
        spec = split.cache_spec(kc)
        seq_axes = tuple(a for a in spec[2] if split.axis_size(a) > 1)
        t_loc = kc.shape[2]
        offset = split.index(seq_axes) * t_loc if seq_axes else 0
        rows = torch.arange(b, device=x.device)
        mask = None
        if not self.cross:
            k_new, v_new = self._project_kv(x, positions)
            if k_new.shape[2] != kc.shape[1]:
                raise ValueError(f"a decode under a split: {k_new.shape[2]} new kv "
                                 f"heads against a cache of {kc.shape[1]} (spec "
                                 f"{spec})")
            at = idx.long() - offset
            own = (at >= 0) & (at < t_loc)
            at = torch.where(own, at, torch.zeros_like(at))
            # the rank holding the position stores it; the others rewrite
            # what they hold at their first slot
            kc[rows, :, at] = torch.where(own[:, None, None], k_new[:, 0].to(kc.dtype),
                                          kc[rows, :, at])
            vc[rows, :, at] = torch.where(own[:, None, None], v_new[:, 0].to(vc.dtype),
                                          vc[rows, :, at])
            pos = offset + torch.arange(t_loc, device=x.device)
            mask = (pos[None, :] <= idx[:, None])[:, None, None, :]
        heads_local = q.shape[2] != self.n_heads
        kv_all = kc.shape[1] == self.n_kv_heads
        # positions split over "model" with every kv head on the rank: every
        # query head attends the rank's positions, the rank's own kept after
        # the merge; else the rank's query heads read their kv heads
        gather_q = tp.MODEL in seq_axes and heads_local and kv_all
        k, v = kc, vc
        if gather_q:
            q = tp.gather_heads(q, 2)
        elif heads_local and kv_all:
            lo, hi = split.kv_range(self.n_heads, self.n_kv_heads)
            k, v = kc[:, lo:hi], vc[:, lo:hi]
        if seq_axes:
            ctx = self._attend_merged(q, k, v, mask, seq_axes, split, tp.exact())
        elif self.exact_sum:
            ctx = self._attend_merged(q, k, v, mask, exact=True)
        else:
            ctx = self._attend(q, k, v, mask, kv_layout="bhsd")
        if gather_q:
            ctx = split.own(ctx, tp.MODEL, 2)
        return self._out(ctx), cache

    def _attend_merged(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       mask: Optional[torch.Tensor], axes=(), split=None,
                       exact: bool = False) -> torch.Tensor:
        """:meth:`_attend` of q [B, S, Hq, Dh] over the rank's positions of
        k/v [B, Hkv, T_loc, Dh], merged with the other ranks' over ``axes``
        by log-sum-exp: the rows' maximum maximized over them; with fp32
        scores the numerators and denominators at that maximum summed, then
        divided; with bf16 scores the denominators summed first, each
        weight normalized and rounded to bf16 as :meth:`_attend` rounds it,
        then the weighted sums summed.  ``exact``: the decode's exact form
        (``exact_sum``, or positions split over more than one rank): the
        scores and the weighted sums of fp32 products (exact in float64)
        summed in float64 and each rounded once, so the value does not
        depend on how the positions are cut or the order of their sums."""
        b, s, hq, dh = q.shape
        hkv = k.shape[1]
        sd, f32 = self.scores_dtype, torch.float32
        acc = torch.float64 if exact else f32
        qg = q.reshape(b, s, hkv, hq // hkv, dh).permute(0, 2, 3, 1, 4)
        scores = torch.einsum("bkgsd,bktd->bkgst", qg.to(sd).to(acc),
                              k.to(sd).to(acc)).to(f32) / math.sqrt(dh)
        if self.logit_softcap > 0.0:
            scores = self.logit_softcap * torch.tanh(scores / self.logit_softcap)
        if mask is not None:
            fill = NEG_INF if sd == f32 else BF16_MASK
            scores = torch.where(mask[:, :, None], scores,
                                 torch.full_like(scores, fill))
        m = torch.amax(scores, dim=-1, keepdim=True)
        for a in axes:
            m = split.all_max(m, a)
        if sd == f32:
            e = torch.exp(scores - m).to(acc)
            parts = torch.cat([torch.einsum("bkgst,bktd->bkgsd", e, v.to(acc)),
                               torch.sum(e, dim=-1, keepdim=True)], dim=-1)
            for a in axes:
                parts = split.all_reduce(parts, a, "sum")
            out = parts[..., :dh] / parts[..., dh:]
        else:
            e = torch.exp((scores - m).to(sd).to(f32)).to(sd)
            z = torch.sum(e.to(acc), dim=-1, keepdim=True)
            for a in axes:
                z = split.all_reduce(z, a, "sum")
            w = (e.to(f32) / z.to(f32).to(sd).to(f32)).to(sd).to(acc)
            out = torch.einsum("bkgst,bktd->bkgsd", w, v.to(sd).to(acc))
            for a in axes:
                out = split.all_reduce(out, a, "sum")
        out = out.to(f32)
        return out.permute(0, 3, 1, 2, 4).reshape(b, s, hq, dh).to(v.dtype)

    def decode_chunk(self, x: torch.Tensor, cache: Cache, start: torch.Tensor,
                     lens: torch.Tensor, block_tables: torch.Tensor,
                     attn_impl: str = "gather") -> Tuple[torch.Tensor, Cache]:
        """Chunked-prefill step: x [B, T, D]; token ``j`` of row ``b`` is
        written at ``start[b] + j`` (iff ``j < lens[b]``; pad positions are
        never written into owned blocks) and attends positions
        ``<= start[b] + j``.  Decode rows are ``lens == 1``.  ``attn_impl`` as
        in :meth:`decode` (``"fused"``: the paged prefill kernel, fp32
        scores; ``"gather"`` with bf16 scores: :meth:`_attend` over the
        gathered window, pad tokens stored into the trash block).  A cross
        layer raises, as in JAX: the paged pools have no cross layout."""
        if self.cross:
            raise ValueError("decode_chunk is self-attention only (the paged "
                             "cache has no cross-attention layout)")
        b, t, _ = x.shape
        start = start.to(torch.int32).reshape(-1).expand(b).contiguous()
        lens = lens.to(torch.int32).reshape(-1).expand(b).contiguous()
        positions = start[:, None] + torch.arange(t, dtype=torch.int32,
                                                  device=x.device)[None]
        q = self._project_q(x, positions)
        k_new, v_new = self._project_kv(x, positions)
        attend = _pick(attn_impl, pp_ops.paged_prefill_chunk,
                       pp_ops.paged_prefill_chunk_plain)
        if attn_impl == "gather" and self.scores_dtype != torch.float32:
            bid, off, pos = pp_ref.chunk_slots(block_tables, start, lens, t,
                                               cache["k"].shape[2])
            hkv, dh = self.n_kv_heads, self.head_dim
            k, v = self._paged_window(cache, block_tables, bid.reshape(-1),
                                      off.reshape(-1),
                                      k_new.reshape(b * t, hkv, dh),
                                      v_new.reshape(b * t, hkv, dh))
            mask = (torch.arange(k.shape[2], device=x.device)[None, None]
                    <= pos[:, :, None])[:, None]                  # [B,1,T,L*bs]
            ctx = self._attend(q, k, v, mask, kv_layout="bhsd")
            return self._out(ctx), cache
        ctx, _, _ = attend(q, k_new, v_new, cache["k"], cache["v"],
                           block_tables, start, lens, softcap=self.logit_softcap)
        return self._out(ctx), cache

    def _paged_window(self, cache: Cache, block_tables: torch.Tensor,
                      bid: torch.Tensor, off: torch.Tensor, k_rows: torch.Tensor,
                      v_rows: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Store ``k_rows``/``v_rows`` [n, Hkv, Dh] at pool block ``bid[n]``,
        offset ``off[n]`` (in place), then gather each row's block table into
        a dense [B, Hkv, L*bs, Dh] window (JAX's ``_paged_update`` and the
        gather ``decode_chunk``)."""
        pk, pv = cache["k"], cache["v"]
        pk[bid, :, off] = k_rows.to(pk.dtype)
        pv[bid, :, off] = v_rows.to(pv.dtype)
        return pa_ref.window(pk, block_tables), pa_ref.window(pv, block_tables)

    def init_cache(self, batch: int, max_len: int, dtype: torch.dtype,
                   device: Optional[torch.device] = None) -> Cache:
        shape = (batch, self.n_kv_heads, max_len, self.head_dim)
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)}

    @staticmethod
    def cache_axes() -> Dict[str, Axes]:
        """The cache's logical axes (JAX's ``Attention.cache_axes``)."""
        return {"k": ("batch", "kv_heads", "kv_seq", "head_dim"),
                "v": ("batch", "kv_heads", "kv_seq", "head_dim")}


def _pick(attn_impl: str, fused, gather):
    if attn_impl == "fused":
        return fused
    if attn_impl == "gather":
        return gather
    raise ValueError(f"unknown attn_impl {attn_impl!r} "
                     "(expected 'fused' or 'gather')")
