"""Transformer blocks and stacks — port of ``repro/nn/transformer.py`` for the
``attn`` + ``dense`` pattern.

The JAX ``Stack`` keeps each pattern position's params stacked over repeats
and runs a ``lax.scan``; here the stack is an ``nn.ModuleList`` of
``n_layers`` blocks (layer ``l`` is repeat ``l // len(pattern)``, position
``l % len(pattern)``) run by a Python loop.  The paged cache is a per-layer
list of ``{"k","v"}`` pools [N, Hkv, bs, Dh] that the attention layers
update in place.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from repro_torch.core import quant as Q
from repro_torch.nn.attention import Attention
from repro_torch.nn.layers import RMSNorm
from repro_torch.nn.mlp import GatedMLP
from repro_torch.nn.module import DEFAULT_POLICY, DTypePolicy

LayerCache = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    mixer: str = "attn"        # "attn" | "attn_cross" | "cross" | "mamba"
    ffn: str = "dense"         # "dense" | "moe" | "none"


@dataclasses.dataclass(frozen=True)
class BlockConfig:
    d_model: int
    n_heads: int = 8
    n_kv_heads: int = 8
    head_dim: int = 64
    d_ff: int = 0
    activation: str = "silu"
    mlp_gated: bool = True
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 10000.0
    logit_softcap: float = 0.0
    attn_scores_dtype: str = "float32"
    subln: bool = False
    rms_eps: float = 1e-6
    quant: Q.QuantConfig = Q.FP
    policy: DTypePolicy = DEFAULT_POLICY


class Block(nn.Module):
    """One residual block: pre-norm self-attention + pre-norm gated MLP."""

    def __init__(self, cfg: BlockConfig, spec: LayerSpec,
                 gen: Optional[torch.Generator] = None,
                 device: Optional[torch.device] = None):
        super().__init__()
        if spec != LayerSpec("attn", "dense"):
            raise NotImplementedError(
                f"layer {spec}: only the attn + dense pattern is ported")
        c = cfg
        self.norm1 = RMSNorm(c.d_model, c.rms_eps, policy=c.policy, device=device)
        self.attn = Attention(
            c.d_model, c.n_heads, c.n_kv_heads, c.head_dim,
            qkv_bias=c.qkv_bias, qk_norm=c.qk_norm, rope_theta=c.rope_theta,
            logit_softcap=c.logit_softcap, subln=c.subln,
            scores_dtype=c.attn_scores_dtype, quant=c.quant, policy=c.policy,
            gen=gen, device=device)
        self.norm2 = RMSNorm(c.d_model, c.rms_eps, policy=c.policy, device=device)
        self.mlp = GatedMLP(c.d_model, c.d_ff, c.activation, gated=c.mlp_gated,
                            subln=c.subln, quant=c.quant, policy=c.policy,
                            gen=gen, device=device)

    def forward(self, x: torch.Tensor,
                positions: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = x + self.attn(self.norm1(x), positions)
        return x + self.mlp(self.norm2(x))

    def decode(self, x: torch.Tensor, cache: LayerCache,
               cache_index: torch.Tensor, block_tables: torch.Tensor,
               attn_impl: str = "gather") -> torch.Tensor:
        h, _ = self.attn.decode(self.norm1(x), cache, cache_index,
                                block_tables, attn_impl=attn_impl)
        x = x + h
        return x + self.mlp(self.norm2(x))

    def decode_chunk(self, x: torch.Tensor, cache: LayerCache,
                     start: torch.Tensor, lens: torch.Tensor,
                     block_tables: torch.Tensor,
                     attn_impl: str = "gather") -> torch.Tensor:
        h, _ = self.attn.decode_chunk(self.norm1(x), cache, start, lens,
                                      block_tables, attn_impl=attn_impl)
        x = x + h
        return x + self.mlp(self.norm2(x))


class Stack(nn.Module):
    """``repeats`` x ``pattern`` transformer stack as a flat list of layers."""

    def __init__(self, cfg: BlockConfig, pattern: Tuple[LayerSpec, ...],
                 repeats: int, gen: Optional[torch.Generator] = None,
                 device: Optional[torch.device] = None):
        super().__init__()
        self.pattern = pattern
        self.layers = nn.ModuleList(
            Block(cfg, pattern[i % len(pattern)], gen=gen, device=device)
            for i in range(len(pattern) * repeats))

    def forward(self, x: torch.Tensor,
                positions: Optional[torch.Tensor] = None) -> torch.Tensor:
        for blk in self.layers:
            x = blk(x, positions)
        return x

    def init_cache(self, batch: int, max_len: int, dtype: torch.dtype,
                   device: Optional[torch.device] = None) -> List[LayerCache]:
        return [blk.attn.init_cache(batch, max_len, dtype, device)
                for blk in self.layers]

    def decode(self, x: torch.Tensor, cache: List[LayerCache],
               cache_index: torch.Tensor, block_tables: torch.Tensor,
               attn_impl: str = "gather") -> Tuple[torch.Tensor, List[LayerCache]]:
        for blk, c in zip(self.layers, cache):
            x = blk.decode(x, c, cache_index, block_tables, attn_impl)
        return x, cache

    def decode_chunk(self, x: torch.Tensor, cache: List[LayerCache],
                     start: torch.Tensor, lens: torch.Tensor,
                     block_tables: torch.Tensor, attn_impl: str = "gather"
                     ) -> Tuple[torch.Tensor, List[LayerCache]]:
        for blk, c in zip(self.layers, cache):
            x = blk.decode_chunk(x, c, start, lens, block_tables, attn_impl)
        return x, cache
