"""CausalLM: decoder-only language model over the layer stack — port of
``repro/models/lm.py`` (apply, decode_step, decode_chunk, init_cache and the
padded-vocab logits mask)."""
from __future__ import annotations

import math
from typing import List, Optional, Tuple

import torch
from torch import nn

from repro_torch.core import quant as Q
from repro_torch.core.bitlinear import BitLinear
from repro_torch.models.base import ModelConfig
from repro_torch.nn.layers import Embedding, RMSNorm
from repro_torch.nn.transformer import LayerCache, Stack


class CausalLM(nn.Module):
    def __init__(self, cfg: ModelConfig, gen: Optional[torch.Generator] = None,
                 device: Optional[torch.device] = None):
        super().__init__()
        self.cfg = cfg
        pol = cfg.policy()
        self.embed = Embedding(cfg.padded_vocab, cfg.d_model, pol, gen=gen,
                               device=device)
        self.stack = Stack(cfg.block_config(), cfg.resolved_pattern(),
                           cfg.repeats, gen=gen, device=device)
        self.final_norm = RMSNorm(cfg.d_model, policy=pol, device=device)
        self.head = None
        if not cfg.tie_embeddings:
            hq = cfg.quant if cfg.quant.quantize_lm_head else Q.FP
            self.head = BitLinear(cfg.d_model, cfg.padded_vocab, False, hq, pol,
                                  gen=gen, device=device)
        vocab_mask = torch.arange(cfg.padded_vocab, device=device) < cfg.vocab
        self.register_buffer("vocab_mask", vocab_mask, persistent=False)

    def _embed_tokens(self, tokens: torch.Tensor) -> torch.Tensor:
        x = self.embed(tokens)
        if self.cfg.embed_scale:
            x = x * torch.tensor(math.sqrt(self.cfg.d_model), dtype=x.dtype,
                                 device=x.device)
        return x

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        logits = self.embed.attend(x) if self.head is None else self.head(x)
        if self.cfg.padded_vocab != self.cfg.vocab:
            # padded vocab rows never win the softmax / argmax
            logits = torch.where(self.vocab_mask, logits,
                                 torch.full_like(logits, -1e30))
        return logits

    def forward(self, tokens: torch.Tensor,
                positions: Optional[torch.Tensor] = None) -> torch.Tensor:
        """tokens [B, S] -> logits [B, S, V] (the JAX ``apply``)."""
        x = self.stack(self._embed_tokens(tokens), positions)
        return self._logits(self.final_norm(x))

    def init_cache(self, batch: int, max_len: int, dtype: torch.dtype,
                   device: Optional[torch.device] = None) -> List[LayerCache]:
        """Per-layer ``{"k","v"}`` [batch, Hkv, max_len, Dh]; the serving
        engine builds its block pools with batch = num_blocks and max_len =
        block_size."""
        return self.stack.init_cache(batch, max_len, dtype, device)

    def decode_step(self, token: torch.Tensor, cache: List[LayerCache],
                    cache_index: torch.Tensor, block_tables: torch.Tensor,
                    attn_impl: str = "gather"
                    ) -> Tuple[torch.Tensor, List[LayerCache]]:
        """token [B] -> (logits [B, V], cache updated in place)."""
        x = self._embed_tokens(token[:, None])
        x, cache = self.stack.decode(x, cache, cache_index, block_tables,
                                     attn_impl)
        return self._logits(self.final_norm(x))[:, 0], cache

    def decode_chunk(self, tokens: torch.Tensor, cache: List[LayerCache],
                     start: torch.Tensor, lens: torch.Tensor,
                     block_tables: torch.Tensor, attn_impl: str = "gather"
                     ) -> Tuple[torch.Tensor, List[LayerCache]]:
        """tokens [B, T] -> (logits [B, T, V], cache updated in place); token
        ``j`` of row ``b`` is written at ``start[b] + j`` (iff
        ``j < lens[b]``) and attends positions ``<= start[b] + j``."""
        x = self._embed_tokens(tokens)
        x, cache = self.stack.decode_chunk(x, cache, start, lens, block_tables,
                                           attn_impl)
        return self._logits(self.final_norm(x)), cache
