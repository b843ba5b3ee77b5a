"""CausalLM: decoder-only language model over the layer stack — port of
``repro/models/lm.py`` (apply, decode_step, decode_chunk, init_cache with the
cross caches seeded from a memory, and the padded-vocab logits mask).
``apply`` is the JAX training contract ``(logits, qkv_states | None,
moe_loss)``; ``forward`` returns the logits alone.  A VLM stack (cross
layers among its self-attention ones) reads ``memory``, precomputed image
embeddings [B, T, d_model] (the vision tower is a stub, as in JAX).

Under a tensor-parallel split (``distributed/tensor_parallel.py``; every
family) the embedding, the final norm and the head take their compute
copies at use, and the logits of ``apply`` stay vocabulary-sharded:
``[rows, S, V/tp]`` a rank, the pad columns masked by their global index;
no rank builds the whole vocabulary's.  ``init_cache`` under a split gives
the rank's share of the cache, placed by the plan from ``cache_axes()``,
and ``decode_step`` runs on it; its logits come back whole (the ranks'
vocabulary columns gathered)."""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from repro_torch.core import quant as Q
from repro_torch.core.bitlinear import BitLinear, SubLN
from repro_torch.distributed import tensor_parallel as tp
from repro_torch.distributed.sharding import constrain
from repro_torch.models.base import ModelConfig
from repro_torch.nn.attention import Attention
from repro_torch.nn.layers import Embedding, RMSNorm
from repro_torch.nn.module import Axes, child_axes
from repro_torch.nn.moe import MoEMLP
from repro_torch.nn.transformer import LayerCache, Stack


# the families whose plain QAT steps take the exact product
# (core/bitlinear.py), each within its JAX bounds; the hybrid family keeps
# JAX's float product (the exact one moved jamba's QAT loss 1.12e-4 from
# JAX's).  Under a split over more than one rank every family takes the
# exact forms (distributed/tensor_parallel.py::exact)
EXACT_PRODUCT = ("dense", "moe", "ssm")


def set_exact(model: nn.Module) -> None:
    """Switch ``model``'s layers to the exact forms a split over more than
    one rank takes: the ternary product (``BitLinear.exact_product``),
    SubLN's float64 sum of squares (``SubLN.exact_sum``), the MoE's
    float64 combine (``MoEMLP.exact_combine``) and the decode's float64
    attention sums (``Attention.exact_sum``); an unsharded reference of a
    split's step."""
    for m in model.modules():
        if isinstance(m, BitLinear):
            m.exact_product = True
        elif isinstance(m, (SubLN, Attention)):
            m.exact_sum = True
        elif isinstance(m, MoEMLP):
            m.exact_combine = True


class CausalLM(nn.Module):
    def __init__(self, cfg: ModelConfig, gen: Optional[torch.Generator] = None,
                 device: Optional[torch.device] = None):
        super().__init__()
        self.cfg = cfg
        pol = cfg.policy()
        self.embed = Embedding(cfg.padded_vocab, cfg.d_model, pol, gen=gen,
                               device=device)
        self.stack = Stack(cfg.block_config(), cfg.resolved_pattern(),
                           cfg.repeats, remat=cfg.remat,
                           remat_policy=cfg.remat_policy, gen=gen, device=device)
        self.final_norm = RMSNorm(cfg.d_model, policy=pol, device=device)
        self.head = None
        if not cfg.tie_embeddings:
            hq = cfg.quant if cfg.quant.quantize_lm_head else Q.FP
            self.head = BitLinear(cfg.d_model, cfg.padded_vocab, False, hq, pol,
                                  gen=gen, device=device, axes=("embed", "vocab"))
        if cfg.family in EXACT_PRODUCT:
            for m in self.modules():
                if isinstance(m, BitLinear):
                    m.exact_product = True
        vocab_mask = torch.arange(cfg.padded_vocab, device=device) < cfg.vocab
        self.register_buffer("vocab_mask", vocab_mask, persistent=False)

    def param_axes(self) -> Dict[str, Axes]:
        """{tensor name: logical axes} (JAX's ``CausalLM.param_axes``)."""
        return child_axes(self)

    def _embed_tokens(self, tokens: torch.Tensor) -> torch.Tensor:
        with tp.using(self.embed):
            x = constrain(self.embed(tokens), ("batch", "seq", "act_embed"))
        if self.cfg.embed_scale:
            # gemma: sqrt(d_model) in fp32, cast to the activation dtype
            # before the product, as JAX's ``jnp.sqrt(d).astype(x.dtype)``
            scale = torch.sqrt(torch.tensor(float(self.cfg.d_model)))
            x = x * scale.to(device=x.device, dtype=x.dtype)
        return x

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        head = self.embed if self.head is None else self.head
        with tp.using(self.final_norm):
            x = self.final_norm(x)
        with tp.using(head):
            x = tp.copy_to(x)
            logits = self.embed.attend(x) if self.head is None else self.head(x)
        if self.cfg.padded_vocab != self.cfg.vocab:
            # padded vocab rows never win the softmax / argmax; a rank's
            # slice masks its columns by their global index
            mask = self.vocab_mask
            if logits.shape[-1] != mask.shape[0]:
                split = tp.active()
                n = logits.shape[-1]
                mask = mask[split.rank * n:(split.rank + 1) * n]
            logits = torch.where(mask, logits, torch.full_like(logits, -1e30))
        return logits

    def apply(self, tokens: torch.Tensor,
              positions: Optional[torch.Tensor] = None,
              memory: Optional[torch.Tensor] = None,
              memory_mask: Optional[torch.Tensor] = None,
              distill_layer: Optional[int] = None
              ) -> Tuple[torch.Tensor, Optional[torch.Tensor], torch.Tensor]:
        """tokens [B, S] -> (logits [B, S, V] in the compute dtype, fp32 qkv
        states [3, B, H, S, Dh] of ``distill_layer`` or None, moe loss).
        ``memory`` [B, T, D] (cast to the activation dtype) and
        ``memory_mask`` [B, T] reach the cross-attention layers."""
        x = self._embed_tokens(tokens)
        if memory is not None:
            memory = memory.to(x.dtype)
        x, states, moe_loss = self.stack(x, positions, memory, memory_mask,
                                         distill_layer=distill_layer)
        logits = constrain(self._logits(x), ("batch", "seq", "vocab"))
        return logits, states, moe_loss

    def forward(self, tokens: torch.Tensor,
                positions: Optional[torch.Tensor] = None) -> torch.Tensor:
        """tokens [B, S] -> logits [B, S, V]."""
        return self.apply(tokens, positions)[0]

    def init_cache(self, batch: int, max_len: int, dtype: torch.dtype,
                   device: Optional[torch.device] = None,
                   memory: Optional[torch.Tensor] = None) -> List[LayerCache]:
        """Per layer ``{"attn": {"k","v"} [batch, Hkv, max_len, Dh]}``,
        ``{"mamba": {"state","conv"}}`` or, for a cross layer,
        ``{"xattn": {"k","v"}}`` [batch, Hkv, T, Dh]: ``memory`` [batch, T,
        D] (cast to ``dtype``) projected by each cross layer's wk and wv
        (JAX ``_seed_cross``), or one zero position without memory, as the
        engine serves.  The serving engine builds its block pools with
        batch = num_blocks and max_len = block_size."""
        split = tp.active()
        if split is None:
            cache = self.stack.init_cache(batch, max_len, dtype, device, memory)
        else:
            # the rank's share: the whole cache's shapes on meta, placed
            whole = self.stack.init_cache(batch, max_len, dtype, "meta", memory)
            cache = split.place_cache(whole, self.cache_axes(), device)
        if memory is not None:
            memory = memory.to(dtype)
            with torch.no_grad():
                for blk, layer in zip(self.stack.layers, cache):
                    if blk.xattn is None:
                        continue
                    with tp.using(blk):
                        proj = blk.xattn.project_memory(memory)
                    for k, t in proj.items():
                        if split is not None:
                            c = layer["xattn"][k]
                            t = split.local_of(t, split.cache_spec(c), c._tp_whole)
                        layer["xattn"][k].copy_(t)
        return cache

    def cache_axes(self) -> List[Dict[str, Dict[str, Tuple[str, ...]]]]:
        """Per layer, its cache's logical axes (JAX's ``cache_axes``)."""
        return self.stack.cache_axes()

    def decode_step(self, token: torch.Tensor, cache: List[LayerCache],
                    cache_index: torch.Tensor,
                    block_tables: Optional[torch.Tensor] = None,
                    attn_impl: str = "gather",
                    keep: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, List[LayerCache]]:
        """token [B] -> (logits [B, V], cache updated in place).
        ``block_tables`` (int32 [B, L]) selects the paged pools, None the
        contiguous cache; ``keep`` (bool [B]) leaves the recurrent state of
        the rows where it is False as it was (``Block.decode``)."""
        x = self._embed_tokens(token[:, None])
        x, cache = self.stack.decode(x, cache, cache_index, block_tables,
                                     attn_impl, keep)
        return tp.gather_heads(self._logits(x)[:, 0], -1), cache

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
        return self._logits(x), cache
