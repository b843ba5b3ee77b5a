"""Encoder-decoder LM (whisper-medium backbone) — port of
``repro/models/encdec.py``.

The audio conv frontend is a stub, as in JAX: the inputs are precomputed
frame embeddings [B, T_enc, d_model]; a learned [d_model, d_model]
projection plus sinusoidal positions stand in for the mel conv stack.  The
encoder is a non-causal stack of ``n_encoder_layers`` (attn, dense) blocks
and ``enc_norm``; the decoder is a ``CausalLM`` whose every layer carries
self- and cross-attention (pattern ``attn_cross``).  Module names follow the
JAX param tree: ``frontend.w``, ``encoder.layers.<l>.*``, ``enc_norm``,
``decoder.*``.

Under a tensor-parallel split (``distributed/tensor_parallel.py``) the
frontend's weight and ``enc_norm`` take their compute copies at use, the
encoder's blocks split as a decoder's do (``causal=False`` attention), and
the decoder is a split ``CausalLM``: its cross layers attend the memory,
which every rank holds whole.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from repro_torch.distributed import tensor_parallel as tp
from repro_torch.models.base import ModelConfig
from repro_torch.models.lm import CausalLM
from repro_torch.nn.layers import RMSNorm
from repro_torch.nn.module import Axes, fan_in_init
from repro_torch.nn.transformer import LayerCache, LayerSpec, Stack


def sinusoidal_positions(length: int, dim: int,
                         device: Optional[torch.device] = None) -> torch.Tensor:
    """[length, dim] fp32: sin at even columns, cos at odd ones."""
    f32 = torch.float32
    pos = torch.arange(length, dtype=f32, device=device)[:, None]
    rate = -torch.log(torch.tensor(10000.0, dtype=f32)) / dim
    div = torch.exp(torch.arange(0, dim, 2, dtype=f32, device=device) * rate.to(device))
    pe = torch.zeros((length, dim), dtype=f32, device=device)
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div)
    return pe


def decoder_config(cfg: ModelConfig) -> ModelConfig:
    """The decoder's config: every layer self- then cross-attention."""
    return cfg.replace(pattern=(LayerSpec("attn_cross", "dense"),))


class EncDecLM(nn.Module):
    def __init__(self, cfg: ModelConfig, gen: Optional[torch.Generator] = None,
                 device: Optional[torch.device] = None):
        super().__init__()
        if cfg.n_encoder_layers <= 0:
            raise ValueError(f"{cfg.name}: an encoder-decoder model needs "
                             "n_encoder_layers > 0")
        self.cfg = cfg
        pol = cfg.policy()
        d = cfg.d_model
        w = (fan_in_init(gen, (d, d), pol.param_dtype, device) if gen is not None
             else torch.zeros((d, d), dtype=pol.param_dtype, device=device))
        self.frontend = nn.ParameterDict({"w": nn.Parameter(w)})
        self.encoder = Stack(dataclasses.replace(cfg.block_config(), causal=False),
                             (LayerSpec("attn", "dense"),), cfg.n_encoder_layers,
                             remat=cfg.remat, remat_policy=cfg.remat_policy,
                             gen=gen, device=device)
        self.enc_norm = RMSNorm(d, policy=pol, device=device)
        self.decoder = CausalLM(decoder_config(cfg), gen=gen, device=device)

    def param_axes(self) -> Dict[str, Axes]:
        """{tensor name: logical axes} (JAX's ``EncDecLM.param_axes``)."""
        ax: Dict[str, Axes] = {"frontend.w": ("embed", "embed_out")}
        for name in ("encoder", "enc_norm", "decoder"):
            ax.update({f"{name}.{k}": v
                       for k, v in getattr(self, name).param_axes().items()})
        return ax

    def encode(self, frames: torch.Tensor) -> torch.Tensor:
        """frames [B, T_enc, d_model] -> memory [B, T_enc, d_model] in the
        compute dtype (the frontend product outside any kernel, as JAX's
        ``jnp.matmul``)."""
        cd = self.cfg.policy().compute_dtype
        with tp.using(self.frontend):
            x = torch.matmul(frames.to(cd), self.frontend["w"].to(cd))
        x = x + sinusoidal_positions(x.shape[1], self.cfg.d_model,
                                     x.device).to(cd)[None]
        x, _, _ = self.encoder(x)
        with tp.using(self.enc_norm):
            return self.enc_norm(x)

    def apply(self, frames: torch.Tensor, tokens: torch.Tensor,
              distill_layer: Optional[int] = None
              ) -> Tuple[torch.Tensor, Optional[torch.Tensor], torch.Tensor]:
        """-> (logits [B, S, V], the decoder's qkv states of
        ``distill_layer`` or None, moe loss)."""
        return self.decoder.apply(tokens, memory=self.encode(frames),
                                  distill_layer=distill_layer)

    def forward(self, tokens: torch.Tensor, frames: torch.Tensor) -> torch.Tensor:
        """tokens [B, S] over frames [B, T_enc, D] -> logits [B, S, V]."""
        return self.apply(frames, tokens)[0]

    def init_cache(self, batch: int, max_len: int, dtype: torch.dtype,
                   device: Optional[torch.device] = None,
                   frames: Optional[torch.Tensor] = None) -> List[LayerCache]:
        """The decoder's cache, its cross caches seeded from
        ``encode(frames)``, or one zero position each without frames (what
        the engine serves with, as JAX's)."""
        memory = None if frames is None else self.encode(frames)
        return self.decoder.init_cache(batch, max_len, dtype, device, memory=memory)

    def cache_axes(self) -> List[Dict[str, Dict[str, Tuple[str, ...]]]]:
        """The decoder's cache axes (JAX's ``EncDecLM.cache_axes``)."""
        return self.decoder.cache_axes()

    def decode_step(self, token: torch.Tensor, cache: List[LayerCache],
                    cache_index: torch.Tensor,
                    block_tables: Optional[torch.Tensor] = None,
                    attn_impl: str = "gather",
                    keep: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, List[LayerCache]]:
        """``CausalLM.decode_step`` of the decoder."""
        return self.decoder.decode_step(token, cache, cache_index, block_tables,
                                        attn_impl, keep)
