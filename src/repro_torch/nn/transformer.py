"""Transformer blocks and stacks — port of ``repro/nn/transformer.py``: a
block is a mixer (self-attention ``attn``, cross-attention ``cross``, both
in turn ``attn_cross``, or Mamba2 ``mamba``) followed by a dense gated MLP,
an MoE FFN (``nn/moe.py``) or nothing.

The JAX ``Stack`` keeps each pattern position's params stacked over repeats
and runs a ``lax.scan``; here the stack is an ``nn.ModuleList`` of
``n_layers`` blocks (layer ``l`` is repeat ``l // len(pattern)``, position
``l % len(pattern)``) run by a Python loop.  Rematerialization
(``remat=True``: the JAX ``jax.checkpoint`` of the scan body) recomputes
each block in the backward with ``torch.utils.checkpoint``
(non-reentrant); ``remat_policy="nothing"`` saves nothing inside a block,
``"dots"`` saves the outputs of its matmuls with no batch dimensions
(``aten.mm``/``aten.addmm``, the projections of the plain route; JAX's
``dots_with_no_batch_dims_saveable``) and recomputes the rest, and
``"none"`` does not rematerialize.  The decode cache is a per-layer list
of ``{"attn": {"k","v"}}`` (paged pools [N, Hkv, bs, Dh] or the contiguous
[B, Hkv, max_len, Dh]), ``{"xattn": {"k","v"}}`` (the static projected
memory [B, Hkv, T, Dh]; both for ``attn_cross``) or ``{"mamba": {"state",
"conv"}}``, which the layers update in place.  The memory reaches each
block as an input of its ``torch.utils.checkpoint``, so remat does not
recompute what produced it and its gradient flows.  ``forward`` runs an
MoE FFN capacity-limited (also when evaluating, as JAX's ``Block.apply``),
the decode paths at full capacity; the stack sums the layers' auxiliary
MoE losses in fp32.

Under a tensor-parallel split (``distributed/tensor_parallel.py``) a block
takes its parameters' compute copies at its use (``tp.using``: the FSDP
gather along the plan's other axes, the ``"model"`` shard kept) inside its
forward, so ``torch.utils.checkpoint`` repeats the gather in the
recompute, as JAX's remat does; nothing gathers the whole model.  Its
decode takes them likewise, on the rank's share of its cache
(``cache_axes()``: JAX's names, one entry per layer).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch
import torch.utils.checkpoint
from torch import nn

from repro_torch.core import quant as Q
from repro_torch.distributed import tensor_parallel as tp
from repro_torch.nn.attention import Attention
from repro_torch.nn.layers import RMSNorm
from repro_torch.nn.mlp import GatedMLP
from repro_torch.distributed.sharding import constrain
from repro_torch.nn.module import Axes, DEFAULT_POLICY, DTypePolicy, child_axes
from repro_torch.nn.moe import MoEMLP
from repro_torch.nn.ssm import Mamba2Block

LayerCache = Dict[str, Dict[str, torch.Tensor]]


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
    causal: bool = True
    logit_softcap: float = 0.0
    attn_scores_dtype: str = "float32"
    attn_impl: str = "dense"        # "dense" | "blocked" (flash-style)
    block_kv: int = 1024            # KV block length for the blocked impl
    seq_shard_activations: bool = False   # Megatron-SP residual sharding
    # MoE
    n_experts: int = 0
    top_k: int = 2
    moe_group_size: int = 2048
    capacity_factor: float = 1.25
    # SSM
    ssm_state: int = 128
    ssm_head_dim: int = 64
    ssm_chunk: int = 256
    subln: bool = False
    rms_eps: float = 1e-6
    quant: Q.QuantConfig = Q.FP
    policy: DTypePolicy = DEFAULT_POLICY


class Block(nn.Module):
    """One residual block: a pre-norm mixer, then a pre-norm FFN (gated MLP
    or MoE) unless the spec's ffn is ``none``.  ``attn_cross`` runs the
    self-attention (``norm1``) and then the cross-attention (``norm_x``);
    ``cross`` runs the cross-attention alone on ``norm1``.  The modules are
    named as JAX's ``Block.init`` names its params: ``norm1``, ``attn`` |
    ``mamba``, ``norm_x``, ``xattn``, ``norm2``, ``mlp``."""

    def __init__(self, cfg: BlockConfig, spec: LayerSpec,
                 gen: Optional[torch.Generator] = None,
                 device: Optional[torch.device] = None):
        super().__init__()
        if spec.mixer not in ("attn", "attn_cross", "cross", "mamba") or \
                spec.ffn not in ("dense", "moe", "none"):
            raise ValueError(f"layer {spec}: unknown mixer {spec.mixer!r} or "
                             f"ffn {spec.ffn!r}")
        c = cfg
        self.spec = spec
        self.norm1 = RMSNorm(c.d_model, c.rms_eps, policy=c.policy, device=device)
        self.attn = self.mamba = self.norm_x = self.xattn = None
        self.norm2 = self.mlp = None
        if spec.mixer in ("attn", "attn_cross"):
            self.attn = Attention(
                c.d_model, c.n_heads, c.n_kv_heads, c.head_dim,
                qkv_bias=c.qkv_bias, qk_norm=c.qk_norm, rope_theta=c.rope_theta,
                causal=c.causal, logit_softcap=c.logit_softcap, subln=c.subln,
                scores_dtype=c.attn_scores_dtype, impl=c.attn_impl,
                block_kv=c.block_kv, quant=c.quant, policy=c.policy,
                gen=gen, device=device)
        if spec.mixer in ("cross", "attn_cross"):
            if spec.mixer == "attn_cross":
                self.norm_x = RMSNorm(c.d_model, c.rms_eps, policy=c.policy,
                                      device=device)
            self.xattn = Attention(
                c.d_model, c.n_heads, c.n_kv_heads, c.head_dim,
                qkv_bias=c.qkv_bias, qk_norm=c.qk_norm, use_rope=False,
                causal=False, cross=True, subln=c.subln,
                scores_dtype=c.attn_scores_dtype, impl=c.attn_impl,
                block_kv=c.block_kv, quant=c.quant, policy=c.policy,
                gen=gen, device=device)
        if spec.mixer == "mamba":
            self.mamba = Mamba2Block(
                c.d_model, d_state=c.ssm_state, head_dim=c.ssm_head_dim,
                chunk=c.ssm_chunk, subln=True, quant=c.quant, policy=c.policy,
                gen=gen, device=device)
        if spec.ffn != "none":
            self.norm2 = RMSNorm(c.d_model, c.rms_eps, policy=c.policy, device=device)
        if spec.ffn == "dense":
            self.mlp = GatedMLP(c.d_model, c.d_ff, c.activation, gated=c.mlp_gated,
                                subln=c.subln, quant=c.quant, policy=c.policy,
                                gen=gen, device=device)
        elif spec.ffn == "moe":
            self.mlp = MoEMLP(c.d_model, c.d_ff, c.n_experts, c.top_k,
                              c.activation, capacity_factor=c.capacity_factor,
                              group_size=c.moe_group_size, subln=c.subln,
                              quant=c.quant, policy=c.policy, gen=gen,
                              device=device)

    def param_axes(self) -> Dict[str, Axes]:
        return child_axes(self)

    def _xnorm(self, x: torch.Tensor) -> torch.Tensor:
        """The cross-attention's input: ``norm_x`` in an ``attn_cross``
        block, ``norm1`` in a ``cross`` one."""
        return (self.norm_x if self.norm_x is not None else self.norm1)(x)

    def _ffn(self, x: torch.Tensor, full_capacity: bool = False
             ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """-> (x + FFN(norm2(x)), the MoE auxiliary loss or None)."""
        if self.mlp is None:
            return x, None
        if self.spec.ffn == "moe":
            h, aux = self.mlp(self.norm2(x), full_capacity=full_capacity)
            return x + h, aux["moe_aux_loss"]
        return x + self.mlp(self.norm2(x)), None

    def forward(self, x: torch.Tensor,
                positions: Optional[torch.Tensor] = None,
                memory: Optional[torch.Tensor] = None,
                memory_mask: Optional[torch.Tensor] = None,
                collect_states: bool = False
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor], torch.Tensor]:
        """-> (x, the self-attention's qkv states [3, B, H, S, Dh] with
        ``collect_states`` else None, fp32 MoE auxiliary loss (0 without an
        MoE FFN)).  A cross-attention mixer attends ``memory`` [B, T, D]
        under ``memory_mask`` [B, T]."""
        with tp.using(self):
            return self._forward(x, positions, memory, memory_mask, collect_states)

    def _forward(self, x, positions, memory, memory_mask, collect_states):
        states = None
        if self.mamba is not None:
            if collect_states:
                raise ValueError("a mamba block has no qkv states")
            x = x + self.mamba(self.norm1(x))
        elif self.attn is not None:
            if collect_states:
                h, aux = self.attn(self.norm1(x), positions, collect_states=True)
                states = torch.stack([aux["q"], aux["k"], aux["v"]])
            else:
                h = self.attn(self.norm1(x), positions)
            x = x + h
        elif collect_states:
            raise ValueError("a cross block has no self-attention qkv states")
        if self.xattn is not None:
            x = x + self.xattn(self._xnorm(x), memory=memory,
                               memory_mask=memory_mask)
        x, moe = self._ffn(x)
        if moe is None:
            moe = torch.zeros((), dtype=torch.float32, device=x.device)
        return x, states, moe

    def init_cache(self, batch: int, max_len: int, dtype: torch.dtype,
                   device: Optional[torch.device] = None,
                   memory: Optional[torch.Tensor] = None) -> LayerCache:
        """The layer's decode cache; a cross layer's holds ``T =
        memory.shape[1]`` positions (1 without memory), zero until
        ``CausalLM.init_cache`` seeds it."""
        if self.mamba is not None:
            return {"mamba": self.mamba.init_cache(batch, dtype, device)}
        cache: LayerCache = {}
        if self.attn is not None:
            cache["attn"] = self.attn.init_cache(batch, max_len, dtype, device)
        if self.xattn is not None:
            t = 1 if memory is None else memory.shape[1]
            cache["xattn"] = self.xattn.init_cache(batch, t, dtype, device)
        return cache

    def cache_axes(self) -> Dict[str, Dict[str, Tuple[str, ...]]]:
        """The layer's cache axes (JAX's ``Block.cache_axes``)."""
        ax: Dict[str, Dict[str, Tuple[str, ...]]] = {}
        if self.attn is not None:
            ax["attn"] = Attention.cache_axes()
        if self.xattn is not None:
            ax["xattn"] = Attention.cache_axes()
        if self.mamba is not None:
            ax["mamba"] = Mamba2Block.cache_axes()
        return ax

    def decode(self, x: torch.Tensor, cache: LayerCache,
               cache_index: torch.Tensor,
               block_tables: Optional[torch.Tensor] = None,
               attn_impl: str = "gather",
               keep: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One token per row, the cache updated in place, an MoE FFN at full
        capacity.  ``keep`` (bool [B]) reaches the mamba mixer only: a row
        where it is False leaves its recurrent state as it was.  Attention
        writes need no mask: the engine replays a masked row's last (token,
        position), which rewrites the same K/V; a cross layer writes
        nothing."""
        with tp.using(self):
            return self._decode(x, cache, cache_index, block_tables, attn_impl, keep)

    def _decode(self, x, cache, cache_index, block_tables, attn_impl, keep):
        if self.mamba is not None:
            x = x + self.mamba.decode(self.norm1(x), cache["mamba"], keep)
        if self.attn is not None:
            h, _ = self.attn.decode(self.norm1(x), cache["attn"], cache_index,
                                    block_tables, attn_impl=attn_impl)
            x = x + h
        if self.xattn is not None:
            h, _ = self.xattn.decode(self._xnorm(x), cache["xattn"], cache_index)
            x = x + h
        return self._ffn(x, full_capacity=True)[0]

    def decode_chunk(self, x: torch.Tensor, cache: LayerCache,
                     start: torch.Tensor, lens: torch.Tensor,
                     block_tables: torch.Tensor,
                     attn_impl: str = "gather") -> torch.Tensor:
        """Chunked-prefill step over the paged pools: self-attention blocks
        only, as in JAX (the engine serves other mixers by a scan of
        decode steps); an MoE FFN at full capacity, so the chunk's pad rows
        change no other row's output."""
        if self.spec.mixer != "attn":
            raise ValueError(
                f"decode_chunk supports pure self-attention blocks; mixer "
                f"{self.spec.mixer!r} has no chunked paged path")
        h, _ = self.attn.decode_chunk(self.norm1(x), cache["attn"], start,
                                      lens, block_tables, attn_impl=attn_impl)
        return self._ffn(x + h, full_capacity=True)[0]


# matmuls with no batch dimensions (a 3-d ``x @ w`` reaches ``aten.mm``);
# ``bmm`` (the attention scores and their weighted sum) is recomputed.  The
# kernel route's outputs are recomputed, as JAX recomputes a ``pallas_call``
# inside a ``custom_vjp``: its CUDA kernels are called through ctypes, so the
# dispatcher never sees them, and its plain version on the CPU runs inside
# an ``autograd.Function``'s forward, where grad mode is off.
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    CP = torch.utils.checkpoint.CheckpointPolicy
    if op in _DOTS and torch.is_grad_enabled():
        return CP.MUST_SAVE
    return CP.PREFER_RECOMPUTE


def _save_dots():
    return torch.utils.checkpoint.create_selective_checkpoint_contexts(_dots_policy)


class Stack(nn.Module):
    """``repeats`` x ``pattern`` transformer stack as a flat list of layers."""

    def __init__(self, cfg: BlockConfig, pattern: Tuple[LayerSpec, ...],
                 repeats: int, remat: bool = True, remat_policy: str = "nothing",
                 gen: Optional[torch.Generator] = None,
                 device: Optional[torch.device] = None):
        super().__init__()
        if remat_policy not in ("nothing", "dots", "none"):
            raise ValueError(f"unknown remat_policy {remat_policy!r}: "
                             "'nothing', 'dots' or 'none'")
        self.pattern = pattern
        self.seq_shard_activations = cfg.seq_shard_activations
        self.remat = remat and remat_policy != "none"
        self.remat_policy = remat_policy
        self.layers = nn.ModuleList(
            Block(cfg, pattern[i % len(pattern)], gen=gen, device=device)
            for i in range(len(pattern) * repeats))

    def param_axes(self) -> Dict[str, Axes]:
        """Each layer's axes; JAX's leading ``"layers"`` axis (never
        sharded) has no counterpart in a per-layer tensor."""
        return child_axes(self)

    def forward(self, x: torch.Tensor, positions: Optional[torch.Tensor] = None,
                memory: Optional[torch.Tensor] = None,
                memory_mask: Optional[torch.Tensor] = None,
                distill_layer: Optional[int] = None
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor], torch.Tensor]:
        """Returns (x, fp32 qkv states [3, B, H, S, Dh] of ``distill_layer``
        (its self-attention's) or None, the layers' MoE auxiliary losses
        summed in fp32).  ``memory`` [B, T, D] and ``memory_mask`` [B, T]
        reach the cross-attention layers, which raise without memory."""
        n = len(self.layers)
        if distill_layer is not None:
            if not 0 <= distill_layer < n:
                raise ValueError(f"distill_layer {distill_layer} outside the "
                                 f"stack's {n} layers")
            mixer = self.layers[distill_layer].spec.mixer
            if mixer not in ("attn", "attn_cross"):
                raise ValueError(
                    f"distill layer {distill_layer} is a {mixer!r} layer; "
                    "attention-relation distillation needs an attention layer")
        if memory is None:
            cross = [li for li, blk in enumerate(self.layers) if blk.xattn is not None]
            if cross:
                raise ValueError(
                    f"layer {cross[0]} is a {self.layers[cross[0]].spec.mixer!r} "
                    "layer: its cross-attention needs memory [B, T, D] (encoder "
                    "output or image embeddings), and none was given")
        remat = self.remat and torch.is_grad_enabled()
        states = None
        moe = torch.zeros((), dtype=torch.float32, device=x.device)
        for li, blk in enumerate(self.layers):
            want = li == distill_layer
            if remat:
                ctx = ({"context_fn": _save_dots}
                       if self.remat_policy == "dots" else {})
                x, st, ml = torch.utils.checkpoint.checkpoint(
                    blk, x, positions, memory, memory_mask, want,
                    use_reentrant=False, **ctx)
            else:
                x, st, ml = blk(x, positions, memory, memory_mask, want)
            if want:
                states = st.to(torch.float32)
            moe = moe + ml
            if self.seq_shard_activations and (li + 1) % len(self.pattern) == 0:
                # Megatron-SP: the residual between repeats sequence-sharded
                # (JAX's hint at the end of its scan body)
                x = constrain(x, ("batch", "seq_sp", "act_embed"))
        return x, states, moe

    def init_cache(self, batch: int, max_len: int, dtype: torch.dtype,
                   device: Optional[torch.device] = None,
                   memory: Optional[torch.Tensor] = None) -> List[LayerCache]:
        return [blk.init_cache(batch, max_len, dtype, device, memory)
                for blk in self.layers]

    def cache_axes(self) -> List[Dict[str, Dict[str, Tuple[str, ...]]]]:
        """One entry per layer (JAX's ``Stack.cache_axes`` stacks them over
        repeats under a leading ``"layers"`` axis, never sharded)."""
        return [blk.cache_axes() for blk in self.layers]

    def decode(self, x: torch.Tensor, cache: List[LayerCache],
               cache_index: torch.Tensor,
               block_tables: Optional[torch.Tensor] = None,
               attn_impl: str = "gather", keep: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, List[LayerCache]]:
        for blk, c in zip(self.layers, cache):
            x = blk.decode(x, c, cache_index, block_tables, attn_impl, keep)
        return x, cache

    def decode_chunk(self, x: torch.Tensor, cache: List[LayerCache],
                     start: torch.Tensor, lens: torch.Tensor,
                     block_tables: torch.Tensor, attn_impl: str = "gather"
                     ) -> Tuple[torch.Tensor, List[LayerCache]]:
        for blk, c in zip(self.layers, cache):
            x = blk.decode_chunk(x, c, start, lens, block_tables, attn_impl)
        return x, cache
