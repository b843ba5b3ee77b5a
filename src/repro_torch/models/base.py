"""ModelConfig: one dataclass describing an architecture — port of
``repro/models/base.py``.  The fields are the JAX config's, so a config
compares field for field with its JAX counterpart; ``policy()`` returns
torch dtypes.  This slice ports the dense attention families (the
``attn`` + ``dense`` pattern) and registers ``qwen3-0.6b`` and
``qwen1.5-0.5b``; the other families come with later slices.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

from repro_torch.core import quant as Q
from repro_torch.nn.module import DTypePolicy, torch_dtype
from repro_torch.nn.transformer import BlockConfig, LayerSpec


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | ssm | hybrid | vlm | audio
    vocab: int
    d_model: int
    n_layers: int
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
    embed_scale: bool = False       # gemma: x *= sqrt(d_model)
    tie_embeddings: bool = True
    # layer pattern; empty -> [attn+dense] * n_layers
    pattern: Tuple[LayerSpec, ...] = ()
    # MoE
    n_experts: int = 0
    top_k: int = 2
    capacity_factor: float = 1.25
    moe_group_size: int = 2048
    # SSM
    ssm_state: int = 128
    ssm_head_dim: int = 64
    ssm_chunk: int = 256
    # enc-dec (audio)
    n_encoder_layers: int = 0
    encoder_seq: int = 1500
    # vlm
    num_image_tokens: int = 0
    # stage-1 refinement + quantization
    subln: bool = False
    quant: Q.QuantConfig = Q.FP
    # perf knobs
    attn_scores_dtype: str = "float32"
    attn_impl: str = "dense"
    block_kv: int = 1024
    seq_shard_activations: bool = False
    # numerics / memory
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    remat: bool = True
    remat_policy: str = "nothing"
    max_seq: int = 4096
    vocab_pad_multiple: int = 1

    # -- derived -------------------------------------------------------------

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_multiple
        return -(-self.vocab // m) * m

    def resolved_pattern(self) -> Tuple[LayerSpec, ...]:
        if self.pattern:
            return self.pattern
        return (LayerSpec("attn", "moe" if self.n_experts else "dense"),)

    @property
    def repeats(self) -> int:
        p = self.resolved_pattern()
        if self.n_layers % len(p):
            raise ValueError(f"{self.name}: n_layers={self.n_layers} is not a "
                             f"multiple of the pattern length {len(p)}")
        return self.n_layers // len(p)

    def policy(self) -> DTypePolicy:
        return DTypePolicy(param_dtype=torch_dtype(self.param_dtype),
                           compute_dtype=torch_dtype(self.compute_dtype))

    def block_config(self) -> BlockConfig:
        return BlockConfig(
            d_model=self.d_model, n_heads=self.n_heads,
            n_kv_heads=self.n_kv_heads, head_dim=self.head_dim, d_ff=self.d_ff,
            activation=self.activation, mlp_gated=self.mlp_gated,
            qkv_bias=self.qkv_bias, qk_norm=self.qk_norm,
            rope_theta=self.rope_theta, logit_softcap=self.logit_softcap,
            subln=self.subln, quant=self.quant,
            attn_scores_dtype=self.attn_scores_dtype, policy=self.policy())

    # -- config surgery ---------------------------------------------------------

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def with_quant(self, quant: Q.QuantConfig) -> "ModelConfig":
        """Teacher -> student conversion at the config level (stage 1 adds
        SubLN whenever the model is quantized, per Eqs. 4-5)."""
        return self.replace(quant=quant, subln=quant.is_quantized or self.subln)

    def reduced(self, layers: Optional[int] = None) -> "ModelConfig":
        """Tiny same-family config for CPU tests (the JAX ``reduced()``)."""
        p = self.resolved_pattern()
        reps = max(1, min(2, self.repeats))
        kw = dict(
            n_layers=len(p) * reps,
            d_model=128,
            n_heads=4, n_kv_heads=max(1, min(self.n_kv_heads,
                                             4 * self.n_kv_heads // max(self.n_heads, 1)) or 1),
            head_dim=32,
            d_ff=(256 if self.d_ff else 0),
            vocab=288,
            n_experts=min(self.n_experts, 4),
            top_k=min(self.top_k, 2),
            moe_group_size=64,
            ssm_state=16, ssm_head_dim=16, ssm_chunk=16,
            n_encoder_layers=(len(p) and self.n_encoder_layers and 2) or 0,
            encoder_seq=16 if self.n_encoder_layers else self.encoder_seq,
            num_image_tokens=8 if self.num_image_tokens else 0,
            max_seq=64,
            param_dtype="float32", compute_dtype="float32",
            remat=False,
        )
        if layers is not None:
            kw["n_layers"] = layers
        return self.replace(**kw)


_REGISTRY: Dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    if name not in _REGISTRY:
        import repro_torch.configs  # noqa: F401  (populates registry)
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]
