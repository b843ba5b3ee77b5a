"""ModelConfig: one dataclass describing an architecture — port of
``repro/models/base.py``.  The fields are the JAX config's, so a config
compares field for field with its JAX counterpart; ``policy()`` returns
torch dtypes.  The port runs every family: dense attention (``qwen3-*``,
``qwen1.5-0.5b``, ``qwen2.5-3b``, ``gemma-7b``, ``mistral-large-123b``),
SSM (``mamba2-780m``), MoE (``granite-moe-1b-a400m``, ``grok-1-314b``),
hybrid (``jamba-1.5-large-398b``), VLM (``llama-3.2-vision-11b``, cross
layers over image embeddings) and encoder-decoder audio
(``whisper-medium``, ``models/encdec.py``).
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
            n_experts=self.n_experts, top_k=self.top_k,
            moe_group_size=self.moe_group_size,
            capacity_factor=self.capacity_factor,
            ssm_state=self.ssm_state, ssm_head_dim=self.ssm_head_dim,
            ssm_chunk=self.ssm_chunk, subln=self.subln, quant=self.quant,
            attn_scores_dtype=self.attn_scores_dtype,
            attn_impl=self.attn_impl, block_kv=self.block_kv,
            seq_shard_activations=self.seq_shard_activations,
            policy=self.policy())

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

    # -- analytics ----------------------------------------------------------------

    def param_count(self) -> int:
        """Analytic parameter count (JAX's, used for roofline 6ND)."""
        d, f, v = self.d_model, self.d_ff, self.vocab
        qd = self.n_heads * self.head_dim
        kvd = self.n_kv_heads * self.head_dim
        attn = d * qd + 2 * d * kvd + qd * d
        if self.qkv_bias:
            attn += qd + 2 * kvd
        dense_ffn = d * f * (3 if self.mlp_gated else 2)
        moe_ffn = self.n_experts * d * f * 3 + d * self.n_experts
        d_inner = 2 * d
        nheads_ssm = d_inner // self.ssm_head_dim
        ssm = (d * (2 * d_inner + 2 * self.ssm_state + nheads_ssm)
               + d_inner * d + 4 * (d_inner + 2 * self.ssm_state)
               + 3 * nheads_ssm + d_inner)
        total = 0
        for spec in self.resolved_pattern():
            if spec.mixer in ("attn", "attn_cross"):
                total += attn
            if spec.mixer in ("cross", "attn_cross"):
                total += attn
            if spec.mixer == "mamba":
                total += ssm
            if spec.ffn == "dense":
                total += dense_ffn
            elif spec.ffn == "moe":
                total += moe_ffn
            total += 2 * d  # norms (approx)
        total *= self.repeats
        total += v * d  # embedding
        if not self.tie_embeddings:
            total += v * d
        if self.n_encoder_layers:
            total += self.n_encoder_layers * (attn + dense_ffn + 2 * d)
        return total

    def active_param_count(self) -> int:
        """MoE: params touched per token (for 6·N_active·D roofline)."""
        if not self.n_experts:
            return self.param_count()
        d, f = self.d_model, self.d_ff
        n_moe = sum(1 for s in self.resolved_pattern() if s.ffn == "moe") * self.repeats
        return self.param_count() - n_moe * (self.n_experts - self.top_k) * d * f * 3


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
