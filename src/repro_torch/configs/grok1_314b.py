"""grok-1-314b [moe] — 64L d_model=6144 48H (GQA kv=8) d_ff=32768
vocab=131072, MoE 8 experts top-2, attention logit softcap 30
[hf:xai-org/grok-1].
"""
from repro_torch.models.base import ModelConfig, register
from repro_torch.nn.transformer import LayerSpec

CONFIG = register(ModelConfig(
    name="grok-1-314b",
    family="moe",
    vocab=131072,
    d_model=6144,
    n_layers=64,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=32768,
    n_experts=8,
    top_k=2,
    logit_softcap=30.0,
    pattern=(LayerSpec("attn", "moe"),),
    tie_embeddings=False,
    param_dtype="bfloat16",
    max_seq=8192,
))
