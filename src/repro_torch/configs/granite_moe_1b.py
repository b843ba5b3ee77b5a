"""granite-moe-1b-a400m [moe] — 24L d_model=1024 16H (GQA kv=8) d_ff=512
vocab=49155, MoE 32 experts top-8 [hf:ibm-granite/granite-3.0-1b-a400m-base].
"""
from repro_torch.models.base import ModelConfig, register
from repro_torch.nn.transformer import LayerSpec

CONFIG = register(ModelConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    vocab=49155,
    d_model=1024,
    n_layers=24,
    n_heads=16,
    n_kv_heads=8,
    head_dim=64,
    d_ff=512,
    n_experts=32,
    top_k=8,
    pattern=(LayerSpec("attn", "moe"),),
    tie_embeddings=True,
    max_seq=4096,
))
