"""qwen1.5-0.5b [dense] — 24L d_model=1024 16H (kv=16) d_ff=2816
vocab=151936, QKV bias [hf:Qwen/Qwen1.5-0.5B].
"""
from repro_torch.models.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen1.5-0.5b",
    family="dense",
    vocab=151936,
    d_model=1024,
    n_layers=24,
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,
    d_ff=2816,
    qkv_bias=True,
    tie_embeddings=True,
    max_seq=32768,
))
