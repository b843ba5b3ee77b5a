"""qwen2.5-3b [dense] — 36L d_model=2048 16H (GQA kv=2) d_ff=11008
vocab=151936, QKV bias [hf:Qwen/Qwen2.5-3B].

This is the closest assigned arch to the paper's own backbones (Table 3 runs
BitDistill on Qwen2.5) — it anchors the paper-representative hillclimb cell.
"""
from repro_torch.models.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen2.5-3b",
    family="dense",
    vocab=151936,
    d_model=2048,
    n_layers=36,
    n_heads=16,
    n_kv_heads=2,
    head_dim=128,
    d_ff=11008,
    qkv_bias=True,
    rope_theta=1000000.0,
    tie_embeddings=True,
    max_seq=32768,
))
