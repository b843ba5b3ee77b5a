"""gemma-7b [dense] — 28L d_model=3072 16H (kv=16) d_ff=24576 vocab=256000,
GeGLU, head_dim=256 [arXiv:2403.08295].
"""
from repro_torch.models.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="gemma-7b",
    family="dense",
    vocab=256000,
    d_model=3072,
    n_layers=28,
    n_heads=16,
    n_kv_heads=16,
    head_dim=256,
    d_ff=24576,
    activation="gelu",
    embed_scale=True,
    tie_embeddings=True,
    max_seq=8192,
))
