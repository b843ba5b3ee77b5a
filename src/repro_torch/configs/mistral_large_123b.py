"""mistral-large-123b [dense] — 88L d_model=12288 96H (GQA kv=8) d_ff=28672
vocab=32768 [hf:mistralai/Mistral-Large-Instruct-2407].

Scale stress-test: params stored bf16 and the 8-bit blockwise optimizer is
required to fit 16 GB/chip HBM on the production mesh (DESIGN.md §8).
"""
from repro_torch.models.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="mistral-large-123b",
    family="dense",
    vocab=32768,
    d_model=12288,
    n_layers=88,
    n_heads=96,
    n_kv_heads=8,
    head_dim=128,
    d_ff=28672,
    rope_theta=1000000.0,
    tie_embeddings=False,
    param_dtype="bfloat16",
    max_seq=131072,
))
