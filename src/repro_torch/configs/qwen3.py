"""Qwen3 0.6B / 1.7B / 4B — the paper's own backbones (Tables 1-2, Fig 3).

Not part of the assigned 10-arch grid; used by the BitDistill reproduction
benchmarks and examples. [arXiv:2505.09388]
"""
from repro_torch.models.base import ModelConfig, register

QWEN3_0P6B = register(ModelConfig(
    name="qwen3-0.6b", family="dense", vocab=151936,
    d_model=1024, n_layers=28, n_heads=16, n_kv_heads=8, head_dim=128,
    d_ff=3072, qk_norm=True, tie_embeddings=True, rope_theta=1000000.0,
    max_seq=32768,
))

QWEN3_1P7B = register(ModelConfig(
    name="qwen3-1.7b", family="dense", vocab=151936,
    d_model=2048, n_layers=28, n_heads=16, n_kv_heads=8, head_dim=128,
    d_ff=6144, qk_norm=True, tie_embeddings=True, rope_theta=1000000.0,
    max_seq=32768,
))

QWEN3_4B = register(ModelConfig(
    name="qwen3-4b", family="dense", vocab=151936,
    d_model=2560, n_layers=36, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=9728, qk_norm=True, tie_embeddings=True, rope_theta=1000000.0,
    max_seq=32768,
))
