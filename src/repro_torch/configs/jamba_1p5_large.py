"""jamba-1.5-large-398b [hybrid] — 72L d_model=8192 64H (GQA kv=8)
d_ff=24576 vocab=65536, MoE 16e top-2, Mamba:attn 7:1 interleave
[arXiv:2403.19887].

Adaptation note (DESIGN.md §3): Jamba uses Mamba-1 layers (d_state=16); our
SSM substrate is Mamba-2 SSD, so the hybrid uses SSD blocks with state=128 —
same interleave ratio and parameter budget class, TPU-native chunked scan.
MoE on every other layer (4 of 8 pattern positions).
"""
from repro_torch.models.base import ModelConfig, register
from repro_torch.nn.transformer import LayerSpec

CONFIG = register(ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    vocab=65536,
    d_model=8192,
    n_layers=72,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=24576,
    n_experts=16,
    top_k=2,
    pattern=(
        LayerSpec("attn", "dense"),
        LayerSpec("mamba", "moe"),
        LayerSpec("mamba", "dense"),
        LayerSpec("mamba", "moe"),
        LayerSpec("mamba", "dense"),
        LayerSpec("mamba", "moe"),
        LayerSpec("mamba", "dense"),
        LayerSpec("mamba", "moe"),
    ),
    ssm_state=128,
    ssm_head_dim=128,
    tie_embeddings=False,
    param_dtype="bfloat16",
    max_seq=1 << 20,
))
