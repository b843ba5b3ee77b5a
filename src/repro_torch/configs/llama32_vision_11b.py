"""llama-3.2-vision-11b [vlm] — cross-attn image layers every 5th layer.

40L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=128256
[hf:meta-llama/Llama-3.2-11B-Vision].  The vision tower is a STUB:
``input_specs()`` supplies precomputed patch embeddings [B, 1601, d_model]
consumed by the cross-attention layers.
"""
from repro_torch.models.base import ModelConfig, register
from repro_torch.nn.transformer import LayerSpec

CONFIG = register(ModelConfig(
    name="llama-3.2-vision-11b",
    family="vlm",
    vocab=128256,
    d_model=4096,
    n_layers=40,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    rope_theta=500000.0,
    pattern=(
        LayerSpec("attn", "dense"),
        LayerSpec("attn", "dense"),
        LayerSpec("attn", "dense"),
        LayerSpec("attn", "dense"),
        LayerSpec("cross", "dense"),
    ),
    num_image_tokens=1601,
    tie_embeddings=False,
    param_dtype="bfloat16",
    max_seq=131072,
))
