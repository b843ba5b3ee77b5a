"""whisper-medium [audio] — enc-dec, 24+24L d_model=1024 16H (kv=16)
d_ff=4096 vocab=51865 [arXiv:2212.04356].

Conv mel frontend is a STUB: ``input_specs()`` provides precomputed frame
embeddings [B, 1500, d_model].  Plain (non-gated) GELU MLP as in Whisper;
decoder layers carry self+cross attention.  Its assigned decode_32k /
prefill_32k shapes stress the backbone far beyond Whisper's 448-token
production ceiling — shape-faithful by assignment.
"""
from repro_torch.models.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="whisper-medium",
    family="audio",
    vocab=51865,
    d_model=1024,
    n_layers=24,            # decoder layers (attn_cross pattern set by EncDecLM)
    n_encoder_layers=24,
    encoder_seq=1500,
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    activation="gelu",
    mlp_gated=False,
    tie_embeddings=True,
    max_seq=32768,
))
