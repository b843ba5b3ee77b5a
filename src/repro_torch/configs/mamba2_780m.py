"""mamba2-780m [ssm] — SSD (state-space duality), attention-free.

48L d_model=1536, d_ff=0, vocab=50280, ssm_state=128 [arXiv:2405.21060].
Attention-relation distillation is inapplicable (no Q/K/V); BitDistill runs
with CE + logits-KD only (``core/pipeline.py`` turns it off for the ``ssm``
family).
"""
from repro_torch.models.base import ModelConfig, register
from repro_torch.nn.transformer import LayerSpec

CONFIG = register(ModelConfig(
    name="mamba2-780m",
    family="ssm",
    vocab=50280,
    d_model=1536,
    n_layers=48,
    d_ff=0,
    pattern=(LayerSpec("mamba", "none"),),
    ssm_state=128,
    ssm_head_dim=64,
    ssm_chunk=256,
    tie_embeddings=True,
    max_seq=1 << 20,
))
