"""Architecture registry: importing this package registers every config the
port runs so far (the paper's Qwen3 backbones, qwen1.5-0.5b and
mamba2-780m)."""
from repro_torch.configs.mamba2_780m import CONFIG as MAMBA2_780M
from repro_torch.configs.qwen1p5_0p5b import CONFIG as QWEN1P5_0P5B
from repro_torch.configs.qwen3 import QWEN3_0P6B, QWEN3_1P7B, QWEN3_4B

PAPER_BACKBONES = (QWEN3_0P6B, QWEN3_1P7B, QWEN3_4B)

__all__ = ["MAMBA2_780M", "PAPER_BACKBONES", "QWEN1P5_0P5B"]
