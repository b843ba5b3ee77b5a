"""Architecture registry: importing this package registers every config,
JAX's ten assigned architectures and the paper's Qwen3 backbones, every
one of which ``build_model`` builds."""
from repro_torch.configs import shapes  # noqa: F401
from repro_torch.configs.mamba2_780m import CONFIG as MAMBA2_780M
from repro_torch.configs.llama32_vision_11b import CONFIG as LLAMA32_VISION_11B
from repro_torch.configs.mistral_large_123b import CONFIG as MISTRAL_LARGE_123B
from repro_torch.configs.qwen1p5_0p5b import CONFIG as QWEN1P5_0P5B
from repro_torch.configs.gemma_7b import CONFIG as GEMMA_7B
from repro_torch.configs.qwen2p5_3b import CONFIG as QWEN2P5_3B
from repro_torch.configs.granite_moe_1b import CONFIG as GRANITE_MOE_1B
from repro_torch.configs.grok1_314b import CONFIG as GROK1_314B
from repro_torch.configs.whisper_medium import CONFIG as WHISPER_MEDIUM
from repro_torch.configs.jamba_1p5_large import CONFIG as JAMBA_1P5_LARGE
from repro_torch.configs.qwen3 import QWEN3_0P6B, QWEN3_1P7B, QWEN3_4B

ASSIGNED = (
    MAMBA2_780M, LLAMA32_VISION_11B, MISTRAL_LARGE_123B, QWEN1P5_0P5B,
    GEMMA_7B, QWEN2P5_3B, GRANITE_MOE_1B, GROK1_314B, WHISPER_MEDIUM,
    JAMBA_1P5_LARGE,
)

PAPER_BACKBONES = (QWEN3_0P6B, QWEN3_1P7B, QWEN3_4B)

__all__ = ["ASSIGNED", "PAPER_BACKBONES", "shapes"]
