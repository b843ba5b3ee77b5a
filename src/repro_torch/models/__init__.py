from repro_torch.models.base import ModelConfig, get_config, register
from repro_torch.models.lm import CausalLM
from repro_torch.nn.module import resolve_device


def build_model(cfg: ModelConfig, gen=None, device=None) -> CausalLM:
    """Family-dispatching constructor (the decoder-only families; an
    encoder-decoder config raises, and so does a cross-attention layer) on
    ``device`` (default ``cuda``; ``"cpu"`` must be asked for).  With a
    ``torch.Generator`` the weights are a seeded init; without one they are
    zeros to be loaded (``repro_torch.bridge``)."""
    if cfg.n_encoder_layers > 0:
        raise NotImplementedError(
            f"{cfg.name}: encoder-decoder models are not ported yet")
    return CausalLM(cfg, gen=gen, device=resolve_device(device))


__all__ = ["ModelConfig", "CausalLM", "build_model", "get_config",
           "register"]
