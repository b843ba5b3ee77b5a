from repro_torch.models.base import ModelConfig, get_config, register
from repro_torch.models.encdec import EncDecLM
from repro_torch.models.lm import CausalLM
from repro_torch.nn.module import resolve_device


def build_model(cfg: ModelConfig, gen=None, device=None):
    """Family-dispatching constructor: an ``EncDecLM`` for an
    encoder-decoder config (``n_encoder_layers > 0``), else a ``CausalLM``
    (dense, MoE, SSM, hybrid and VLM stacks), on ``device`` (default
    ``cuda``; ``"cpu"`` must be asked for).  With a ``torch.Generator`` the
    weights are a seeded init; without one they are zeros to be loaded
    (``repro_torch.bridge``)."""
    dev = resolve_device(device)
    if cfg.n_encoder_layers > 0:
        return EncDecLM(cfg, gen=gen, device=dev)
    return CausalLM(cfg, gen=gen, device=dev)


def decoder_of(model) -> CausalLM:
    """The ``CausalLM`` that decodes: the model itself, or an
    ``EncDecLM``'s decoder."""
    return model.decoder if isinstance(model, EncDecLM) else model


__all__ = ["ModelConfig", "CausalLM", "EncDecLM", "build_model", "decoder_of",
           "get_config", "register"]
