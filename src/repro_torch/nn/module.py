"""Module substrate: dtype policy, seeded initializers, device resolution.

Port of ``repro/nn/module.py``.  Parameters live in ``torch.nn.Module``s
instead of pytrees; initializers draw from an explicit ``torch.Generator`` so
a seeded init is reproducible on the card without JAX (the JAX and torch
streams differ — parity tests hand both packages the same numpy weights via
``repro_torch.bridge``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Union

import torch


@dataclasses.dataclass(frozen=True)
class DTypePolicy:
    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.bfloat16
    # reductions / softmax / norms always accumulate in fp32.


DEFAULT_POLICY = DTypePolicy()

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def torch_dtype(name: Union[str, torch.dtype]) -> torch.dtype:
    """Config dtype name ("float32", "bfloat16", ...) -> torch dtype."""
    if isinstance(name, torch.dtype):
        return name
    if name not in _DTYPES:
        raise ValueError(f"unsupported dtype {name!r}; known: {sorted(_DTYPES)}")
    return _DTYPES[name]


def resolve_device(device: Union[str, torch.device, None] = None) -> torch.device:
    """``None`` means ``cuda``.  A CUDA device without a card raises: nothing
    quietly carries on on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch path")
    return dev


def truncated_normal_init(gen: torch.Generator, shape: Sequence[int], dtype,
                          stddev: float,
                          device: Optional[torch.device] = None) -> torch.Tensor:
    """Standard normal truncated to [-2, 2], times ``stddev`` (the JAX
    ``truncated_normal(-2, 2) * stddev`` contract, on a torch stream)."""
    w = torch.empty(tuple(shape), dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (w * stddev).to(dtype)


def fan_in_init(gen: torch.Generator, shape: Sequence[int], dtype,
                device: Optional[torch.device] = None) -> torch.Tensor:
    """LeCun-normal-ish: stddev = 1/sqrt(fan_in) with fan_in = shape[0..-2]."""
    fan_in = 1
    for d in shape[:-1]:
        fan_in *= d
    return truncated_normal_init(gen, shape, dtype, fan_in ** -0.5, device)
