"""Gated MLPs (SwiGLU / GeGLU) with SubLN before the down projection (Eq. 5)
— port of ``repro/nn/mlp.py``."""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch.core import quant as Q
from repro_torch.core.bitlinear import BitLinear, SubLN
from repro_torch.nn.layers import ACTIVATIONS
from repro_torch.nn.module import DEFAULT_POLICY, DTypePolicy


class GatedMLP(nn.Module):
    def __init__(self, d_model: int, d_ff: int, activation: str = "silu",
                 gated: bool = True, subln: bool = False,
                 quant: Q.QuantConfig = Q.FP,
                 policy: DTypePolicy = DEFAULT_POLICY,
                 gen: Optional[torch.Generator] = None,
                 device: Optional[torch.device] = None):
        super().__init__()
        self.act = ACTIVATIONS[activation]
        self.gated = gated
        lin = dict(quant=quant, policy=policy, gen=gen, device=device)
        self.up = BitLinear(d_model, d_ff, False, **lin)
        if gated:
            self.gate = BitLinear(d_model, d_ff, False, **lin)
        self.down = BitLinear(d_ff, d_model, False, **lin)
        self.subln = SubLN(d_ff, policy=policy, device=device) if subln else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.gated:
            h = self.up(x) * self.act(self.gate(x))
        else:
            h = self.act(self.up(x))
        if self.subln is not None:
            h = self.subln(h)
        return self.down(h)
