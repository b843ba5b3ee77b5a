"""Gated MLPs (SwiGLU / GeGLU) with SubLN before the down projection (Eq. 5)
— port of ``repro/nn/mlp.py``.  Under a tensor-parallel split the rank
computes its ``d_ff`` columns: *f* on x, gate and up column-parallel, SubLN
over the whole width, down row-parallel (``core/bitlinear.py``)."""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from repro_torch.core import quant as Q
from repro_torch.core.bitlinear import BitLinear, SubLN
from repro_torch.distributed import tensor_parallel as tp
from repro_torch.nn.layers import ACTIVATIONS
from repro_torch.nn.module import Axes, DEFAULT_POLICY, DTypePolicy, child_axes


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
        self.up = BitLinear(d_model, d_ff, False, axes=("embed", "mlp"), **lin)
        if gated:
            self.gate = BitLinear(d_model, d_ff, False, axes=("embed", "mlp"), **lin)
        self.down = BitLinear(d_ff, d_model, False, axes=("mlp", "embed"), **lin)
        self.subln = SubLN(d_ff, policy=policy, device=device,
                           axis_name="mlp") if subln else None

    def param_axes(self) -> Dict[str, Axes]:
        return child_axes(self)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = tp.copy_to(x)
        if self.gated:
            h = self.up(x) * self.act(self.gate(x))
        else:
            h = self.act(self.up(x))
        if self.subln is not None:
            h = self.subln(h)
        return self.down(h)
