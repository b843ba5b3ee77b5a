"""Basic layers: RMSNorm, Embedding (+ tied head), rotary embeddings,
activations — port of ``repro/nn/layers.py``."""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.nn.module import DEFAULT_POLICY, DTypePolicy, truncated_normal_init


class RMSNorm(nn.Module):
    """fp32 math, eps 1e-6, output in the input dtype."""

    def __init__(self, dim: int, eps: float = 1e-6,
                 policy: DTypePolicy = DEFAULT_POLICY,
                 device: Optional[torch.device] = None):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones((dim,), dtype=policy.param_dtype,
                                             device=device),
                                  requires_grad=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.to(torch.float32)
        y = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + self.eps)
        return (y * self.scale.to(torch.float32)).to(x.dtype)


class Embedding(nn.Module):
    """Token table ``[V, D]``.  A compute-dtype copy is kept beside the
    parameter (refreshed by :meth:`refresh`) so neither the lookup nor the
    tied head re-casts the whole table every step."""

    def __init__(self, vocab: int, dim: int,
                 policy: DTypePolicy = DEFAULT_POLICY,
                 gen: Optional[torch.Generator] = None,
                 device: Optional[torch.device] = None):
        super().__init__()
        self.policy = policy
        if gen is not None:
            t = truncated_normal_init(gen, (vocab, dim), policy.param_dtype,
                                      0.02, device)
        else:
            t = torch.zeros((vocab, dim), dtype=policy.param_dtype, device=device)
        self.table = nn.Parameter(t, requires_grad=False)
        self.refresh()

    def refresh(self) -> None:
        """Rebuild the compute-dtype copy after ``table`` changes."""
        cd = self.policy.compute_dtype
        self._table_cd = (self.table.data if self.table.dtype == cd
                          else self.table.data.to(cd))

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return F.embedding(ids, self._table_cd)

    def attend(self, x: torch.Tensor) -> torch.Tensor:
        """Tied LM head: logits in compute dtype (fp32 accumulation)."""
        return torch.matmul(x.to(self.policy.compute_dtype), self._table_cd.t())


def rope_frequencies(head_dim: int, theta: float = 10000.0,
                     device: Optional[torch.device] = None) -> torch.Tensor:
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                         device=device) / half))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """x: [B, S, H, Dh]; positions: [B, S] int. Split-half convention."""
    freqs = rope_frequencies(x.shape[-1], theta, x.device)        # [Dh/2]
    angles = positions[..., None].to(torch.float32) * freqs        # [B, S, Dh/2]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


ACTIVATIONS = {"silu": silu, "gelu": gelu}
