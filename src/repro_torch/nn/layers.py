"""Basic layers: RMSNorm, Embedding (+ tied head), rotary embeddings,
activations — port of ``repro/nn/layers.py``."""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.distributed import tensor_parallel as tp
from repro_torch.nn.module import (Axes, DEFAULT_POLICY, DTypePolicy,
                                   truncated_normal_init)


class RMSNorm(nn.Module):
    """fp32 math, eps 1e-6, output in the input dtype."""

    def __init__(self, dim: int, eps: float = 1e-6,
                 policy: DTypePolicy = DEFAULT_POLICY,
                 device: Optional[torch.device] = None,
                 axis_name: str = "embed"):
        super().__init__()
        self.eps, self.axis_name = eps, axis_name
        self.scale = nn.Parameter(torch.ones((dim,), dtype=policy.param_dtype,
                                             device=device))

    def param_axes(self) -> Dict[str, Axes]:
        return {"scale": (self.axis_name,)}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.to(torch.float32)
        y = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + self.eps)
        return (y * self.scale.to(torch.float32)).to(x.dtype)


class Embedding(nn.Module):
    """Token table ``[V, D]``.  Where no gradient is taken (serving, eval) a
    compute-dtype copy kept beside the parameter serves the lookup and the
    tied head, so they do not re-cast the whole table every step; it is
    rebuilt when the table has changed since (an optimizer step, a load).
    Training casts the parameter itself, so the gradient reaches it, and so
    does a lookup from a tensor put in the parameter's place (a step's
    gathered or compute copy).  A table placed by a sharding plan keeps the
    rank's slice as its copy.

    Under a tensor-parallel split the table is the rank's vocabulary rows
    ``[lo, lo + V/tp)``: a lookup reads the ids it owns, zeros elsewhere,
    summed over ``"model"`` (*g*), and the tied head's logits are the
    rank's columns of the vocabulary."""

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
        self.table = nn.Parameter(t)
        self._refresh()

    def param_axes(self) -> Dict[str, Axes]:
        return {"table": ("vocab", "embed")}

    def _refresh(self) -> None:
        """Rebuild the compute-dtype copy from ``table``."""
        cd = self.policy.compute_dtype
        t = self.table.detach()
        t = t.to_local() if hasattr(t, "to_local") else t
        self._table_cd = t if t.dtype == cd else t.to(cd)
        self._table_version = self.table._version

    def _table(self) -> torch.Tensor:
        t = self.table
        if (torch.is_grad_enabled() and t.requires_grad) or \
                not isinstance(t, nn.Parameter):
            return t.to(self.policy.compute_dtype)
        if self._table_version != t._version:
            self._refresh()
        return self._table_cd

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        table = self._table()
        split = tp.active()
        if split is None or split.size == 1:
            return F.embedding(ids, table)
        local = ids.long() - split.rank * table.shape[0]
        own = (local >= 0) & (local < table.shape[0])
        rows = F.embedding(torch.where(own, local, torch.zeros_like(local)), table)
        return tp.reduce_from(torch.where(own[..., None], rows,
                                          torch.zeros_like(rows)))

    def attend(self, x: torch.Tensor) -> torch.Tensor:
        """Tied LM head: logits in compute dtype (fp32 accumulation); the
        rank's vocabulary columns under a split (the caller's *f* on x)."""
        return torch.matmul(x.to(self.policy.compute_dtype), self._table().t())


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
