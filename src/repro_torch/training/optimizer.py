"""AdamW with optional blockwise 8-bit moments — port of
``repro/training/optimizer.py``.

Parameters, gradients and moments are ``{name: tensor}`` dicts (a module's
``named_parameters()``).  Weight decay and 8-bit moments apply to tensors
of rank >= 2 in the JAX tree, whose block tensors are stacked over repeats
and so have one more axis than the port's per-layer tensors: ``init`` takes
each tensor's JAX rank (``ranks``; default: its own rank) and the state
keeps it.  ``update`` writes the new parameters into the
given tensors in place (under ``no_grad``) instead of returning new ones,
and keeps fp32 moments in place too; all update math is fp32, in the JAX
order.  The 8-bit path stores each moment of a matrix as int8 codes with a
per-256-element absmax scale along the last axis (``Moment8``); vectors
keep fp32 moments.  The sharding axes (``state_axes``) are not ported.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional, Tuple, Union

import torch

from repro_torch.core.quant import div

Params = Dict[str, torch.Tensor]
BLOCK = 256


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    state_dtype: str = "float32"       # "float32" | "int8_blockwise"
    # weight decay applies only to leaves with ndim >= 2 (matrices)


class Moment8(NamedTuple):
    """Blockwise int8 moment: code [..., N] int8, scale [..., ceil(N/256)] fp32."""
    code: torch.Tensor
    scale: torch.Tensor


Moment = Union[torch.Tensor, Moment8]


def _q8_encode(x: torch.Tensor) -> Moment8:
    *lead, n = x.shape
    nb = -(-n // BLOCK)
    pad = nb * BLOCK - n
    xb = torch.nn.functional.pad(x, (0, pad)) if pad else x
    xb = xb.reshape(*lead, nb, BLOCK)
    scale = torch.amax(torch.abs(xb), dim=-1) + 1e-12
    code = torch.clamp(torch.round(div(xb, scale[..., None]) * 127.0), -127, 127
                       ).to(torch.int8).reshape(*lead, nb * BLOCK)
    return Moment8(code[..., :n], scale.to(torch.float32))


def _q8_decode(m: Moment8, shape) -> torch.Tensor:
    *lead, n = shape
    nb = m.scale.shape[-1]
    pad = nb * BLOCK - n
    code = torch.nn.functional.pad(m.code, (0, pad)) if pad else m.code
    xb = div(code.reshape(*lead, nb, BLOCK).to(torch.float32), 127.0)
    return (xb * m.scale[..., None]).reshape(*lead, nb * BLOCK)[..., :n]


class AdamWState(NamedTuple):
    step: int
    m: Dict[str, Moment]
    v: Dict[str, Moment]
    ranks: Dict[str, int]        # rank of each tensor in the JAX tree


class AdamW:
    def __init__(self, cfg: AdamWConfig = AdamWConfig()):
        if cfg.state_dtype not in ("float32", "int8_blockwise"):
            raise ValueError(f"unknown state_dtype {cfg.state_dtype!r}")
        self.cfg = cfg

    def init(self, params: Params,
             ranks: Optional[Dict[str, int]] = None) -> AdamWState:
        q8 = self.cfg.state_dtype == "int8_blockwise"
        ranks = {k: p.dim() for k, p in params.items()} if ranks is None else ranks

        def zeros(k, p):
            z = torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            return _q8_encode(z) if q8 and ranks[k] >= 2 else z

        return AdamWState(0, {k: zeros(k, p) for k, p in params.items()},
                          {k: zeros(k, p) for k, p in params.items()}, dict(ranks))

    @torch.no_grad()
    def update(self, grads: Params, state: AdamWState, params: Params,
               lr: torch.Tensor) -> Tuple[Params, AdamWState, Dict[str, torch.Tensor]]:
        cfg = self.cfg
        step = state.step + 1
        if set(grads) != set(params):
            raise KeyError("grads and params name different tensors")
        gnorm = global_norm(grads)
        if cfg.grad_clip > 0:
            scale = torch.clamp(div(cfg.grad_clip, torch.clamp(gnorm, min=1e-12)),
                                max=1.0)
        else:
            scale = torch.ones((), dtype=torch.float32, device=gnorm.device)
        q8 = cfg.state_dtype == "int8_blockwise"
        dev = gnorm.device
        step_f = torch.tensor(float(step), dtype=torch.float32)
        # 0-d tensors on the parameters' device: a CPU scalar divisor would
        # make CUDA multiply by its reciprocal instead of dividing
        bc1 = (1 - torch.tensor(cfg.b1, dtype=torch.float32) ** step_f).to(dev)
        bc2 = (1 - torch.tensor(cfg.b2, dtype=torch.float32) ** step_f).to(dev)
        lr_d = torch.as_tensor(lr, dtype=torch.float32).to(dev)
        new_m, new_v = {}, {}
        for name, p in params.items():
            g = grads[name].to(torch.float32) * scale
            matrix = state.ranks[name] >= 2
            use8 = q8 and matrix
            mf = _q8_decode(state.m[name], p.shape) if use8 else state.m[name]
            vf = _q8_decode(state.v[name], p.shape) if use8 else state.v[name]
            mf = mf.mul_(cfg.b1).add_((1 - cfg.b1) * g)
            vf = vf.mul_(cfg.b2).add_((1 - cfg.b2) * (g * g))
            mhat = div(mf, bc1)
            vhat = div(vf, bc2)
            delta = mhat / (torch.sqrt(vhat) + cfg.eps)
            if cfg.weight_decay > 0 and matrix:
                delta = delta + cfg.weight_decay * p.to(torch.float32)
            p.copy_((p.to(torch.float32) - lr_d * delta).to(p.dtype))
            new_m[name] = _q8_encode(mf) if use8 else mf
            new_v[name] = _q8_encode(vf) if use8 else vf
        metrics = {"grad_norm": gnorm, "lr": lr}
        return params, AdamWState(step, new_m, new_v, state.ranks), metrics

    def state_bytes_per_param(self) -> float:
        return 2.0 + 8.0 / BLOCK if self.cfg.state_dtype == "int8_blockwise" else 8.0


def global_norm(tree: Params) -> torch.Tensor:
    leaves = list(tree.values())
    return torch.sqrt(sum(torch.sum(torch.square(l.to(torch.float32)))
                          for l in leaves))
