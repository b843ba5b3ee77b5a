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
keep fp32 moments.

``state_axes`` gives the moments' logical axes (JAX's: a moment has its
parameter's, a ``Moment8``'s ``code`` too and its ``scale`` the same but the
last, which is unsharded).  Under a sharding plan (``init(..., plan=)``)
the parameters and moments are DTensors and each rank updates its share:
the gradient norm is reduced over the mesh, the elementwise update runs on
the local tensors, and an 8-bit moment whose last axis is split over ranks
takes each 256-element block's absmax over the block's whole extent (a max
over the ranks holding it), so its codes and scales are the unsharded
ones.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, NamedTuple, Optional, Tuple, Union

import torch

from repro_torch.core.quant import div
from repro_torch.distributed.sharding import is_dtensor

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


def _q8_encode_split(x: torch.Tensor, n: int, offset: int,
                     groups: List) -> Tuple[torch.Tensor, torch.Tensor]:
    """``_q8_encode`` of the columns [offset, offset + x.shape[-1]) of a
    moment whose last axis has ``n``: the codes of those columns and every
    block's scale, each block's absmax taken over the ranks of ``groups``
    (which hold the other columns) by a max all-reduce."""
    import torch.distributed as dist
    *lead, nl = x.shape
    idx = (offset + torch.arange(nl, device=x.device)) // BLOCK
    amax = torch.zeros((*lead, -(-n // BLOCK)), dtype=torch.float32, device=x.device)
    amax = amax.scatter_reduce(-1, idx.expand(x.shape), torch.abs(x), "amax")
    for g in groups:
        dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=g)
    scale = amax + 1e-12
    code = torch.clamp(torch.round(div(x, scale[..., idx]) * 127.0), -127, 127)
    return code.to(torch.int8), scale


def _q8_decode_split(code: torch.Tensor, scale: torch.Tensor,
                     offset: int) -> torch.Tensor:
    idx = (offset + torch.arange(code.shape[-1], device=code.device)) // BLOCK
    return div(code.to(torch.float32), 127.0) * scale[..., idx]


class _Split(NamedTuple):
    """Where a DTensor moment's local columns lie: their offset in the last
    axis of ``n``, the process groups that split it, and the placements of
    a tensor sharded like it but whole along the last axis (its block
    scales)."""
    offset: int
    n: int
    groups: list
    whole_last: list


def _split_of(t) -> _Split:
    from torch.distributed.tensor import Replicate
    mesh, last = t.device_mesh, t.dim() - 1
    coord = mesh.get_coordinate()
    offset, size, groups, whole = 0, t.shape[-1], [], []
    for i, p in enumerate(t.placements):
        if p.is_shard(last):
            size //= mesh.size(i)
            offset += coord[i] * size
            groups.append(mesh.get_group(i))
            whole.append(Replicate())
        else:
            whole.append(p)
    return _Split(offset, t.shape[-1], groups, whole)


def _q8_decode_placed(m: Moment8, sp: _Split) -> torch.Tensor:
    """A DTensor ``Moment8``'s local columns as fp32."""
    scale = m.scale.redistribute(m.scale.device_mesh, sp.whole_last).to_local()
    if not sp.groups:
        return _q8_decode(Moment8(m.code.to_local(), scale), m.code.to_local().shape)
    return _q8_decode_split(m.code.to_local(), scale, sp.offset)


def _q8_encode_placed(x: torch.Tensor, like: Moment8, sp: _Split) -> Moment8:
    """Local fp32 columns -> a DTensor ``Moment8`` placed as ``like``."""
    from torch.distributed.tensor import DTensor
    if sp.groups:
        code, scale = _q8_encode_split(x, sp.n, sp.offset, sp.groups)
    else:
        code, scale = _q8_encode(x)
    mesh = like.code.device_mesh
    scale = DTensor.from_local(scale, mesh, sp.whole_last, run_check=False)
    if list(scale.placements) != list(like.scale.placements):
        scale = scale.redistribute(mesh, like.scale.placements)
    return Moment8(DTensor.from_local(code, mesh, like.code.placements,
                                      run_check=False), scale)


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

    def init(self, params: Params, ranks: Optional[Dict[str, int]] = None,
             plan=None, axes: Optional[Dict[str, tuple]] = None) -> AdamWState:
        """Zero moments; with a sharding ``plan`` (and the parameters'
        logical ``axes``) each is placed on the plan's mesh by its
        ``state_axes``."""
        q8 = self.cfg.state_dtype == "int8_blockwise"
        ranks = {k: p.dim() for k, p in params.items()} if ranks is None else ranks
        if plan is not None:
            placed = self.state_axes(axes, ranks).m

        def zeros(k, p):
            z = torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            m = _q8_encode(z) if q8 and ranks[k] >= 2 else z
            if plan is None:
                return m
            if isinstance(m, Moment8):
                return Moment8(plan.place(m.code, placed[k].code),
                               plan.place(m.scale, placed[k].scale))
            return plan.place(m, placed[k])

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
            matrix = state.ranks[name] >= 2
            use8 = q8 and matrix
            m, v = state.m[name], state.v[name]
            placed = is_dtensor(p)
            if placed:          # this rank's share, updated in place
                sp = _split_of(p) if use8 else None
                g, p = grads[name].to_local(), p.to_local()
                mf = _q8_decode_placed(m, sp) if use8 else m.to_local()
                vf = _q8_decode_placed(v, sp) if use8 else v.to_local()
            else:
                g = grads[name]
                mf = _q8_decode(m, p.shape) if use8 else m
                vf = _q8_decode(v, p.shape) if use8 else v
            g = g.to(torch.float32) * scale
            mf = mf.mul_(cfg.b1).add_((1 - cfg.b1) * g)
            vf = vf.mul_(cfg.b2).add_((1 - cfg.b2) * (g * g))
            mhat = div(mf, bc1)
            vhat = div(vf, bc2)
            delta = mhat / (torch.sqrt(vhat) + cfg.eps)
            if cfg.weight_decay > 0 and matrix:
                delta = delta + cfg.weight_decay * p.to(torch.float32)
            p.copy_((p.to(torch.float32) - lr_d * delta).to(p.dtype))
            if not use8:
                new_m[name], new_v[name] = m, v
            elif placed:
                new_m[name] = _q8_encode_placed(mf, m, sp)
                new_v[name] = _q8_encode_placed(vf, v, sp)
            else:
                new_m[name], new_v[name] = _q8_encode(mf), _q8_encode(vf)
        metrics = {"grad_norm": gnorm, "lr": lr}
        return params, AdamWState(step, new_m, new_v, state.ranks), metrics

    def state_bytes_per_param(self) -> float:
        return 2.0 + 8.0 / BLOCK if self.cfg.state_dtype == "int8_blockwise" else 8.0

    def state_axes(self, param_axes: Dict[str, tuple],
                   ranks: Optional[Dict[str, int]] = None) -> AdamWState:
        """Logical axes of ``init``'s state (for the sharding plan):
        ``ranks`` are the tensors' JAX ranks, which pick the 8-bit moments
        (default: each axes tuple's length)."""
        q8 = self.cfg.state_dtype == "int8_blockwise"
        ranks = {k: len(a) for k, a in param_axes.items()} if ranks is None else ranks

        def leaf(k, a):
            if q8 and ranks[k] >= 2:
                return Moment8(code=a, scale=a[:-1] + (None,))
            return a

        m = {k: leaf(k, a) for k, a in param_axes.items()}
        return AdamWState(step=(), m=m, v=dict(m), ranks=dict(ranks))


def _sum_squares(t: torch.Tensor) -> torch.Tensor:
    s = torch.sum(torch.square(t.to(torch.float32)))
    return s.full_tensor() if is_dtensor(s) else s


def global_norm(tree: Params) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf (a DTensor leaf's reduced
    over its mesh, so every rank gets the whole tree's norm)."""
    return torch.sqrt(sum(_sum_squares(l) for l in tree.values()))
