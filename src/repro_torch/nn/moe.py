"""Top-k Mixture-of-Experts FFN with capacity-based one-hot dispatch — port
of ``repro/nn/moe.py``.

Tokens are split into ``g`` groups of ``gs`` (JAX's rule: the largest
``g <= tokens // group_size`` that divides the token count).  An fp32
router picks each token's top-k experts by probability (ties to the lower
expert index, as ``lax.top_k``), renormalizes their k weights, and gives
each (token, k) a slot in its expert's buffer of ``cap`` slots, counted in
flat (token, k) order; a pick past ``cap`` is dropped.  The experts are
einsums over the one-hot dispatch, as in JAX; no TPU kernel runs here.

The combine tensor [g, gs, e, cap] is built by a scatter of ``top_w ·
in_cap`` at (token, expert, slot) instead of JAX's contraction over a
[g, gs, k, e, cap] one-hot: each (token, expert) is picked by at most one
k, so JAX's sum adds one value to zeros and the scatter gives the same
fp32 values, without the five-dimensional tensor (1.34 GB a layer at
granite's training shape).

In QAT mode each expert's weight is fake-quantized on its own (JAX's
``vmap``), one expert at a time: a batched float64 absmean over all the
experts would hold e times an expert's float64 copy.  A packed model holds
the experts already quantized (``serving/engine.py::convert_to_packed``, or
a seeded packed init), so it runs the weights the QAT forward ran.

Under a tensor-parallel split (``distributed/tensor_parallel.py``) the
router runs replicated in fp32 on the block's input, so every rank routes
alike, and the rank computes on its experts' shards, as the plan lays them
out: whole experts where their count divides over ``"model"`` (the
``"expert"`` rule's priority), else every expert's ``d_ff`` columns.  The
experts' input enters through *f* (each rank's ``dx`` is a partial sum),
and so do the combine weights (each rank's gradient of them is its
experts' part).  The rank dispatches to its experts, runs them (its
experts quantized whole, or each expert's Δ summed over the ``d_ff``
shards; SubLN over the ``d_ff`` shards), combines its partial outputs and
*g* sums them over the ranks: an all-reduce of the layer's output, which
moves 1/(top_k·capacity_factor) of the bytes of an all-gather of the
experts' outputs and leaves the rank 1/tp of the combine's FLOPs.  In the
compute dtype that sum would be a float sum in another order than one
einsum's (a few ulps), so over more than one rank
(``tensor_parallel.exact()``, or with ``exact_combine``) the combine is
taken in float64 and rounded once, the unsharded value in any order.  The auxiliary loss comes from the replicated routing,
the same on every rank.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core import quant as Q
from repro_torch.core.bitlinear import SubLN
from repro_torch.distributed import tensor_parallel as tp
from repro_torch.nn.layers import ACTIVATIONS
from repro_torch.nn.module import Axes, DEFAULT_POLICY, DTypePolicy, fan_in_init


class _Weight(nn.Module):
    """One weight ``w``, so that the parameter paths are JAX's
    (``mlp.router.w``, ``mlp.up.w``, ...)."""

    def __init__(self, shape, dtype, gen, device):
        super().__init__()
        w = (fan_in_init(gen, shape, dtype, device) if gen is not None
             else torch.zeros(shape, dtype=dtype, device=device))
        self.w = nn.Parameter(w)


def quantize_experts(w: torch.Tensor, scheme: Q.WeightScheme = "absmean",
                     block: int = 128, split=None) -> torch.Tensor:
    """Each expert's weight ``w[i]`` through ``fake_quant_weight`` on its
    own, in fp32, cast back to w's dtype (JAX's ``vmap``).  With ``split``
    ``w`` holds a ``d_ff`` shard of every expert: each Δ is the whole
    expert's, its float64 sum of |W| summed over ``"model"``."""
    deltas = [None] * w.shape[0]
    if split is not None:
        if scheme != "absmean":
            raise ValueError(f"experts split over their d_ff take the 'absmean' "
                             f"weight scheme, not {scheme!r}")
        sums = split.sum64(w.to(torch.float64).abs().flatten(1).sum(dim=1))
        deltas = Q.div(sums, float(w[0].numel() * split.size)).to(torch.float32)
    return torch.stack([
        Q.fake_quant_weight(w[i].to(torch.float32), scheme=scheme, block=block,
                            delta=deltas[i])
        for i in range(w.shape[0])]).to(w.dtype)


def group_count(tokens: int, group_size: int) -> int:
    """JAX's grouping rule (``repro/nn/moe.py:84-90``)."""
    g = max(1, tokens // group_size) if tokens >= group_size else 1
    while tokens % g:
        g -= 1
    return g


def capacity(gs: int, top_k: int, n_experts: int, capacity_factor: float,
             full_capacity: bool) -> int:
    if full_capacity:
        return gs
    return min(int(max(1, round(gs * top_k / n_experts * capacity_factor))), gs)


def route(logits: torch.Tensor, top_k: int, cap: int):
    """fp32 router logits [g, gs, e] -> (probs, top_w [g, gs, k], top_e,
    onehot int32 [g, gs, k, e], pos [g, gs, k, e], in_cap bool
    [g, gs, k, e]), the JAX function's intermediates.  The stable
    descending sort puts equal probabilities in index order, as
    ``lax.top_k`` does."""
    g, gs, e = logits.shape
    probs = torch.softmax(logits, dim=-1)
    top_w, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_w, top_e = top_w[..., :top_k], top_e[..., :top_k]
    top_w = top_w / top_w.sum(dim=-1, keepdim=True)
    onehot = F.one_hot(top_e, e).to(torch.int32)
    pos = torch.cumsum(onehot.reshape(g, gs * top_k, e), dim=1) - 1
    pos = pos.reshape(g, gs, top_k, e)
    in_cap = (pos < cap) & (onehot > 0)
    return probs, top_w, top_e, onehot, pos, in_cap


def combine_weights(top_w: torch.Tensor, top_e: torch.Tensor,
                    pos: torch.Tensor, in_cap: torch.Tensor, cap: int
                    ) -> torch.Tensor:
    """combine [g, gs, e, cap] fp32: ``top_w`` of each kept (token, k) at
    (token, its expert, its slot), zero elsewhere.  A dropped pick writes a
    zero at slot ``cap - 1`` of its own (token, expert), which no other k
    writes."""
    g, gs, k = top_e.shape
    e = pos.shape[-1]
    slot = torch.gather(pos, -1, top_e[..., None])[..., 0]          # [g, gs, k]
    kept = torch.gather(in_cap, -1, top_e[..., None])[..., 0]
    vals = top_w * kept.to(torch.float32)
    gi = torch.arange(g, device=top_e.device)[:, None, None].expand(g, gs, k)
    si = torch.arange(gs, device=top_e.device)[None, :, None].expand(g, gs, k)
    combine = torch.zeros((g, gs, e, cap), dtype=torch.float32,
                          device=top_e.device)
    return combine.index_put((gi, si, top_e, torch.clamp(slot, 0, cap - 1)),
                             vals)


class MoEMLP(nn.Module):
    def __init__(self, d_model: int, d_ff: int, n_experts: int, top_k: int,
                 activation: str = "silu", capacity_factor: float = 1.25,
                 group_size: int = 2048, subln: bool = False,
                 aux_loss_weight: float = 0.01, router_z_weight: float = 1e-3,
                 quant: Q.QuantConfig = Q.FP,
                 policy: DTypePolicy = DEFAULT_POLICY,
                 gen: Optional[torch.Generator] = None,
                 device: Optional[torch.device] = None):
        super().__init__()
        e, d, f = n_experts, d_model, d_ff
        self.n_experts, self.top_k, self.d_ff = e, top_k, d_ff
        self.act = ACTIVATIONS[activation]
        self.capacity_factor, self.group_size = capacity_factor, group_size
        self.aux_loss_weight, self.router_z_weight = aux_loss_weight, router_z_weight
        self.quant, self.policy = quant, policy
        # the combine in float64, rounded once, off a split too (an
        # unsharded reference of a split's step)
        self.exact_combine = False
        pd = policy.param_dtype
        # the router is fp32 whatever the param dtype (JAX's init)
        self.router = _Weight((d, e), torch.float32, gen, device)
        self.up = _Weight((e, d, f), pd, gen, device)
        self.gate = _Weight((e, d, f), pd, gen, device)
        self.down = _Weight((e, f, d), pd, gen, device)
        self.subln = SubLN(f, policy=policy, device=device,
                           axis_name="mlp") if subln else None
        if quant.mode == "packed" and gen is not None:
            # a seeded packed model holds its experts quantized, as a packed
            # BitLinear holds its seeded weight packed
            with torch.no_grad():
                for part in (self.up, self.gate, self.down):
                    part.w.copy_(quantize_experts(part.w, quant.scheme, quant.block))

    def param_axes(self) -> Dict[str, Axes]:
        ax: Dict[str, Axes] = {
            "router.w": ("embed", "expert_router"),
            "up.w": ("expert", "embed", "mlp"),
            "gate.w": ("expert", "embed", "mlp"),
            "down.w": ("expert", "mlp", "embed"),
        }
        if self.subln is not None:
            ax["subln.scale"] = ("mlp",)
        return ax

    def tp_whole(self, spec_of) -> Tuple[str, ...]:
        """Under a split of whole experts each uses the SubLN scale whole."""
        if self.subln is not None and "model" in spec_of("up.w")[0]:
            return ("subln.scale",)
        return ()

    def quantized(self, w: torch.Tensor, split=None) -> torch.Tensor:
        """The experts' weights as the forward uses them: quantized expert by
        expert in QAT mode (``split``: ``w`` is a ``d_ff`` shard of each),
        ``w`` itself otherwise."""
        if self.quant.mode != "qat":
            return w
        return quantize_experts(w, self.quant.scheme, self.quant.block, split)

    def forward(self, x: torch.Tensor, full_capacity: bool = False
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """x [B, S, D] -> (y, {"moe_aux_loss": fp32 scalar}).
        ``full_capacity=True`` (decode): cap = group size, so no pick is
        dropped and a token's routing and expert inputs do not depend on
        the other tokens."""
        cd = self.policy.compute_dtype
        b, s, d = x.shape
        tokens = b * s
        g = group_count(tokens, self.group_size)
        gs = tokens // g
        xg = x.reshape(g, gs, d)
        e, k = self.n_experts, self.top_k
        logits = torch.einsum("gsd,de->gse", xg.to(torch.float32),
                              self.router.w.to(torch.float32))
        cap = capacity(gs, k, e, self.capacity_factor, full_capacity)
        probs, top_w, top_e, onehot, pos, in_cap = route(logits, k, cap)
        # under a split: the rank's experts [lo, lo + e_rank), or every
        # expert's d_ff shard (d_split)
        split = tp.active()
        e_rank = self.up.w.shape[0]
        lo = split.rank * e_rank if e_rank != e else 0
        d_split = self.up.w.shape[-1] != self.d_ff
        combine = combine_weights(tp.copy_to(top_w), top_e, pos, in_cap, cap)
        if e_rank != e:
            combine = combine[:, :, lo:lo + e_rank]
        dispatch = (combine > 0).to(cd)

        xe = torch.einsum("gsec,gsd->gecd", dispatch, tp.copy_to(xg).to(cd))
        shards = split if d_split else None
        up = self.quantized(self.up.w, shards).to(cd)
        gate = self.quantized(self.gate.w, shards).to(cd)
        down = self.quantized(self.down.w, shards).to(cd)
        h = torch.einsum("gecd,edf->gecf", xe, up) * self.act(
            torch.einsum("gecd,edf->gecf", xe, gate))
        if self.subln is not None:
            h = self.subln(h)
        ye = torch.einsum("gecf,efd->gecd", h, down)
        if self.exact_combine or tp.exact():
            y = torch.einsum("gsec,gecd->gsd", combine.to(torch.float64),
                             ye.to(torch.float64))
            y = tp.reduce_from(y).to(cd)
        else:
            y = tp.reduce_from(torch.einsum("gsec,gecd->gsd", combine.to(cd), ye))

        # Switch-style load-balance loss + router z-loss
        density = onehot.to(torch.float32).mean(dim=(1, 2))        # [g, e]
        density_proxy = probs.mean(dim=1)                          # [g, e]
        lb = (density * density_proxy).sum(dim=-1).mean() * (e ** 2) / k
        z = (torch.logsumexp(logits, dim=-1) ** 2).mean()
        aux = self.aux_loss_weight * lb + self.router_z_weight * z
        return y.reshape(b, s, d).to(x.dtype), {"moe_aux_loss": aux}
