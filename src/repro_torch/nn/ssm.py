"""Mamba2 (SSD — state-space duality) block — port of ``repro/nn/ssm.py``.

The two SSD cores, ``ssd_chunked`` (blocked, what the JAX model computes)
and ``ssd_sequential`` (the oracle), are the ssd_scan kernel's plain
versions and live with it in ``kernels/ssd_scan/ref.py``; they are
re-exported here under the JAX module's names.  ``Mamba2Block.forward``
runs the SSD through ``kernels/ssd_scan/ops.ssd_scan``: the hand-written
kernel on the card, ``ssd_chunked`` on the CPU.  BitLinear applies to
``in_proj`` / ``out_proj``; the gated RMSNorm before ``out_proj`` is the
paper's SubLN placement.  ``init_cache`` / ``decode`` keep the O(1)
recurrent state [B, H, P, N] (fp32) and the (k-1)-deep conv tail that serving
runs on; ``decode`` advances them in place, where the JAX module returns new
ones.

Under a tensor-parallel split (``distributed/tensor_parallel.py``) the
rank computes its ``H/tp`` heads.  The plan stores ``in_proj``'s flat
output (z | x | B | C | dt) and the conv's channels (x | B | C) split at
flat offsets that cut through those groups, so the block uses both whole
(``tp_whole``: gathered over ``"model"``, their gradients reduce-scattered
back, B's and C's parts summed over the ranks) and takes its own columns:
its heads' z, x and dt and B, C whole (one group).  The input enters
through *f*, ``A_log``, ``D`` and ``dt_bias`` are the rank's heads' (the
plan's ``"ssm_heads"`` shards), the SSD runs on them (``b·H/tp`` rows of
the kernel), the gated SubLN sums its squares over the shards and
``out_proj`` is row-parallel (``core/bitlinear.py``).  ``decode`` under a
split advances the rank's heads of the state and its own channels of the
conv tail (the cache placed by the plan from ``cache_axes()``): the tail's
channels gathered whole for the conv over the rank's heads' x and B, C,
and the new token's values at the rank's channels computed beside them.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.core import quant as Q
from repro_torch.core.bitlinear import BitLinear, SubLN
from repro_torch.distributed import tensor_parallel as tp
from repro_torch.kernels.ssd_scan.ops import ssd_scan
from repro_torch.kernels.ssd_scan.ref import chunk_len, ssd_chunked, ssd_sequential
from repro_torch.nn.layers import silu
from repro_torch.distributed.sharding import constrain
from repro_torch.nn.module import Axes, DEFAULT_POLICY, DTypePolicy, child_axes

__all__ = ["Mamba2Block", "chunk_len", "ssd_chunked", "ssd_sequential"]


class Mamba2Block(nn.Module):
    def __init__(self, d_model: int, d_state: int = 128, head_dim: int = 64,
                 expand: int = 2, conv_kernel: int = 4, chunk: int = 256,
                 subln: bool = True, quant: Q.QuantConfig = Q.FP,
                 policy: DTypePolicy = DEFAULT_POLICY,
                 gen: Optional[torch.Generator] = None,
                 device: Optional[torch.device] = None):
        super().__init__()
        self.d_model, self.d_state, self.head_dim = d_model, d_state, head_dim
        self.conv_kernel, self.chunk = conv_kernel, chunk
        self.d_inner = expand * d_model
        if self.d_inner % head_dim:
            raise ValueError(f"d_inner={self.d_inner} is not a multiple of "
                             f"head_dim={head_dim}")
        self.n_heads = self.d_inner // head_dim
        self.conv_dim = self.d_inner + 2 * d_state
        in_dim = 2 * self.d_inner + 2 * d_state + self.n_heads   # z, x, B, C, dt
        lin = dict(quant=quant, policy=policy, gen=gen, device=device)
        self.in_proj = BitLinear(d_model, in_dim, False, axes=("embed", "ssm_in"),
                                 **lin)
        self.out_proj = BitLinear(self.d_inner, d_model, False,
                                  axes=("ssm_inner", "embed"), **lin)
        h, pd, f32 = self.n_heads, policy.param_dtype, torch.float32
        if gen is not None:
            conv_w = torch.randn((conv_kernel, self.conv_dim), generator=gen,
                                 dtype=f32, device=device) * 0.1
            # A = -exp(A_log) in [-8, -1]; dt = softplus(dt_bias) in [1e-3, 0.1]
            u_a = torch.rand((h,), generator=gen, dtype=f32, device=device)
            u_dt = torch.rand((h,), generator=gen, dtype=f32, device=device)
            a_log = torch.log(1.0 + 7.0 * u_a)
            dt0 = torch.exp(u_dt * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3))
            dt_bias = torch.log(torch.expm1(dt0))
        else:
            conv_w = torch.zeros((conv_kernel, self.conv_dim), dtype=f32,
                                 device=device)
            a_log = torch.zeros((h,), dtype=f32, device=device)
            dt_bias = torch.zeros((h,), dtype=f32, device=device)
        self.conv_w = nn.Parameter(conv_w.to(pd))
        self.conv_b = nn.Parameter(torch.zeros((self.conv_dim,), dtype=pd,
                                               device=device))
        # A_log, D and dt_bias stay fp32 whatever the policy, as in JAX
        self.A_log = nn.Parameter(a_log)
        self.D = nn.Parameter(torch.ones((h,), dtype=f32, device=device))
        self.dt_bias = nn.Parameter(dt_bias)
        self.norm = SubLN(self.d_inner, policy=policy, device=device,
                          axis_name="ssm_inner") if subln else None

    def param_axes(self) -> Dict[str, Axes]:
        return dict(child_axes(self), conv_w=("conv_k", "ssm_conv"),
                    conv_b=("ssm_conv",), A_log=("ssm_heads",), D=("ssm_heads",),
                    dt_bias=("ssm_heads",))

    def tp_whole(self, spec_of) -> Tuple[str, ...]:
        """The flat tensors a split uses whole (see the module's docstring)."""
        return ("in_proj.w", "in_proj.w_packed", "conv_w", "conv_b")

    # -- pieces ----------------------------------------------------------------

    def _own(self, split) -> Tuple[list, list]:
        """The rank's ``in_proj`` output columns and conv channels, as
        ``[lo, hi)`` ranges: its heads' z, x (and dt), B and C whole."""
        di, n, h = self.d_inner, self.d_state, self.n_heads
        zi, hi = di // split.size, h // split.size
        z0, h0 = split.rank * zi, split.rank * hi
        bc = (2 * di, 2 * di + 2 * n)
        cols = [(z0, z0 + zi), (di + z0, di + z0 + zi), bc,
                (bc[1] + h0, bc[1] + h0 + hi)]
        return cols, [(z0, z0 + zi), (di, di + 2 * n)]

    def _split(self, zxbcdt: torch.Tensor, di: int):
        conv_dim = di + 2 * self.d_state
        return (zxbcdt[..., :di], zxbcdt[..., di:di + conv_dim],
                zxbcdt[..., di + conv_dim:])

    def _conv(self, xbc: torch.Tensor, hist: Optional[torch.Tensor] = None,
              chans=None) -> torch.Tensor:
        """Causal depthwise conv over [B, S, conv_dim] in fp32, then SiLU,
        back in the input dtype.  ``hist`` [B, k-1+S, conv_dim] (decode: the
        cached tail, then ``xbc`` in the cache's dtype) replaces the zero
        history; ``chans`` (``[lo, hi)`` ranges) picks the conv's channels
        of a split's rank."""
        k, s = self.conv_kernel, xbc.shape[1]
        w, b = self.conv_w, self.conv_b
        if chans is not None:
            w = torch.cat([w[:, lo:hi] for lo, hi in chans], dim=1)
            b = torch.cat([b[lo:hi] for lo, hi in chans])
        w = w.to(torch.float32)                                      # [k, c]
        if hist is None:
            pad = torch.nn.functional.pad(xbc.to(torch.float32), (0, 0, k - 1, 0))
        else:
            pad = hist.to(torch.float32)
        out = pad[:, 0:s, :] * w[0]
        for i in range(1, k):
            out = out + pad[:, i:i + s, :] * w[i]
        return silu(out + b.to(torch.float32)).to(xbc.dtype)

    def _gates(self, dt_raw: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """dt_raw [B, S, H] -> (a = exp(dt·A) in (0, 1), dt), both fp32."""
        v = dt_raw.to(torch.float32) + self.dt_bias
        dt = torch.logaddexp(v, torch.zeros_like(v))                 # softplus
        a = torch.exp(dt * -torch.exp(self.A_log))
        return a, dt

    # -- full-sequence forward ---------------------------------------------------

    def forward(self, u: torch.Tensor, sequential: bool = False) -> torch.Tensor:
        """u [B, S, D] -> [B, S, D]; ``sequential`` runs the oracle core.
        Under a split, the rank's heads (see the module's docstring)."""
        b, s, _ = u.shape
        di, n, h, p = self.d_inner, self.d_state, self.n_heads, self.head_dim
        split = tp.active()
        u = tp.copy_to(u)
        if split is not None and split.size > 1:
            cols, chans = self._own(split)
            di, h = di // split.size, h // split.size
            z, xbc, dt_raw = self._split(self.in_proj.forward_cols(u, cols), di)
            xbc = self._conv(xbc, chans=chans)
        else:
            z, xbc, dt_raw = self._split(self.in_proj(u), di)
            xbc = self._conv(xbc)
        # the SSD's heads along "ssm_heads" (JAX's TP hint)
        x = constrain(xbc[..., :di].reshape(b, s, h, p),
                      ("batch", "seq", "ssm_heads", "head_dim")).to(torch.float32)
        B = xbc[..., di:di + n].to(torch.float32)
        C = xbc[..., di + n:].to(torch.float32)
        a, dt = self._gates(dt_raw)
        a = constrain(a, ("batch", "seq", "ssm_heads"))
        if sequential:
            y, _ = ssd_sequential(x, a, dt, B, C)
        else:
            y = ssd_scan(x, a, dt, B, C, self.chunk)
        y = y + self.D[:, None] * x
        y = y.reshape(b, s, di).to(u.dtype)
        y = y * silu(z)
        if self.norm is not None:
            y = self.norm(y)
        return self.out_proj(y)

    # -- decode (single token, recurrent state) ----------------------------------

    def init_cache(self, batch: int, dtype: torch.dtype,
                   device: Optional[torch.device] = None) -> Dict[str, torch.Tensor]:
        """``state`` fp32 [B, H, P, N] and the conv tail ``conv`` [B, k-1,
        conv_dim] in the cache dtype, both zero."""
        return {"state": torch.zeros((batch, self.n_heads, self.head_dim,
                                      self.d_state), dtype=torch.float32,
                                     device=device),
                "conv": torch.zeros((batch, self.conv_kernel - 1, self.conv_dim),
                                    dtype=dtype, device=device)}

    @staticmethod
    def cache_axes() -> Dict[str, Axes]:
        """The cache's logical axes (JAX's ``Mamba2Block.cache_axes``)."""
        return {"state": ("batch", "ssm_heads", "head_dim", "ssm_state"),
                "conv": ("batch", "conv_k", "ssm_conv")}

    def decode(self, u: torch.Tensor, cache: Dict[str, torch.Tensor],
               keep: Optional[torch.Tensor] = None) -> torch.Tensor:
        """u [B, 1, D] -> y [B, 1, D]; advances ``cache`` in place.  With
        ``keep`` (bool [B]) a row where it is False leaves its state and
        tail as they were: the JAX engine's ``where(keep, new, old)`` over
        the cache, done at the one place the cache is written.  Under a
        split, the rank's heads (see the module's docstring)."""
        b = u.shape[0]
        di, n, h, p = self.d_inner, self.d_state, self.n_heads, self.head_dim
        conv, st = cache["conv"], cache["state"]
        split = tp.active()
        if split is not None and split.size > 1:
            u = tp.copy_to(u)
            cols, chans = self._own(split)
            di, h = di // split.size, h // split.size
            # the rank's channels of the tail: its new values computed too
            c_axes = split.cache_spec(conv)[2]
            c0 = split.index(c_axes) * conv.shape[2]
            out = self.in_proj.forward_cols(
                u, cols + [(self.d_inner + c0, self.d_inner + c0 + conv.shape[2])])
            z, xbc_new, dt_raw = self._split(out[..., :-conv.shape[2]], di)
            prev = split.all_gather(conv, tp.MODEL, 2) if tp.MODEL in c_axes else conv
            prev = torch.cat([prev[..., lo:hi] for lo, hi in chans], dim=-1)
            hist = torch.cat([prev, xbc_new.to(conv.dtype)], dim=1)
            xbc = self._conv(xbc_new, hist, chans=chans)
            tail = torch.cat([conv[:, 1:], out[..., -conv.shape[2]:].to(conv.dtype)],
                             dim=1)
        else:
            z, xbc_new, dt_raw = self._split(self.in_proj(u), di)
            hist = torch.cat([conv, xbc_new.to(conv.dtype)], dim=1)   # [B, k, c]
            xbc = self._conv(xbc_new, hist)
            tail = hist[:, 1:]
        x = xbc[:, 0, :di].reshape(b, h, p).to(torch.float32)
        B = xbc[:, 0, di:di + n].to(torch.float32)
        C = xbc[:, 0, di + n:].to(torch.float32)
        a, dt = self._gates(dt_raw[:, 0])                            # [B, H]
        new = st * a[:, :, None, None] + (dt[:, :, None] * x)[..., None] * B[:, None, None, :]
        y = torch.einsum("bhpn,bn->bhp", new, C) + self.D[:, None] * x
        y = y.reshape(b, 1, di).to(u.dtype) * silu(z)
        if self.norm is not None:
            y = self.norm(y)
        if keep is None:
            st.copy_(new)
            conv.copy_(tail)
        else:
            st.copy_(torch.where(keep[:, None, None, None], new, st))
            conv.copy_(torch.where(keep[:, None, None], tail, conv))
        return self.out_proj(y)
