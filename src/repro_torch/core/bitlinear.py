"""BitLinear (fp / qat / packed) and SubLN — port of
``repro/core/bitlinear.py``.

Weights keep the JAX layout ``[in, out]`` (``y = x @ w``), so the bridge
copies them without a transpose.  ``fp`` and ``qat`` hold a trainable
``w`` (and ``b``); ``qat`` runs, in the JAX package's order, the bitlinear
CUDA kernel with ``QuantConfig.use_kernel`` (whose backward is the same
STE), else the bf16 absmean path with ``low_precision_quant``, else the
fake-quant forward of ``QuantConfig.scheme`` with STE gradients.  ``packed`` stores ``w_packed`` uint8 ``[in/4, out]`` plus
a scalar ``delta`` as buffers; with ``use_kernel`` the projection runs the
w2a8 CUDA kernel.  ``axes`` are the weight's logical axes (``[in, out]``,
supplied by the caller as in JAX); ``param_axes()`` names each tensor's.

Under a tensor-parallel split (``distributed/tensor_parallel.py``) the
layer holds the rank's shard of ``w`` and picks its part from ``axes``:
column-parallel where ``"model"`` splits the out axis (the rank's output
columns; the caller's *f* sums ``dx``), row-parallel where it splits the
in axis (x is the rank's columns; *g* sums the partial outputs, then the
bias is added).  Δ is the whole weight's on every route; a row-parallel
shard quantizes x with the whole rows' γ (maximized over the shards).

A packed layer (inference: prefill and decode under a split) holds the
rank's shard of ``w_packed`` and the whole weight's Δ: a column shard runs
the w2a8 product on its columns, each the unsharded layer's; a row shard
(K/tp input rows, a whole number of packed bytes: K/tp divisible by 4)
quantizes x with the whole rows' γ (maximized over the shards) and returns
the accumulators of its rows (``w2a8_forward_acc`` on the kernel route),
integers summed exactly over the ranks (*g*, ``Split.acc_sum``) before the
one scale (γ/127)·Δ: the unsharded output bit for bit.

``forward_cols`` computes a set of the layer's output columns from the
whole weight at use, Δ the whole weight's: a column shard whose columns are
not one contiguous block (Mamba2's ``in_proj``, ``nn/ssm.py``).

The QAT product in fp32 (the kernel route; the plain absmean route where
``exact_product`` is set, as ``CausalLM`` sets it for the dense, MoE and
SSM decoders; and under a split over more than one rank,
``tensor_parallel.exact()``: :class:`_TernaryMatmul`) multiplies the int8
codes by the ternary weight, exact integers below 2**24 in any order, and
scales once by (γ/127)·Δ, so a shard's outputs and a row-parallel shard's
accumulators summed over the ranks equal the unsharded layer's bit for bit:
no activation code of the split step differs from the unsharded step's.
The hybrid family's plain steps keep JAX's product of the dequantized
operands (the exact product moved a reduced jamba's QAT loss 1.12e-4 from
JAX's, past its 1e-4 bound).  On the fp route, and the plain QAT route in
bf16, the row-parallel partial outputs are floats summed in another order
than one matmul's (~1e-7 relative in fp32, ~1e-2 in bf16).  SubLN, which
sits on every row-parallel input (before ``wo``, ``down`` and
``out_proj``), takes its mean of squares over the whole width: under a
split over more than one rank (or with ``exact_sum``) summed in float64
and rounded once, the unsharded value in any order; else one fp32 mean.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from repro_torch.core import quant as Q
from repro_torch.distributed import tensor_parallel as tp
from repro_torch.distributed.sharding import constrain
from repro_torch.nn.module import Axes, DEFAULT_POLICY, DTypePolicy, fan_in_init


class BitLinear(nn.Module):
    """y = quant(x) @ quant(w) + b."""

    def __init__(self, in_dim: int, out_dim: int, use_bias: bool = False,
                 quant: Q.QuantConfig = Q.FP,
                 policy: DTypePolicy = DEFAULT_POLICY,
                 gen: Optional[torch.Generator] = None,
                 device: Optional[torch.device] = None,
                 axes: Tuple[str, str] = ("embed", "mlp")):
        super().__init__()
        self.in_dim, self.out_dim = in_dim, out_dim
        self.use_bias, self.quant, self.policy = use_bias, quant, policy
        self.axes = axes
        # the plain absmean QAT product in fp32 as the kernel computes it
        # (CausalLM sets it by family: see the module's docstring)
        self.exact_product = False
        if gen is not None:
            w = fan_in_init(gen, (in_dim, out_dim), policy.param_dtype, device)
        else:
            w = torch.zeros((in_dim, out_dim), dtype=policy.param_dtype,
                            device=device)
        if quant.mode == "packed":
            p = convert_linear_params_fp_to_packed(w)
            self.register_buffer("w_packed", p["w_packed"])
            self.register_buffer("delta", p["delta"])
        else:
            self.w = nn.Parameter(w)
        if use_bias:
            self.b = nn.Parameter(torch.zeros((out_dim,), dtype=policy.param_dtype,
                                              device=device))

    def param_axes(self) -> Dict[str, Axes]:
        a_in, a_out = self.axes
        if self.quant.mode == "packed":
            ax: Dict[str, Axes] = {"w_packed": (a_in, a_out), "delta": ()}
        else:
            ax = {"w": (a_in, a_out)}
        if self.use_bias:
            ax["b"] = (a_out,)
        return ax

    def forward(self, x: torch.Tensor,
                act_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``act_scale`` (mean |x| per input channel) feeds the awq and gptq
        weight schemes of the plain QAT path; no caller passes it, as in the
        JAX package, so they run with a unit scale."""
        split = tp.active()
        if split is not None:
            part = split.linear_part(self.axes, (self.in_dim, self.out_dim))
            if part is not None:
                return self._forward_split(x, split, part)
        cd = self.policy.compute_dtype
        quant = self.quant
        if quant.mode == "fp":
            y = torch.matmul(x.to(cd), self.w.to(cd))
        elif quant.mode == "qat":
            if quant.use_kernel:
                from repro_torch.kernels.bitlinear import ops as kops
                y = kops.bitlinear_matmul(x.to(cd), self.w.to(torch.float32),
                                          scheme=quant.scheme)
            elif quant.scheme == "absmean" and not quant.low_precision_quant:
                # under a split, a layer used whole (kv heads that do not
                # divide over the ranks) computes as its shards would
                y = _qat_absmean(x.to(cd), self.w.to(torch.float32), self.axes,
                                 self.exact_product or tp.exact())
            else:
                xq = Q.fake_quant_act(x.to(cd))
                if quant.low_precision_quant and quant.scheme == "absmean":
                    wq = Q.fake_quant_weight_lp(self.w.to(cd))
                else:
                    wq = Q.fake_quant_weight(self.w.to(torch.float32),
                                             scheme=quant.scheme,
                                             act_scale=act_scale,
                                             block=quant.block)
                y = torch.matmul(xq, constrain(wq.to(cd), self.axes))
        elif quant.mode == "packed":
            y = packed_matmul(x.to(cd), self.w_packed, self.delta, self.in_dim,
                              use_kernel=quant.use_kernel)
        else:
            raise ValueError(f"unknown quant mode {quant.mode!r}")
        if self.use_bias:
            y = y + self.b.to(cd)
        return y

    def _forward_split(self, x: torch.Tensor, split, kind: str) -> torch.Tensor:
        """The rank's part of the layer (see the module's docstring)."""
        if self.quant.mode == "packed":
            y = self._packed_split(x, split, kind)
            if self.use_bias:
                y = y + self.b.to(self.policy.compute_dtype)
            return y
        y = self._product(x, self.w, split, kind)
        if kind == "row" and self.quant.mode == "fp":
            y = tp.reduce_from(y)
        if self.use_bias:
            y = y + self.b.to(self.policy.compute_dtype)
        return y

    def _packed_split(self, x: torch.Tensor, split, kind: str) -> torch.Tensor:
        """A packed layer's column or row shard (see the module's
        docstring)."""
        cd = self.policy.compute_dtype
        use_kernel = self.quant.use_kernel
        if kind == "col":
            return packed_matmul(x.to(cd), self.w_packed, self.delta, self.in_dim,
                                 use_kernel=use_kernel)
        if self.in_dim % (4 * split.size) or self.in_dim > MAX_ROW_K:
            raise ValueError(
                f"a packed layer's row shard: K = {self.in_dim} over {split.size} "
                f"ranks; K/tp must be a whole number of packed bytes (divisible "
                f"by 4) and K at most {MAX_ROW_K}, where the summed accumulators "
                "stay exact in fp32")
        lead = x.shape[:-1]
        x2d = x.to(cd).reshape(-1, x.shape[-1])
        gamma = split.all_max(x2d.to(torch.float32).abs().amax(dim=-1, keepdim=True))
        acc = split.acc_sum(packed_acc(x2d, self.w_packed, gamma, use_kernel))
        y = (acc * (Q.div(gamma, 127.0) * self.delta)).to(cd)
        return y.reshape(*lead, y.shape[-1])

    def forward_cols(self, x: torch.Tensor,
                     cols: Sequence[Tuple[int, int]]) -> torch.Tensor:
        """The output columns ``[lo, hi)`` of each of ``cols``, in their
        order, from ``w`` whole (under a split, a tensor the module uses
        whole): on the QAT routes with the whole weight's Δ, so each column
        is the whole layer's.  The caller's *f* sums ``dx``; the weight's
        gradient is the columns', zero elsewhere."""
        if self.quant.mode == "packed":
            wp = torch.cat([self.w_packed[:, lo:hi] for lo, hi in cols], dim=1)
            y = packed_matmul(x.to(self.policy.compute_dtype), wp, self.delta,
                              self.in_dim, use_kernel=self.quant.use_kernel)
            if self.use_bias:
                b = torch.cat([self.b[lo:hi] for lo, hi in cols])
                y = y + b.to(self.policy.compute_dtype)
            return y
        w = torch.cat([self.w[:, lo:hi] for lo, hi in cols], dim=1)
        delta = None
        if self.quant.mode == "qat":
            delta = Q.absmean_scale(self.w.to(torch.float32))
        y = self._product(x, w, tp.active(), "cols", delta)
        if self.use_bias:
            b = torch.cat([self.b[lo:hi] for lo, hi in cols])
            y = y + b.to(self.policy.compute_dtype)
        return y

    def _product(self, x: torch.Tensor, w: torch.Tensor, split, kind: str,
                 delta: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``x`` times the shard ``w`` on the layer's route: ``kind`` "col"
        or "row" (a ``"model"`` shard: Δ over the shards), or "cols"
        (columns of a weight used whole, Δ given)."""
        cd = self.policy.compute_dtype
        quant = self.quant
        part = None if kind == "cols" else kind
        shard = (part, split) if part else None
        if quant.mode == "fp":
            return torch.matmul(x.to(cd), w.to(cd))
        if quant.mode == "qat" and quant.use_kernel:
            from repro_torch.kernels.bitlinear import ops as kops
            return kops.bitlinear_matmul(x.to(cd), w.to(torch.float32),
                                         scheme=quant.scheme, shard=shard,
                                         delta=delta)
        if quant.mode == "qat":
            if quant.scheme != "absmean" or quant.low_precision_quant:
                raise ValueError(
                    f"the tensor-parallel split takes the 'absmean' weight scheme "
                    f"in fp32, not {quant.scheme!r} with low_precision_quant="
                    f"{quant.low_precision_quant}")
            exact = self.exact_product or tp.exact()
            return _qat_absmean(x.to(cd), w.to(torch.float32), self.axes, exact,
                                split if part else None, part, delta=delta)
        raise ValueError(f"quant mode {quant.mode!r} takes no tensor-parallel "
                         "split of this kind")


class _TernaryMatmul(torch.autograd.Function):
    """``xq @ wq`` of the dequantized activations ``xq = codes·(γ/127)``
    and weight ``wq = tern·Δ``, computed as the bitlinear kernel computes
    it: ``(codes @ tern)·((γ/127)·Δ)``.  The codes' partial sums are
    integers below 2**24 (|code| <= 128, K <= 2**17), so the fp32 matmul is
    exact in any order and a row-parallel shard's accumulators sum exactly
    over the ranks (``split.acc_sum``, *g*) before the one scale.  The
    backward is the matmul's, ``g @ wqᵀ`` and ``xqᵀ @ g``, which the STE of
    each quantizer passes on to x and w."""

    @staticmethod
    def forward(ctx, xq, wq, codes, tern, scale, split):
        ctx.save_for_backward(xq, wq)
        # the projection's dot, which remat_policy "dots" saves: its policy
        # saves the matmuls run with grad enabled (a Function's forward
        # runs without; the kernel route's plain version is not a dot)
        with torch.enable_grad():
            acc = torch.matmul(codes, tern)
        if split is not None:
            acc = split.acc_sum(acc)
        return (acc * scale).to(xq.dtype)

    @staticmethod
    def backward(ctx, g):
        xq, wq = ctx.saved_tensors
        k, n = wq.shape
        dx = torch.matmul(g, wq.t())
        dw = torch.matmul(xq.reshape(-1, k).t(), g.reshape(-1, n))
        return dx, dw, None, None, None, None


def _qat_absmean(x: torch.Tensor, w: torch.Tensor, axes, exact: bool,
                 split=None, kind: Optional[str] = None,
                 delta: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The plain QAT route's absmean product of ``x`` (in the compute
    dtype) and the fp32 master weight ``w``, or of the rank's shards under
    a split (``kind`` "col" or "row"): Δ the whole weight's (or ``delta``),
    γ the whole rows'.  With ``exact`` in fp32 the :class:`_TernaryMatmul`;
    else (bf16, a DTensor weight, or the hybrid family's plain step) the
    dequantized operands' matmul, as JAX's, a row shard's partial outputs
    summed by *g*."""
    xf = x.to(torch.float32)
    gamma = xf.abs().amax(dim=-1, keepdim=True)
    if kind == "row":
        gamma = split.all_max(gamma)
    if delta is None:
        delta = (Q.absmean_scale(w) if split is None or split.size == 1 else
                 Q.absmean_scale(w, (split.sum64, w.numel() * split.size)))
    codes = Q.round_clip(Q.div(127.0, gamma + Q.EPS) * xf, -128.0, 127.0)
    tern = Q.round_clip(w / (delta + Q.EPS), -1.0, 1.0)
    scale = Q.div(gamma, 127.0)
    xq = Q.ste(x, (codes * scale).to(x.dtype))
    wq = Q.ste(w, tern * delta)
    if exact and x.dtype == torch.float32 and not hasattr(w, "to_local"):
        return _TernaryMatmul.apply(xq, wq, codes, tern, scale * delta,
                                    split if kind == "row" else None)
    y = torch.matmul(xq, constrain(wq.to(x.dtype), axes))
    return tp.reduce_from(y) if kind == "row" else y


def packed_matmul(x: torch.Tensor, w_packed: torch.Tensor, delta: torch.Tensor,
                  k: int, use_kernel: bool = False) -> torch.Tensor:
    """Ternary matmul with 2-bit packed weights.

    Plain path: unpack -> int8 codes -> exact integer matmul -> rescale.  The
    codes are integers below 2**24 in every partial sum (|x_q| <= 128, K terms),
    so an fp32 matmul of them is exact in any order and on any device; it
    stands in for the int32 matmul that CUDA's torch lacks.
    Kernel path: the fused unpack + GEMV CUDA kernel (kernels/w2a8_gemv)."""
    if use_kernel:
        from repro_torch.kernels.w2a8_gemv import ops as kops
        return kops.w2a8_matmul(x, w_packed, delta)
    wq = Q.unpack_ternary(w_packed, k)
    xq, gamma = Q.act_quant_absmax_int8(x)
    acc = torch.matmul(xq.to(torch.float32), wq.to(torch.float32))
    scale = Q.div(gamma, 127.0) * delta
    return (acc * scale).to(x.dtype)


# the largest whole K whose row shards' summed accumulators stay exact in fp32
# (128·K < 2**24)
MAX_ROW_K = (1 << 24) // 128 - 1


def packed_acc(x2d: torch.Tensor, w_packed: torch.Tensor, gamma: torch.Tensor,
               use_kernel: bool = False) -> torch.Tensor:
    """A packed row shard's unscaled accumulators: x2d [M, K] quantized with
    the given γ [M, 1] against the ternary rows of ``w_packed`` [K/4, N],
    fp32 [M, N] (exact integers).  Kernel path: ``w2a8_forward_acc``
    (kernels/w2a8_gemv); plain path: the codes' fp32 matmul, as
    :func:`packed_matmul` computes it."""
    if use_kernel:
        from repro_torch.kernels.w2a8_gemv import ops as kops
        return kops.w2a8_matmul_acc(x2d, w_packed, gamma)
    wq = Q.unpack_ternary(w_packed, x2d.shape[-1])
    xq = Q.round_clip(Q.div(127.0, gamma + Q.EPS) * x2d.to(torch.float32),
                      -128.0, 127.0)
    return torch.matmul(xq, wq.to(torch.float32))


class SubLN(nn.Module):
    """Eqs. 4-5: RMSNorm with learned scale, inserted before W_out."""

    def __init__(self, dim: int, eps: float = 1e-6,
                 policy: DTypePolicy = DEFAULT_POLICY,
                 device: Optional[torch.device] = None,
                 axis_name: str = "embed"):
        super().__init__()
        self.eps, self.axis_name, self.dim = eps, axis_name, dim
        # the mean of squares summed in float64 and rounded once off a split
        # too (an unsharded reference of a split's step)
        self.exact_sum = False
        self.scale = nn.Parameter(torch.ones((dim,), dtype=policy.param_dtype,
                                             device=device))

    def param_axes(self) -> Dict[str, Axes]:
        return {"scale": (self.axis_name,)}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Under a split over more than one rank the mean of squares is
        summed in float64 and rounded once; on a shard of the width (x
        narrower than the scale's whole ``dim``) the shards' sums are summed
        over ``"model"`` (both ways), over the whole width."""
        xf = x.to(torch.float32)
        if self.exact_sum or tp.exact():
            x64 = xf.to(torch.float64)
            ss = torch.sum(x64 * x64, dim=-1, keepdim=True)
            if x.shape[-1] != self.dim:
                ss = tp.all_reduce_sum(ss)
            var = Q.div(ss, float(self.dim)).to(torch.float32)
        else:
            var = torch.mean(xf * xf, dim=-1, keepdim=True)
        y = xf * torch.rsqrt(var + self.eps)
        return (y * self.scale.to(torch.float32)).to(x.dtype)


def convert_linear_params_fp_to_packed(w: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Offline conversion of a trained QAT weight [K, N] to the packed form."""
    qw, delta = Q.weight_quant_absmean(w)
    return {"w_packed": Q.pack_ternary(qw.to(torch.int8)),
            "delta": delta.to(torch.float32)}
