"""1.58-bit / int8 quantizers — port of ``repro/core/quant.py``.

  weights:      Q_w(W)   = Delta * RoundClip(W / (Delta + eps), -1, 1),
                Delta    = mean(|W|)                      (per-tensor absmean)
  activations:  Q_i8(X)  = (gamma/127) * RoundClip(127/(gamma+eps) * X, -128, 127),
                gamma    = max(|X|)  per token            (per-token absmax)

plus the Straight-Through Estimator (STE), the Table-4 quantizer variants
(blockwise / GPTQ-like / AWQ-like) and the low-precision absmean path of the
QAT fake-quantizer, 2-bit packing of ternary weights, and the Fig. 2
analysis helpers.  ``torch.round`` rounds half to even, like ``jnp.round``,
so ternary and int8 codes match the JAX package bitwise for the same scale.
Every mean that sets a scale is summed in float64 and rounded to fp32 once,
so the card and the CPU agree; the JAX package sums in fp32 in XLA's order,
so a scale may differ from it by an ulp or two and flip a code that sits on
a rounding boundary.
"""
from __future__ import annotations

import dataclasses
from typing import Literal, Optional, Tuple

import torch
import torch.nn.functional as F

EPS = 1e-5

QuantMode = Literal["fp", "qat", "packed"]
WeightScheme = Literal["absmean", "blockwise", "gptq", "awq"]


def round_clip(x: torch.Tensor, a: float, b: float) -> torch.Tensor:
    """RoundClip(Y, a, b) = min(max(round(Y), a), b)  (Eq. 2); half to even."""
    return torch.clamp(torch.round(x), a, b)


class _STE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, qx):
        return qx

    @staticmethod
    def backward(ctx, g):
        return g, None


def ste(x: torch.Tensor, qx: torch.Tensor) -> torch.Tensor:
    """Straight-through estimator: the forward returns ``qx`` exactly, the
    backward passes the gradient to ``x`` unchanged and none to ``qx`` (the
    JAX ``custom_vjp``).  ``x + (qx - x).detach()`` would not do: it rounds
    and can differ from ``qx`` in the last bit."""
    return _STE.apply(x, qx)


def _mean32(x: torch.Tensor, dim: Optional[int] = None) -> torch.Tensor:
    """fp32 mean of ``x`` (over ``dim``, keeping it, or all of it) summed in
    float64 and rounded once."""
    x64 = x.to(torch.float64)
    m = x64.mean() if dim is None else x64.mean(dim=dim, keepdim=True)
    return m.to(torch.float32)


def absmean_scale(w: torch.Tensor, shards=None) -> torch.Tensor:
    """Delta = mean(|W|) (per tensor, Eq. 2) as an fp32 scalar.

    Summed in float64 and rounded once, so the scale is the same on the CPU
    and the card; the JAX package sums in fp32 in XLA's order, so the two
    agree to a couple of ulps, not bitwise.  As in JAX, whose mean keeps
    w's dtype, a bf16 or fp16 weight's scale is rounded to that dtype.

    ``shards``: ``w`` is one shard of a split tensor, and ``shards`` is
    ``(total, numel)``: ``total`` sums a float64 value over the ranks
    holding the shards, ``numel`` is the whole tensor's element count.  The
    shard's float64 sum of |W| is summed over them and divided by it, then
    rounded to fp32 once: the unsharded scale but where the float64 sums'
    order moves it across an fp32 rounding boundary."""
    if shards is not None:
        total, numel = shards
        s = total(w.to(torch.float64).abs().sum())
        delta = div(s, float(numel)).to(torch.float32)
        if w.dtype in (torch.bfloat16, torch.float16):
            delta = delta.to(w.dtype).to(torch.float32)
        return delta
    delta = _mean32(w.to(torch.float64).abs())
    if w.dtype in (torch.bfloat16, torch.float16):
        delta = delta.to(w.dtype).to(torch.float32)
    return delta


def weight_quant_absmean(w: torch.Tensor, delta: Optional[torch.Tensor] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eq. 1: per-tensor absmean ternarization -> (q in w.dtype, delta);
    with ``delta`` given (a shard's: the whole tensor's scale) that one."""
    if delta is None:
        delta = absmean_scale(w)
    q = round_clip(w.to(torch.float32) / (delta + EPS), -1.0, 1.0)
    return q.to(w.dtype), delta


def weight_quant_blockwise(w: torch.Tensor, block: int = 128
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Table-4 'Block Quant' [DLSZ21] variant: absmean per (block,)-column
    block of the trailing axis (zero-padded to whole blocks, the pad counted
    in the last block's mean).  Returns (q in w.dtype, delta) with delta of
    shape w.shape[:-1] + (nblocks,)."""
    *lead, n = w.shape
    nb = -(-n // block)
    pad = nb * block - n
    wf = w.to(torch.float32)
    if pad:
        wf = F.pad(wf, (0, pad))
    wb = wf.reshape(*lead, nb, block)
    delta = _mean32(wb.abs(), dim=-1)
    q = round_clip(wb / (delta + EPS), -1.0, 1.0).reshape(*lead, nb * block)
    if pad:
        q = q[..., :n]
    return q.to(w.dtype), delta[..., 0]


def weight_quant_awq(w: torch.Tensor, act_scale: Optional[torch.Tensor] = None,
                     alpha: float = 0.5
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Table-4 'AWQ' [LTT+24] flavor: each input channel c scaled by
    s_c = act_scale_c ** alpha (normalized to unit geometric mean) before
    absmean ternarization; ``act_scale`` (mean |x| per input channel)
    defaults to ones, so s = 1.  Returns (q, delta, s) with dequantized
    weight (q * delta) / s[:, None].  s (the power, the logs, their mean and
    the exponential) is computed in float64 and rounded to fp32 once: fp32
    ``pow``, ``log`` and ``exp`` differ in the last bit between the card
    and the CPU."""
    in_dim = w.shape[0]
    if act_scale is None:
        act_scale = torch.ones((in_dim,), dtype=torch.float32, device=w.device)
    s = torch.pow(torch.clamp(act_scale.to(torch.float32), min=EPS)
                  .to(torch.float64), alpha)
    s = (s / torch.exp(torch.log(s).mean())).to(torch.float32)  # unit geometric mean
    ws = w.to(torch.float32) * s[:, None]
    delta = _mean32(ws.abs())
    q = round_clip(ws / (delta + EPS), -1.0, 1.0)
    return q.to(w.dtype), delta, s


def weight_quant_gptq(w: torch.Tensor, act_scale: Optional[torch.Tensor] = None,
                      damp: float = 0.01) -> Tuple[torch.Tensor, torch.Tensor]:
    """Table-4 'GPTQ' [FAHA22] flavor adapted to ternary, diagonal-Hessian
    form (``repro/core/quant.py:128-165``, copied literally): input-channel
    rows in order of decreasing sensitivity h (a stable sort, so equal h
    keep their order), each row ternarized and its error spread over the
    rows not yet quantized with the weight h_ord[idx] / sum(where(later,
    h_ord, 0) + EPS) — EPS added to every one of the in_dim terms.  JAX
    walks the rows with ``lax.scan``; here a loop over the rows updates the
    later rows in place, the same elementwise fp32 operations.  The
    denominators are suffix sums in float64, rounded once."""
    in_dim, out_dim = w.shape
    wf = w.to(torch.float32)
    if act_scale is None:
        h = torch.ones((in_dim,), dtype=torch.float32, device=w.device)
    else:
        h = torch.clamp(act_scale.to(torch.float32) ** 2, min=EPS)
    h = h + damp * _mean32(h)
    delta = _mean32(wf.abs())
    order = torch.argsort(-h, stable=True)  # most sensitive first
    # the walk carries no gradient (the codes are rounded; ``ste`` passes
    # the gradient to w), so it may update its rows in place
    w_rem = wf.detach()[order]
    h_ord = h.detach()[order]
    # sum over j of (h_ord[j] if j > idx else 0) + EPS, in fp32 terms
    later = (h_ord + EPS).to(torch.float64)
    tail = torch.flip(torch.cumsum(torch.flip(later, (0,)), 0), (0,))
    tail = torch.cat([tail[1:], tail.new_zeros(1)])        # j > idx only
    early = torch.tensor(EPS, dtype=torch.float32).to(torch.float64)
    idx = torch.arange(1, in_dim + 1, dtype=torch.float64, device=w.device)
    wgt = h_ord / (tail + idx * early).to(torch.float32)
    q_ord = torch.empty_like(w_rem)
    d = delta.detach()
    dpe = d + EPS
    for i in range(in_dim):
        row = w_rem[i]
        q = round_clip(row / dpe, -1.0, 1.0)
        q_ord[i] = q
        if i + 1 < in_dim:
            w_rem[i + 1:] -= (row - q * d) * wgt[i]
    q = q_ord[torch.argsort(order)]
    return q.to(w.dtype), delta


def act_quant_absmax_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eq. 3: per-token absmax symmetric int8 over the last axis.
    Returns (q in x.dtype with values in [-128, 127], gamma fp32 [..., 1])."""
    xf = x.to(torch.float32)
    gamma = xf.abs().amax(dim=-1, keepdim=True)
    q = round_clip(div(127.0, gamma + EPS) * xf, -128.0, 127.0)
    return q.to(x.dtype), gamma


def fake_quant_act(x: torch.Tensor, gamma: Optional[torch.Tensor] = None
                   ) -> torch.Tensor:
    """QAT activation path: dequantized int8 with STE gradient.  ``gamma``
    (fp32 [..., 1]) replaces the rows' absmax: a shard of the rows' columns
    quantizes with the whole rows' scale."""
    if gamma is None:
        q, gamma = act_quant_absmax_int8(x)
    else:
        q = round_clip(div(127.0, gamma + EPS) * x.to(torch.float32),
                       -128.0, 127.0).to(x.dtype)
    deq = (q.to(torch.float32) * div(gamma, 127.0)).to(x.dtype)
    return ste(x, deq)


def fake_quant_weight_lp(w: torch.Tensor) -> torch.Tensor:
    """Low-precision absmean QAT path: the scale is accumulated in fp32 (here
    float64, rounded once) but every elementwise tensor stays in w.dtype
    (bf16): Δ goes to w.dtype before ``w / Δ``, each operation computed in
    fp32 and rounded to w.dtype, as JAX's CPU computes bf16.  Ternary values
    are exact in bf16; only inputs within ~0.2% of the 0.5·Δ rounding
    boundary can flip vs the fp32 path."""
    delta = _mean32(w.abs())
    d = (delta + EPS).to(w.dtype)
    q = torch.clamp(torch.round(w / d), -1.0, 1.0)
    return ste(w, q * d)


def fake_quant_weight(w: torch.Tensor, scheme: WeightScheme = "absmean",
                      act_scale: Optional[torch.Tensor] = None,
                      block: int = 128,
                      delta: Optional[torch.Tensor] = None) -> torch.Tensor:
    """QAT weight path: dequantized ternary with STE gradient; ``delta``
    (absmean only) is a shard's whole-tensor scale."""
    if delta is not None and scheme != "absmean":
        raise ValueError(f"a given scale takes the 'absmean' scheme, not {scheme!r}")
    if scheme == "absmean":
        q, delta = weight_quant_absmean(w, delta)
        deq = q.to(torch.float32) * delta
    elif scheme == "blockwise":
        q, delta = weight_quant_blockwise(w, block=block)
        *lead, n = w.shape
        nb = delta.shape[-1]
        qb = F.pad(q.to(torch.float32), (0, nb * block - n))
        deq = (qb.reshape(*lead, nb, block) * delta[..., None]
               ).reshape(*lead, nb * block)[..., :n]
    elif scheme == "awq":
        q, delta, s = weight_quant_awq(w, act_scale)
        deq = q.to(torch.float32) * delta / s[:, None]
    elif scheme == "gptq":
        q, delta = weight_quant_gptq(w, act_scale)
        deq = q.to(torch.float32) * delta
    else:
        raise ValueError(f"unknown weight scheme {scheme!r}")
    return ste(w, deq.to(w.dtype))


def div(a, b) -> torch.Tensor:
    """IEEE ``a / b`` with a scalar on either side.  PyTorch turns
    ``scalar / tensor`` into ``reciprocal * scalar`` and, on CUDA,
    ``tensor / scalar`` into a multiply by the reciprocal; both can differ
    from the true quotient in the last bit, which the quantizers (and the
    kernels they are compared with) cannot afford."""
    if not torch.is_tensor(a):
        a = torch.full_like(b, a)
    if not torch.is_tensor(b):
        b = torch.full_like(a, b)
    return torch.div(a, b)


# ---------------------------------------------------------------------------
# 2-bit packing: value + 1 in {0,1,2} in 2 bits, 4 values little-endian along
# the first (input/K) axis -> uint8 [K/4, N] (repro/core/quant.py:231-248)
# ---------------------------------------------------------------------------

def pack_ternary(q: torch.Tensor) -> torch.Tensor:
    """Pack ternary [K, N] (values in {-1,0,1}) to uint8 [K//4, N]."""
    k, n = q.shape
    if k % 4:
        raise ValueError(f"K={k} must be divisible by 4 for 2-bit packing")
    u = (q.to(torch.int32) + 1).to(torch.uint8).reshape(k // 4, 4, n)
    return u[:, 0] | (u[:, 1] << 2) | (u[:, 2] << 4) | (u[:, 3] << 6)


def unpack_ternary(p: torch.Tensor, k: int) -> torch.Tensor:
    """Inverse of pack_ternary -> int8 [K, N] with values in {-1,0,1}."""
    kp, n = p.shape
    if kp * 4 != k:
        raise ValueError(f"packed rows {kp} do not hold k={k} weights")
    parts = [((p >> (2 * i)) & 0x3).to(torch.int8) - 1 for i in range(4)]
    return torch.stack(parts, dim=1).reshape(k, n)


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    """How linear layers behave.

    mode:
      fp      -- full precision
      qat     -- fake-quant forward + STE backward (training-time 1.58-bit)
      packed  -- true ternary with 2-bit packed weights (inference)
    scheme: ternary weight quantizer flavor (Table 4); ``block`` is the
      blockwise scheme's block.
    quantize_lm_head: BitNet b1.58 keeps the LM head high-precision by default.
    use_kernel: packed projections run the hand-written w2a8 CUDA kernel
      (kernels/w2a8_gemv), qat projections the bitlinear kernel
      (kernels/bitlinear, absmean only: another scheme raises there),
      instead of the plain PyTorch paths.
    low_precision_quant: the absmean QAT weight in bf16 elementwise math
      (``fake_quant_weight_lp``).
    """
    mode: QuantMode = "fp"
    scheme: WeightScheme = "absmean"
    block: int = 128
    quantize_lm_head: bool = False
    use_kernel: bool = False
    low_precision_quant: bool = False

    @property
    def is_quantized(self) -> bool:
        return self.mode != "fp"


FP = QuantConfig(mode="fp")
QAT = QuantConfig(mode="qat")
PACKED = QuantConfig(mode="packed")


# ---------------------------------------------------------------------------
# Analysis helpers (Fig. 2 reproduction)
# ---------------------------------------------------------------------------

def boundary_mass(w: torch.Tensor, width: float = 0.1) -> torch.Tensor:
    """Fraction of weights within ±width*Delta of the 0<->±1 ternary decision
    boundaries (|w|/Delta near 0.5), the paper's Fig. 2 argument."""
    delta = absmean_scale(w)
    r = w.to(torch.float32).abs() / (delta + EPS)
    return ((r - 0.5).abs() < width).to(torch.float32).mean()


def ternary_histogram(w: torch.Tensor) -> torch.Tensor:
    """Counts of {-1, 0, +1} after absmean ternarization (length-3 vector)."""
    q, _ = weight_quant_absmean(w)
    return torch.bincount((q.to(torch.int64) + 1).reshape(-1), minlength=3)
