"""1.58-bit / int8 quantizers — the inference subset of ``repro/core/quant.py``.

  weights:      Q_w(W)   = Delta * RoundClip(W / (Delta + eps), -1, 1),
                Delta    = mean(|W|)                      (per-tensor absmean)
  activations:  Q_i8(X)  = (gamma/127) * RoundClip(127/(gamma+eps) * X, -128, 127),
                gamma    = max(|X|)  per token            (per-token absmax)

plus the Straight-Through Estimator (STE) and the QAT fake-quantizers of
the absmean scheme, and 2-bit packing of ternary weights.  ``torch.round``
rounds half to even, like ``jnp.round``, so ternary and int8 codes match the
JAX package bitwise for the same scale.  The Table-4 schemes (blockwise /
AWQ / GPTQ) and ``fake_quant_weight_lp`` are not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Literal, Tuple

import torch

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


def absmean_scale(w: torch.Tensor) -> torch.Tensor:
    """Delta = mean(|W|) (per tensor, Eq. 2) as an fp32 scalar.

    Summed in float64 and rounded once, so the scale is the same on the CPU
    and the card; the JAX package sums in fp32 in XLA's order, so the two
    agree to a couple of ulps, not bitwise."""
    return w.to(torch.float64).abs().mean().to(torch.float32)


def weight_quant_absmean(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eq. 1: per-tensor absmean ternarization -> (q in w.dtype, delta)."""
    delta = absmean_scale(w)
    q = round_clip(w.to(torch.float32) / (delta + EPS), -1.0, 1.0)
    return q.to(w.dtype), delta


def act_quant_absmax_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eq. 3: per-token absmax symmetric int8 over the last axis.
    Returns (q in x.dtype with values in [-128, 127], gamma fp32 [..., 1])."""
    xf = x.to(torch.float32)
    gamma = xf.abs().amax(dim=-1, keepdim=True)
    q = round_clip(div(127.0, gamma + EPS) * xf, -128.0, 127.0)
    return q.to(x.dtype), gamma


def fake_quant_act(x: torch.Tensor) -> torch.Tensor:
    """QAT activation path: dequantized int8 with STE gradient."""
    q, gamma = act_quant_absmax_int8(x)
    deq = (q.to(torch.float32) * div(gamma, 127.0)).to(x.dtype)
    return ste(x, deq)


def fake_quant_weight(w: torch.Tensor, scheme: WeightScheme = "absmean"
                      ) -> torch.Tensor:
    """QAT weight path: dequantized ternary with STE gradient (absmean; the
    other Table-4 schemes are not ported and raise)."""
    if scheme != "absmean":
        raise NotImplementedError(f"weight scheme {scheme!r} is not ported; "
                                  "only 'absmean' is")
    q, delta = weight_quant_absmean(w)
    deq = q.to(torch.float32) * delta
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
    use_kernel: packed projections run the hand-written w2a8 CUDA kernel
      (kernels/w2a8_gemv), qat projections the bitlinear kernel
      (kernels/bitlinear), instead of the plain PyTorch paths.
    The remaining fields mirror the JAX config so configs compare equal;
    only ``scheme="absmean"`` is ported in this slice.
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
