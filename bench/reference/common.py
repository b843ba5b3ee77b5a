"""Quantizers, norms, RoPE and precision control shared by the reference's
model families.

BitNet b1.58 / BitDistill quantizers: a weight's ternary codes
``clamp(round(W / (Δ + 1e-5)), -1, 1)`` with ``Δ = mean |W|`` over the
tensor (summed in float64, rounded to fp32 once); an activation row's int8
codes ``clamp(round(127 / (γ + 1e-5) · x), -128, 127)`` with ``γ = max
|x|`` over the row; the product ``(codes @ ternary) · (γ/127) · Δ``.
Rounding is half to even.  The straight-through estimator passes the
gradient of the product of the dequantized operands to both masters.
"""
from __future__ import annotations

import contextlib
import math
from typing import Callable

import torch

EPS = 1e-5
FP8_MAX = 448.0

Round = Callable[[torch.Tensor], torch.Tensor]


def exact(x: torch.Tensor) -> torch.Tensor:
    return x


def fp8(x: torch.Tensor) -> torch.Tensor:
    """The control's rounding: every activation held in float8 (e4m3),
    the precision below the configuration's bf16."""
    return x.clamp(-FP8_MAX, FP8_MAX).to(torch.float8_e4m3fn).to(x.dtype)


@contextlib.contextmanager
def fp32_matmuls():
    """True fp32 products: TF32 off for the matmuls and convolutions."""
    m, c = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    prec = torch.get_float32_matmul_precision()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c
        torch.set_float32_matmul_precision(prec)


def ternary(w: torch.Tensor):
    """(ternary codes as fp32, Δ fp32 scalar) of a master weight."""
    delta = w.detach().to(torch.float64).abs().mean().to(torch.float32)
    q = torch.clamp(torch.round(w.detach().to(torch.float32) / (delta + EPS)), -1.0, 1.0)
    return q, delta


def act_codes(x: torch.Tensor):
    """(int8 codes as fp32, γ [..., 1] fp32) of each row of ``x``."""
    xf = x.detach().to(torch.float32)
    gamma = xf.abs().amax(dim=-1, keepdim=True)
    codes = torch.clamp(torch.round(torch.full_like(gamma, 127.0) / (gamma + EPS) * xf),
                        -128.0, 127.0)
    return codes, gamma


class _Ternary(torch.autograd.Function):
    """y = (codes @ q) · (γ/127)·Δ forward; straight-through backward:
    dx = g @ (q·Δ)ᵀ, dw = (codes·γ/127)ᵀ @ g."""

    @staticmethod
    def forward(ctx, x, w):
        q, delta = ternary(w)
        codes, gamma = act_codes(x)
        ctx.save_for_backward(q, delta, codes, gamma)
        lead = x.shape[:-1]
        acc = codes.reshape(-1, x.shape[-1]) @ q
        scale = (gamma.reshape(-1, 1) / 127.0) * delta
        return (acc * scale).reshape(*lead, w.shape[-1])

    @staticmethod
    def backward(ctx, g):
        q, delta, codes, gamma = ctx.saved_tensors
        k, n = q.shape
        g2 = g.reshape(-1, n)
        dx = g2 @ (q * delta).t()
        xdq = codes.reshape(-1, k) * (gamma.reshape(-1, 1) / 127.0)
        dw = xdq.t() @ g2
        return dx.reshape(*g.shape[:-1], k), dw


def ternary_linear(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return _Ternary.apply(x, w)


def fp_linear(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return x @ w


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) * scale


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """Split-half rotary embedding: x [B, S, H, Dh], pos [S]."""
    half = x.shape[-1] // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float64,
                                          device=x.device) / half))
    ang = pos.to(torch.float64)[:, None] * freqs
    cos = torch.cos(ang).to(x.dtype)[None, :, None, :]
    sin = torch.sin(ang).to(x.dtype)[None, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def causal_attention(q, k, v):
    """q [B, S, Hq, Dh], k/v [B, S, Hkv, Dh] -> [B, S, Hq, Dh], fp32 softmax."""
    b, s, hq, dh = q.shape
    g = hq // k.shape[2]
    kk = k.repeat_interleave(g, dim=2).permute(0, 2, 3, 1)
    vv = v.repeat_interleave(g, dim=2).permute(0, 2, 1, 3)
    sc = (q.permute(0, 2, 1, 3) @ kk) / math.sqrt(dh)
    mask = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
    sc = sc.masked_fill(~mask, float("-inf"))
    return (torch.softmax(sc, dim=-1) @ vv).permute(0, 2, 1, 3)
