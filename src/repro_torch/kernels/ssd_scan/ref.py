"""Plain PyTorch versions of the SSD scan (port of ``repro/nn/ssm.py``'s
SSD cores and ``repro/kernels/ssd_scan/ref.py``).

  * ``ssd_chunked``    — blocked form: intra-chunk attention-like products
                         plus an inter-chunk recurrence; what the JAX model
                         computes, the kernel's plain version and the
                         recompute of its backward.
  * ``ssd_sequential`` — a loop over time, the oracle.
  * ``ssd_scan_ref``   — the oracle in the TPU kernel's [BH, ...] layout.
  * ``ssd_stages``     — ``ssd_chunked`` cut into the card kernel's stages
                         (``csrc/ssd_scan.cu``), each a function here, with
                         the products through a ``mm`` that can round as
                         the tensor cores do (``matmul_3xtf32``).

Two departures from the JAX cores, neither of which changes a value the
JAX package computes finitely:
  * ``ssd_chunked`` masks the segment sums before the exponential
    (``exp(where(causal, seg, -inf))``).  JAX takes ``where(causal,
    exp(seg), 0)``: above the diagonal ``seg`` is positive and overflows
    once a chunk's summed dt·|A| passes ~88, and the discarded inf turns the
    gradient into 0·inf = NaN.  Forward values are the same.
  * The 3- and 4-operand einsums are written as pairwise products, so no
    ``[b, c, q, k, h, p]`` intermediate is formed (12.9 GB at mamba2-780m's
    widths, batch 8 x 512).
"""
from __future__ import annotations

from typing import Tuple

import torch


def chunk_len(s: int, chunk: int) -> int:
    """The largest divisor of ``s`` that is at most ``chunk``."""
    q = min(chunk, s)
    while s % q:
        q -= 1
    return q


def ssd_sequential(x, a, dt, B, C, chunk: int = 0, init_state=None):
    """Oracle: loop over time.  x [b,s,h,p], a/dt [b,s,h], B/C [b,s,n].

    Returns (y [b,s,h,p], final_state [b,h,p,n])."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    state = (torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
             if init_state is None else init_state)
    ys = []
    for t in range(s):
        inp = (dt[:, t, :, None] * x[:, t])[..., None] * B[:, t, None, None, :]
        state = state * a[:, t, :, None, None] + inp
        ys.append(torch.einsum("bhpn,bn->bhp", state, C[:, t]))
    return torch.stack(ys, dim=1), state


def ssd_chunked(x, a, dt, B, C, chunk: int = 256, init_state=None):
    """Blocked SSD: intra-chunk attention-like products + inter-chunk
    recurrence.  Same arguments and results as ``ssd_sequential``."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    q = chunk_len(s, chunk)
    nc = s // q

    xc = x.reshape(b, nc, q, h, p)
    dc = dt.reshape(b, nc, q, h)
    Bc = B.reshape(b, nc, q, n)
    Cc = C.reshape(b, nc, q, n)
    la = torch.cumsum(torch.log(torch.clamp_min(a.reshape(b, nc, q, h), 1e-20)),
                      dim=2)

    # intra-chunk (the diagonal block): M[q,k] = C_q.B_k exp(la_q - la_k) dt_k
    cb = torch.einsum("bcqn,bckn->bcqk", Cc, Bc)
    seg = la[:, :, :, None, :] - la[:, :, None, :, :]              # [b,c,q,k,h]
    causal = torch.ones((q, q), dtype=torch.bool, device=x.device).tril()
    decay = torch.exp(torch.where(causal[None, None, :, :, None], seg,
                                  float("-inf")))
    m = cb[..., None] * decay * dc[:, :, None, :, :]
    y_intra = torch.einsum("bcqkh,bckhp->bcqhp", m, xc)

    # chunk summary states: S_c = sum_k B_k (dt_k exp(la_last - la_k)) x_k
    last = la[:, :, -1:, :]
    wk = dc * torch.exp(last - la)                                  # [b,c,q,h]
    S = torch.einsum("bckn,bckhp->bchpn", Bc, wk[..., None] * xc)

    # inter-chunk recurrence over the chunk index
    a_chunk = torch.exp(last[:, :, 0, :])                           # [b,c,h]
    state = (torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
             if init_state is None else init_state)
    h_in = []
    for c in range(nc):
        h_in.append(state)
        state = state * a_chunk[:, c, :, None, None] + S[:, c]
    h_in = torch.stack(h_in, dim=1)                                 # [b,c,h,p,n]

    # off-diagonal contribution: y_q += exp(la_q) * (C_q . h_in)
    y_off = torch.einsum("bcqn,bchpn->bcqhp", Cc, h_in) * torch.exp(la)[..., None]
    return (y_intra + y_off).reshape(b, s, h, p), state


def ssd_scan_ref(x: torch.Tensor, a: torch.Tensor, dt: torch.Tensor,
                 B: torch.Tensor, C: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [BH, S, P]; a/dt [BH, S]; B/C [BH, S, N] -> (y [BH, S, P], final
    state [BH, N, P]): ``ssd_sequential`` with one head per row."""
    y, h = ssd_sequential(x[:, :, None, :], a[:, :, None], dt[:, :, None], B, C)
    return y[:, :, 0, :], h[:, 0].transpose(-1, -2)


# -- the card kernel's stages -------------------------------------------------------

def tf32_round(v: torch.Tensor) -> torch.Tensor:
    """fp32 rounded to TF32 (10 mantissa bits) to nearest, ties away from
    zero: ``cvt.rna.tf32.f32``."""
    bits = v.to(torch.float32).contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def matmul_tf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One TF32 product per fp32 one: both operands rounded to TF32, the
    products (exact in fp32) summed in fp32."""
    return torch.matmul(tf32_round(a), tf32_round(b))


def tf32_trunc(v: torch.Tensor) -> torch.Tensor:
    """fp32 cut to its top 10 mantissa bits (the low 13 bits cleared)."""
    return (v.to(torch.float32).contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def matmul_3xtf32(a: torch.Tensor, b: torch.Tensor,
                  part=tf32_trunc) -> torch.Tensor:
    """The card's 3xTF32 product: v = hi + lo with hi = part(v), lo =
    part(v − hi) (the card cuts both by a bit mask, ``part=tf32_trunc``;
    ``tf32_round`` splits to nearest); a·b = a_lo·b_hi + a_hi·b_lo +
    a_hi·b_hi (a_lo·b_lo, below fp32's precision, dropped).  Each product
    of two TF32 values is exact in fp32."""
    ah, bh = part(a), part(b)
    al, bl = part(a - ah), part(b - bh)
    return torch.matmul(al, bh) + torch.matmul(ah, bl) + torch.matmul(ah, bh)


def ssd_stage_la(a, dt, q: int):
    """Stage 1: per (b, chunk, head) la = cumsum(log(max(a, 1e-20))) in
    sequence order, and the factors the later stages read: exp(la), the
    state weights dt·exp(la_last − la) and exp(la_last).  a, dt [b, s, h] ->
    la, ela, wst [b, c, q, h]; dec [b, c, h]."""
    b, s, h = a.shape
    la = torch.cumsum(torch.log(torch.clamp_min(a.reshape(b, s // q, q, h), 1e-20)),
                      dim=2)
    last = la[:, :, -1:, :]
    wst = dt.reshape(b, s // q, q, h) * torch.exp(last - la)
    return la, torch.exp(la), wst, torch.exp(last[:, :, 0, :])


def ssd_stage_cb(B, C, q: int, mm=torch.matmul):
    """Stage 2: C·Bᵀ once per (b, chunk), shared by the heads.  B, C [b, s,
    n] -> [b, c, q, q] (the card computes the causal tiles only; the entries
    above the diagonal are never read)."""
    b, s, n = B.shape
    return mm(C.reshape(b, s // q, q, n), B.reshape(b, s // q, q, n).transpose(-1, -2))


def ssd_stage_states(x, B, wst, mm=torch.matmul):
    """Stage 3: the chunk-local states Bᵀ·(wst ⊙ x) per (b, chunk, head).
    x [b, s, h, p], B [b, s, n], wst [b, c, q, h] -> [b, c, h, n, p]."""
    b, c, q, h = wst.shape
    p, n = x.shape[-1], B.shape[-1]
    xw = (x.reshape(b, c, q, h, p) * wst[..., None]).permute(0, 1, 3, 2, 4)
    return mm(B.reshape(b, c, 1, q, n).transpose(-1, -2), xw)


def ssd_stage_carry(states, dec):
    """Stage 4: the state entering each chunk, h_in[c] = h_in[c−1]·dec[c−1] +
    states[c−1] from zero, and the final state.  states [b, c, h, n, p], dec
    [b, c, h] -> (h_in [b, c, h, n, p], final [b, h, n, p])."""
    h = torch.zeros_like(states[:, 0])
    h_in = []
    for c in range(states.shape[1]):
        h_in.append(h)
        h = h * dec[:, c, :, None, None] + states[:, c]
    return torch.stack(h_in, dim=1), h


def ssd_stage_output(x, C, cb, la, ela, dt, h_in, mm=torch.matmul):
    """Stage 5: y = exp(la_q)·C_q·h_in + Σ_k M[q, k] x_k with M = C·Bᵀ ⊙
    exp(la_q − la_k) ⊙ dt_k, masked (k > q -> 0) before the exponential.
    Returns y [b, s, h, p]."""
    b, c, q, h = la.shape
    p, n = x.shape[-1], C.shape[-1]
    causal = torch.ones((q, q), dtype=torch.bool, device=x.device).tril()
    lat = la.permute(0, 1, 3, 2)                                   # [b,c,h,q]
    seg = lat[..., :, None] - lat[..., None, :]                    # [b,c,h,q,k]
    m = (cb[:, :, None] * torch.exp(torch.where(causal, seg, float("-inf")))
         * dt.reshape(b, c, q, h).permute(0, 1, 3, 2)[..., None, :])
    xc = x.reshape(b, c, q, h, p).permute(0, 1, 3, 2, 4)           # [b,c,h,q,p]
    y = mm(m, xc) + mm(C.reshape(b, c, 1, q, n), h_in) * ela.permute(0, 1, 3, 2)[..., None]
    return y.permute(0, 1, 3, 2, 4).reshape(b, c * q, h, p)


def ssd_stages(x, a, dt, B, C, chunk: int = 256, mm=torch.matmul):
    """``ssd_chunked`` as the card computes it: the five stages in order,
    every product through ``mm``.  Returns (y [b, s, h, p], final state [b,
    h, p, n]) as ``ssd_chunked`` does."""
    q = chunk_len(x.shape[1], chunk)
    la, ela, wst, dec = ssd_stage_la(a, dt, q)
    cb = ssd_stage_cb(B, C, q, mm)
    h_in, final = ssd_stage_carry(ssd_stage_states(x, B, wst, mm), dec)
    y = ssd_stage_output(x, C, cb, la, ela, dt, h_in, mm)
    return y, final.transpose(-1, -2)
