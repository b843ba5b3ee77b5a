"""Plain PyTorch versions of the SSD scan (port of ``repro/nn/ssm.py``'s
SSD cores and ``repro/kernels/ssd_scan/ref.py``).

  * ``ssd_chunked``    — blocked form: intra-chunk attention-like products
                         plus an inter-chunk recurrence; what the JAX model
                         computes, the kernel's plain version and the
                         recompute of its backward.
  * ``ssd_sequential`` — a loop over time, the oracle.
  * ``ssd_scan_ref``   — the oracle in the TPU kernel's [BH, ...] layout.

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
