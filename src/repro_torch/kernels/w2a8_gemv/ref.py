"""Plain PyTorch version of the w2a8 kernel (same function, same op order).

Unlike the JAX ``w2a8_ref`` (which scales as ``acc·(γ/127)·Δ``) this keeps the
kernel's order ``acc·((γ/127)·Δ)`` (``repro/kernels/w2a8_gemv/kernel.py:45,53``)
so the card's kernel can be held to it bit for bit; the integer products are
summed exactly (see ``core.bitlinear.packed_matmul``).
"""
from __future__ import annotations

import torch

from repro_torch.core import quant as Q


def w2a8_ref(x: torch.Tensor, wp: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    """x [M, K]; wp uint8 [K//4, N]; delta fp32 scalar -> [M, N] in x.dtype."""
    k = x.shape[-1]
    wq = Q.unpack_ternary(wp, k)
    xf = x.to(torch.float32)
    gamma = xf.abs().amax(dim=-1, keepdim=True)
    xq = Q.round_clip(xf * Q.div(127.0, gamma + 1e-5), -128.0, 127.0)
    acc = torch.matmul(xq, wq.to(torch.float32))
    scale = Q.div(gamma, 127.0) * delta.to(torch.float32)
    return (acc * scale).to(x.dtype)


def w2a8_forward_acc_ref(x: torch.Tensor, wp: torch.Tensor,
                         gamma: torch.Tensor) -> torch.Tensor:
    """The kernel's row-shard entry: x [M, K] (a shard's columns), wp uint8
    [K//4, N], gamma fp32 [M, 1] (the whole rows') -> the unscaled
    accumulators q8(x) @ unpack(wp), fp32 [M, N] (exact integers)."""
    wq = Q.unpack_ternary(wp, x.shape[-1])
    xq = Q.round_clip(x.to(torch.float32) * Q.div(127.0, gamma + 1e-5),
                      -128.0, 127.0)
    return torch.matmul(xq, wq.to(torch.float32))


# -- the card kernel's two routes, as plain models (csrc/w2a8_gemv.cu) --------------

TILE = 128   # the wgmma route's K tile in bytes and N tile in columns


def unpack4_ref(b: torch.Tensor) -> torch.Tensor:
    """The kernels' unpack of packed bytes ``b`` (int64 in [0, 255]): the
    32-bit word of the byte's four int8 codes, byte i = ((b >> 2i) & 3) − 1,
    by the SWAR steps of ``unpack4`` in the .cu."""
    u = (b | (b << 6) | (b << 12) | (b << 18)) & 0x03030303
    return ((u | 0x80808080) - 0x01010101) ^ 0x80808080


def word_codes(w: torch.Tensor) -> torch.Tensor:
    """32-bit words (int64) -> their four int8 codes, little-endian, [..., 4]."""
    return torch.stack([((w >> (8 * e)) & 0xFF).to(torch.uint8).view(torch.int8)
                        for e in range(4)], dim=-1)


def swizzle128(tile: torch.Tensor) -> torch.Tensor:
    """A [rows, 128] byte tile as TMA's 128-byte swizzle lays it in shared
    memory: the 16-byte chunk c of row r at chunk c ^ (r % 8) (its own
    inverse)."""
    rows = tile.shape[0]
    r = torch.arange(rows)[:, None]
    c = torch.arange(8)[None, :]
    chunks = tile.reshape(rows, 8, 16)
    out = torch.empty_like(chunks)
    out[r, c ^ (r % 8)] = chunks[r, c]
    return out.reshape(rows, TILE)


def unpack_tile_ref(ptile_smem: torch.Tensor) -> torch.Tensor:
    """One stage of the wgmma route's unpacking warpgroup: the packed tile
    [32, 128] as TMA wrote it (swizzled) -> the shared-memory image of the
    K-major B tile [128 rows n, 128 bytes of k], as the kernel's stores lay
    it.  Lane = packed row kp; warp u reads the 16-column chunks 2u and 2u+1
    (chunk c of row kp at c ^ (kp % 8)); byte j of chunk c, column n = 16c +
    j, becomes the word of codes k = 4kp .. 4kp+3 of row n, stored in chunk
    (kp >> 2) ^ (n % 8), word kp % 4."""
    kp = torch.arange(32)[:, None, None]
    c = torch.arange(8)[None, :, None]
    j = torch.arange(16)[None, None, :]
    flat = ptile_smem.reshape(-1).to(torch.int64)
    b = flat[kp * TILE + ((c ^ (kp % 8)) << 4) + j]
    n = 16 * c + j
    at = n * TILE + ((((kp >> 2) ^ (j % 8)) << 4) | ((kp % 4) << 2))
    img = torch.zeros(TILE * TILE, dtype=torch.int8)
    codes = word_codes(unpack4_ref(b))                      # [32, 8, 16, 4]
    for e in range(4):
        img[(at + e).reshape(-1)] = codes[..., e].reshape(-1)
    return img.reshape(TILE, TILE)


def kmajor_weight_ref(wp: torch.Tensor) -> torch.Tensor:
    """The K-major weight the wgmma route multiplies, [N, Kp] int8 with Kp =
    K rounded up to 128: ``unpack(wp).t()``, and past K the codes of the
    zero bytes TMA fills in (−1: the activation codes there are zero, so
    they add nothing)."""
    kq, n = wp.shape
    kp = -(-4 * kq // TILE) * TILE
    padded = torch.zeros((kp // 4, n), dtype=torch.uint8, device=wp.device)
    padded[:kq] = wp
    return Q.unpack_ternary(padded, kp).t().contiguous()


def w2a8_wgmma_ref(x: torch.Tensor, wp: torch.Tensor, delta: torch.Tensor
                   ) -> torch.Tensor:
    """The wgmma route: bitlinear's quantizing pass (codes [M, Kp], zero
    pad; γ), then the codes against the K-major unpacked weight, scaled as
    the GEMM's epilogue does."""
    from repro_torch.kernels.bitlinear.ref import (bitlinear_codes_ref,
                                                   quantize_rows_ref)
    codes, gamma = quantize_rows_ref(x)
    return bitlinear_codes_ref(codes, kmajor_weight_ref(wp), gamma, delta, x.dtype)


def w2a8_splitk_ref(x: torch.Tensor, wp: torch.Tensor, delta: torch.Tensor,
                    kps: int, order=None) -> torch.Tensor:
    """The split-K route: K cut into splits of ``kps`` packed rows, each
    split's int32 sums of codes × unpacked weights, the splits added in
    ``order`` (a permutation of the splits: the atomics' order is the
    hardware's), then the scale."""
    k = x.shape[-1]
    xf = x.to(torch.float32)
    gamma = xf.abs().amax(dim=-1, keepdim=True)
    codes = Q.round_clip(xf * Q.div(127.0, gamma + 1e-5), -128.0, 127.0).to(torch.int64)
    wq = Q.unpack_ternary(wp, k).to(torch.int64)
    splits = [(s, min(wp.shape[0], s + kps)) for s in range(0, wp.shape[0], kps)]
    parts = [codes[:, 4 * a:4 * b] @ wq[4 * a:4 * b] for a, b in splits]
    acc = torch.zeros_like(parts[0])
    for i in (range(len(parts)) if order is None else order):
        acc = acc + parts[i]
    scale = Q.div(gamma, 127.0) * delta.to(torch.float32)
    return (acc.to(torch.float32) * scale).to(x.dtype)
