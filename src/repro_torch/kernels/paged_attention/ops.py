"""Public wrapper: paged-attention decode over the serving block pools
(``nn/attention.py:Attention.decode`` with ``attn_impl="fused"``).

A CUDA tensor goes to the hand-written kernel (or the call raises); a CPU
tensor goes to the plain PyTorch version.  ``paged_attention_decode_plain``
takes the plain version on any device: it is the ``attn_impl="gather"``
path.  Inference only.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels.paged_attention.kernel import paged_attention_decode_kernel
from repro_torch.kernels.paged_attention.ref import paged_attention_decode_ref


def paged_attention_decode(q: torch.Tensor, k_new: torch.Tensor,
                           v_new: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, block_tables: torch.Tensor,
                           idx: torch.Tensor, softcap: float = 0.0
                           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """q [B, Hq, Dh] (RoPE'd); k_new/v_new [B, Hkv, Dh]; pools
    [N, Hkv, bs, Dh]; block_tables int32 [B, L]; idx int32 [B].

    Returns (ctx [B, Hq, Dh] in pool dtype, k_pool, v_pool); the new K/V is
    written into each row's current block in place."""
    if q.device.type == "cuda":
        return _run(paged_attention_decode_kernel, q, k_new.contiguous(),
                    v_new.contiguous(), k_pool, v_pool, block_tables, idx,
                    softcap)
    if q.device.type == "cpu":
        return paged_attention_decode_plain(q, k_new, v_new, k_pool, v_pool,
                                            block_tables, idx, softcap)
    raise ValueError(f"paged_attention_decode: unsupported device {q.device}")


def paged_attention_decode_plain(q: torch.Tensor, k_new: torch.Tensor,
                                 v_new: torch.Tensor, k_pool: torch.Tensor,
                                 v_pool: torch.Tensor, block_tables: torch.Tensor,
                                 idx: torch.Tensor, softcap: float = 0.0
                                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`paged_attention_decode` through the plain version, on any
    device."""
    return _run(paged_attention_decode_ref, q, k_new, v_new, k_pool, v_pool,
                block_tables, idx, softcap)


def _run(impl, q, k_new, v_new, k_pool, v_pool, block_tables, idx, softcap):
    b, hq, dh = q.shape
    hkv = k_pool.shape[1]
    qg = q.reshape(b, hkv, hq // hkv, dh).contiguous()
    scale = float(1.0 / (dh ** 0.5))
    out, k_pool, v_pool = impl(qg, k_new, v_new, k_pool, v_pool, block_tables,
                               idx, scale, float(softcap))
    return out.reshape(b, hq, dh), k_pool, v_pool
