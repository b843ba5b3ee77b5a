"""Token sampling — port of ``repro/serving/sampling.py``.

``sample_batch`` is the continuous-batching path: temperature, top-p and a
random stream *per row*.  The JAX engine draws with ``jax.random.categorical``
on per-row threefry keys; torch cannot reproduce that stream, so each row
here owns a ``torch.Generator`` on the device, seeded as the JAX engine seeds
its key (``Engine._request_key``), and advanced only for rows that consume a
sample.  Greedy rows (temperature 0) are exact argmax and match the JAX
package token for token; stochastic rows are held to their distribution.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

# Sentinel for rows whose logits contain NaN/Inf: outside the valid token
# range so commit validation catches poisoned rows; -1 marks terminal events.
NONFINITE_TOKEN = -2


def greedy(logits: torch.Tensor) -> torch.Tensor:
    return torch.argmax(logits, dim=-1).to(torch.int32)


def guard_nonfinite(tok: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """Replace sampled tokens of rows with any non-finite logit by
    ``NONFINITE_TOKEN``."""
    ok = torch.isfinite(logits).all(dim=-1)
    return torch.where(ok, tok, torch.full_like(tok, NONFINITE_TOKEN))


def top_p_probs(logits: torch.Tensor, temperature: torch.Tensor,
                top_p: torch.Tensor) -> torch.Tensor:
    """Per-row nucleus distribution [B, V]: softmax(logits / T), keep the
    smallest top set whose mass reaches ``top_p`` (ties at the threshold
    kept), renormalise.  Same steps as the JAX ``sample_batch``."""
    safe_t = torch.clamp(temperature, min=1e-6)[:, None]
    probs = torch.softmax(logits.to(torch.float32) / safe_t, dim=-1)
    sorted_probs = torch.sort(probs, dim=-1, descending=True).values
    csum = torch.cumsum(sorted_probs, dim=-1)
    cutoff = (csum < top_p[:, None]).sum(dim=-1, keepdim=True) + 1
    cutoff = torch.clamp(cutoff, max=probs.shape[-1])
    threshold = torch.gather(sorted_probs, -1, cutoff - 1)
    masked = torch.where(probs >= threshold, probs, torch.zeros_like(probs))
    return masked / masked.sum(dim=-1, keepdim=True)


def _on(values, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """Host values on ``device``; on the card through pinned memory with a
    ``non_blocking`` copy (a pageable copy would wait for the stream)."""
    t = torch.tensor(values, dtype=dtype)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


def sample_batch(logits: torch.Tensor, temperature: Sequence[float],
                 top_p: Sequence[float],
                 gens: Sequence[Optional[torch.Generator]],
                 draw: Sequence[int]) -> torch.Tensor:
    """logits [B, V] -> int32 tokens [B].  Rows in ``draw`` with temperature
    > 0 sample from their nucleus distribution with their own generator
    (which advances by one draw); every other row is greedy.  ``temperature``
    and ``top_p`` are host arrays, so choosing the rows costs no sync."""
    tok = greedy(logits)
    rows = [r for r in draw if temperature[r] > 0.0]
    if not rows:
        return tok
    dev = logits.device
    idx = _on(rows, torch.long, dev)
    temps = _on([float(temperature[r]) for r in rows], torch.float32, dev)
    tops = _on([float(top_p[r]) for r in rows], torch.float32, dev)
    probs = top_p_probs(logits[idx], temps, tops)
    for i, r in enumerate(rows):
        s = torch.multinomial(probs[i], 1, generator=gens[r])
        tok[r] = s[0].to(torch.int32)
    return tok
