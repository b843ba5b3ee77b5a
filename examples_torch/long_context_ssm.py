"""Long-context decode with an attention-free (Mamba2/SSD) 1.58-bit student,
on the PyTorch port: the counterpart of ``examples/long_context_ssm.py``,
printing the same lines.

Demonstrates why the long_500k shape only runs for SSM/hybrid archs: the
recurrent state is O(1) in sequence length, so decode cost is flat while a
KV cache would grow linearly (and attention quadratically).

    PYTHONPATH=src python examples_torch/long_context_ssm.py [--device cpu]

The default device is ``cuda``; without a card the script exits non-zero.
On the card each group of 20 steps is timed between two
``torch.cuda.synchronize()`` calls.
"""
from __future__ import annotations

import argparse
import time
from typing import Optional

import torch

from repro_torch.core import quant as Q
from repro_torch.models import build_model, get_config
from repro_torch.models.base import ModelConfig
from repro_torch.nn.module import resolve_device, tree_bytes

POSITIONS = (0, 1_000, 100_000, 524_288)


def long_context(cfg: ModelConfig, device,
                 model: Optional[torch.nn.Module] = None) -> dict:
    """20 decode steps of ``cfg``'s QAT student (B = 2) at each of
    ``POSITIONS``, after one warm-up step at position 0; then full
    qwen2.5-3b's KV bytes at 524,288 tokens.  Prints the example's lines;
    returns their values and the last logits of each group (on the CPU).
    ``model`` replaces the seeded init (generator 0)."""
    device = torch.device(device)
    cfg = cfg.with_quant(Q.QAT)
    if model is None:
        model = build_model(cfg, gen=torch.Generator(device=device).manual_seed(0),
                            device=device)
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    b = 2
    cache = model.init_cache(b, 1, torch.float32, device=device)
    state_mib = tree_bytes(cache) / 2**20
    print(f"SSM state bytes (seq-independent): {state_mib:.2f} MiB")

    tok = torch.tensor([1, 2], dtype=torch.int32, device=device)
    at = lambda pos: torch.full((b,), pos, dtype=torch.int32, device=device)
    out = {"state_bytes": tree_bytes(cache), "ms_per_token": {}, "logits": {}}
    with torch.no_grad():
        logits, cache = model.decode_step(tok, cache, at(0))      # warm-up
        for pos in POSITIONS:
            sync()
            t0 = time.perf_counter()
            for _ in range(20):
                logits, cache = model.decode_step(tok, cache, at(pos))
            sync()
            dt = (time.perf_counter() - t0) / 20 * 1e3
            out["ms_per_token"][pos] = dt
            out["logits"][pos] = logits.float().cpu()
            print(f"decode at position {pos:>8d}: {dt:.2f} ms/token "
                  f"(state {tree_bytes(cache)/2**20:.2f} MiB)")

    # contrast: a dense-attention model's KV cache at 524288 tokens
    att = get_config("qwen2.5-3b")
    kv_bytes = (att.n_layers * att.n_kv_heads * att.head_dim * 524_288 * 2 * 2)
    print(f"\nfor contrast, {att.name} full-precision KV cache at 524k tokens "
          f"would be {kv_bytes/2**30:.1f} GiB per sequence — why long_500k is "
          "SSM/hybrid-only (DESIGN.md §4)")
    print("long-context OK")
    out["kv_gib"] = kv_bytes / 2**30
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain paths)")
    args = ap.parse_args(argv)
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        raise SystemExit(f"long_context_ssm.py: {e}") from None
    return long_context(get_config("mamba2-780m").reduced(), device)


if __name__ == "__main__":
    main()
