"""Runs of the benchmark's cells on the CPU at tiny sizes, through the
program's plain routes (its kernels' plain PyTorch versions), for the
tests: the harness's look for a card is skipped, everything else runs as on
the card."""
from __future__ import annotations

import copy
import os
import sys

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for p in (BENCH, os.path.join(ROOT, "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

from harness.context import Context  # noqa: E402
from harness.main import execute  # noqa: E402
from harness.spec import load_cell  # noqa: E402

TINY = {
    # init_embed_std: the logits' scale of the full widths (0.02 at 1024)
    "dense": {"num_hidden_layers": 2, "hidden_size": 64, "num_attention_heads": 4,
              "num_key_value_heads": 2, "head_dim": 16, "intermediate_size": 128,
              "vocab_size": 512, "init_embed_std": 0.08},
    "ssm": {"n_layer": 2, "d_model": 64, "d_state": 16, "headdim": 16,
            "chunk_size": 16, "vocab_size": 512, "init_embed_std": 0.08},
}

TINY_TRAFFIC = {
    "serve": {"prompt": {"shared_prefix": 8, "body": {"dist": "lognormal", "median": 24,
                                                      "sigma": 0.5, "min": 8, "max": 48}},
              "pool": 64, "warmup": {"requests": 4, "output": {"dist": "uniform",
                                                               "min": 1, "max": 6}},
              "engine": {"max_batch": 4, "max_len": 80, "prefill_chunk": 16,
                         "prefill_budget": 32, "prefix_cache": True,
                         "kv_block_size": 16},
              "loop": {"type": "closed", "clients": 4},
              "check": {"tokens": 24}},
    "distill": {"batch": 2, "seq": 32, "loss_positions": 8},
}


def tiny_cell(name: str, root: str = ROOT, config=None, **traffic):
    """The cell ``name`` of ``root``'s BENCHMARK.json cut to a CPU's size:
    the widths and depth of ``TINY``, fp32 compute, a small mix."""
    cell = load_cell(root, name)
    cell.config = copy.deepcopy(cell.config)
    cell.config.update(TINY[cell.config["family"]])
    cell.config.update(config or {})
    cell.config["port"] = dict(cell.config["port"], compute_dtype="float32")
    cell.traffic = copy.deepcopy(cell.traffic)
    kind = cell.traffic["kind"]
    small = copy.deepcopy(TINY_TRAFFIC[kind])
    if kind == "serve" and cell.traffic["output"].get("dist") == "fixed":
        small["warmup"]["output"] = cell.traffic["output"]
        small["prompt"]["shared_prefix"] = 0
    elif kind == "serve":
        small["output"] = {"dist": "uniform", "min": 2, "max": 8}
    cell.traffic.update(small)
    cell.traffic.update(traffic)
    return cell


def run_tiny(name: str, seed: int = 1234567891234, seconds: float = 0.5,
             trace: bool = False, root: str = ROOT, config=None,
             **traffic) -> Context:
    import time
    ctx = Context(tiny_cell(name, root, config, **traffic), seed, seconds, trace, "cpu",
                  time.perf_counter())
    return execute(ctx)
