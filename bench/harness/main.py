"""``bench/run.py``'s body: one run of one cell, its result line."""
from __future__ import annotations

import argparse
import importlib
import json
import os
import sys
from typing import List

from harness.context import Context
from harness.spec import load_cell

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's, flax's or the JAX
    package's, compared whole (``repro_torch`` is not ``repro``)."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(t for t in tops if t in FORBIDDEN)


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def set_environment(root: str) -> None:
    """Caches at fixed paths inside the checkout; no JAX through a
    library."""
    out = os.path.join(root, "bench", "out")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(out, "triton")
    os.environ["TORCHINDUCTOR_CACHE_DIR"] = os.path.join(out, "inductor")
    os.environ["REPRO_TORCH_BUILD_DIR"] = os.path.join(root, "build", "kernels")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def execute(ctx: Context) -> Context:
    """Drive the cell's traffic kind (``harness/<kind>.py``) and read its
    metrics."""
    driver = importlib.import_module("harness." + ctx.traffic["kind"])
    driver.run(ctx)
    return ctx


def metrics_of(ctx: Context) -> dict:
    run = ctx.run
    chosen = ctx.cell.per_layer if ctx.trace else ctx.cell.end_to_end
    out = {}
    for m in chosen:
        v = m.read(run)
        if v is not None:
            out[m.name] = {"value": float(v), "unit": m.unit}
    return out


def result_line(ctx: Context, device_info: dict) -> dict:
    run = ctx.run
    line = {"correct": all(c.ok for c in ctx.checks) and bool(ctx.checks),
            "attempted": ctx.attempted, "failed": ctx.failed,
            "metrics": metrics_of(ctx), "device": device_info}
    if ctx.trace:
        line["device"]["busy_s"] = run.device.busy_s()
        line["device"]["window_s"] = run.window_s
        line["breakdown"] = run.device.breakdown(run.spans)
    line["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in ctx.checks}
    return line


def main(argv, root: str, t_start: float) -> int:
    args = parse(argv)
    set_environment(root)
    cell = load_cell(root, args.workload)
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"bench: {cell.name} needs {cell.chips} CUDA card(s); this machine "
              f"has {n}", file=sys.stderr)
        return 2
    ctx = Context(cell, args.seed, args.seconds, bool(args.trace), "cuda", t_start)
    execute(ctx)
    bad = forbidden_modules()
    if bad:
        print(f"bench: the run loaded {bad} (JAX or the JAX package)", file=sys.stderr)
        return 3
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": cell.chips, "memory_peak_bytes": int(ctx.memory_peak_bytes)}
    line = result_line(ctx, info)
    print(f"bench: setup_s {ctx.run.setup_s} window_s {ctx.run.window_s}",
          file=sys.stderr)
    if ctx.trace:                       # the profiler's cost, for PERF.md
        for m in ctx.cell.end_to_end:
            v = m.read(ctx.run)
            print(f"bench: traced {m.name} {v}", file=sys.stderr)
    for k, v in ctx.readings.items():
        print(f"bench: {k} {v}", file=sys.stderr)
    for c in ctx.checks:
        print(f"check {c.name} {c.value!r} limit {c.limit!r} "
              f"{'ok' if c.ok else 'FAILED'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0
