"""The readings that the limits of ``correct`` are set from (not run by the
benchmark's own runs):

* the program's: each seed's run of the cell, and the numbers it compares
  (the lower readings);
* the control's: the reference put in the program's place and computed one
  precision below the configuration's (bf16 -> float8 e4m3 activations),
  judged by the same comparison (the upper readings);
* with ``--fault``, the program with a fault planted under the timed path.

    python3 bench/control.py --workload <cell> --seeds 1,2,3 --seconds 20 \\
        [--control] [--fault half_batch|unchanged_state|altered_token|unchanged_kv]

One JSON line a seed; every seed in one process (the set-up is long).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(ROOT, "bench"), os.path.join(ROOT, "src")]

from harness.context import Context  # noqa: E402
from harness.main import execute, set_environment  # noqa: E402
from harness.spec import load_cell  # noqa: E402


def plant(fault: str, put=setattr) -> None:
    """Break the program under the timed path (see ``--fault``); ``put``
    sets the broken attribute (a test's ``monkeypatch.setattr``)."""
    if fault == "half_batch":
        from repro_torch.training import trainer
        orig = trainer._accumulate

        def half(state, batch, accum, loss_fn):
            return orig(state, {k: v[: v.shape[0] // 2] for k, v in batch.items()},
                        accum, loss_fn)
        put(trainer, "_accumulate", half)
    elif fault == "unchanged_state":
        from repro_torch.training import optimizer

        def frozen(self, grads, state, params, lr):
            gn = optimizer.global_norm(grads)
            return params, optimizer.AdamWState(state.step + 1, state.m, state.v,
                                                state.ranks), {"grad_norm": gn, "lr": lr}
        put(optimizer.AdamW, "update", frozen)
    elif fault == "altered_token":
        from repro_torch.serving import engine
        orig = engine.sample_batch

        def altered(logits, *a, **kw):
            tok = orig(logits, *a, **kw)
            return (tok + 1) % logits.shape[-1]
        put(engine, "sample_batch", altered)
    elif fault == "unchanged_kv":
        # the paged kernels leave the K/V pools as they were (no new K/V kept)
        from repro_torch.kernels.paged_attention import ops as decode
        from repro_torch.kernels.paged_prefill import ops as prefill
        for ops in (decode, prefill):
            def stale(impl, q, k_new, v_new, k_pool, v_pool, *rest,
                      _orig=ops._run, **kw):
                out, _, _ = _orig(impl, q, k_new, v_new, k_pool.clone(),
                                  v_pool.clone(), *rest, **kw)
                return out, k_pool, v_pool
            put(ops, "_run", stale)
    else:
        raise ValueError(f"unknown fault {fault!r}")


def control_readings(ctx: Context) -> dict:
    """The control's numbers for the run in ``ctx``."""
    import torch
    from reference.common import fp8
    from harness.weights import model_weights
    dev = torch.device(ctx.device)
    if ctx.traffic["kind"] == "serve":
        from harness.serve import sample
        from reference import serve_check
        _, student = model_weights(ctx.config, ctx.seed, dev)
        picked = sample(ctx.run, ctx.seed, int(ctx.traffic["check"]["tokens"]))
        got = serve_check.gaps(student, ctx.config, [(r.prompt, r.tokens) for r in picked],
                               dev, control=fp8)
        return {"widest_gap": max(max(g) for g in got)}
    from harness.traffic import DistillFeed
    from reference import train
    teacher_w, student_w = model_weights(ctx.config, ctx.seed, dev)
    vocab = ctx.config["vocab_size"]
    feed = DistillFeed(ctx.traffic, vocab, ctx.seed, ctx.device)
    batches = [feed.next() for _ in range(int(ctx.traffic["checked_steps"]))]
    ref = train.steps(ctx.config, ctx.traffic, teacher_w, student_w, batches)
    low = train.steps(ctx.config, ctx.traffic, teacher_w, student_w, batches, rnd=fp8)
    return train.compare(low["losses"], low["grad"], low["change"], ref)[0]


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--fault", default=None)
    args = ap.parse_args(argv)
    set_environment(ROOT)
    import torch
    if not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 2
    if args.fault:
        plant(args.fault)
    for seed in [int(s) for s in args.seeds.split(",")]:
        t0 = time.perf_counter()
        ctx = Context(load_cell(ROOT, args.workload), seed, args.seconds, False,
                      "cuda", t0)
        execute(ctx)
        line = {"seed": seed, "fault": args.fault, "correct": all(c.ok for c in ctx.checks),
                "program": {c.name: c.value for c in ctx.checks},
                "readings": {k: v for k, v in ctx.readings.items()
                             if not k.startswith("losses")}}
        if args.control:
            line["control"] = control_readings(ctx)
        line["seconds"] = time.perf_counter() - t0
        print(json.dumps(line), flush=True)
        del ctx
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
