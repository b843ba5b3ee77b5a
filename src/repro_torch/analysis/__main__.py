"""CLI for the port's analysis gate: ``python -m repro_torch.analysis`` —
port of ``repro/analysis/__main__.py``.

Default run is torch-free and fast:

1. the static lint over ``src/repro_torch`` — unsuppressed, un-baselined
   findings fail with exit code 1;
2. the shadow-pool protocol self-test — a scripted clean request
   lifecycle must pass, then seeded mutations (a dropped trie reference,
   a scatter into a published block, a recycled live block) must each be
   *caught*; a sanitizer that misses its seeded bugs is itself a failure;
3. the trace-schema self-test — a well-formed Chrome trace passes
   ``tracecheck`` and seeded malformations (bad phase, missing dur,
   non-object args) are each caught.

Flags:

* ``--write-baseline``  regenerate ``analysis/baseline.json`` from the
  current findings (grandfathers them; the gate then fails only on new
  violations).
* ``--retrace-smoke``   also self-test the step-signature watchdog on a
  CPU stub engine (imports torch).
* ``--verbose``         list suppressed and baselined findings too.
"""
from __future__ import annotations

import argparse
import sys

from repro_torch.analysis.lint import (RULES, default_baseline_path, run_lint,
                                       write_baseline)
from repro_torch.analysis.shadow import SanitizerError, ShadowBlockPool


def _expect_raise(what: str, fn) -> bool:
    try:
        fn()
    except SanitizerError:
        print(f"  caught : {what}")
        return True
    print(f"  MISSED : {what} — the sanitizer did not fire", file=sys.stderr)
    return False


def shadow_selftest() -> bool:
    """Exercise the full block lifecycle cleanly, then seed mutations the
    shadow must catch.  Mirrors the serving protocol without importing it."""
    ok = True

    # -- clean lifecycle: admit -> publish -> second reader -> drain --------
    sh = ShadowBlockPool(num_blocks=8, block_size=4)
    sh.on_alloc([1, 2])          # admission allocates a private suffix
    sh.claim(slot=0, ids=[1, 2])
    sh.check_write(0, 1)         # chunk scatters into owned blocks: legal
    sh.check_write(0, 2)
    sh.on_share(1, 2)            # trie takes its reference as block 1 fills
    sh.publish(1)
    sh.on_alloc([3])             # a second request: prefix hit on block 1
    sh.claim(1, [3])
    sh.on_share(1, 3)
    sh.attach_reader(1, 1)
    sh.check_write(1, 3)
    sh.on_free(1, 2)             # request 0 finishes
    sh.on_free(2, 0)
    sh.on_free(1, 1)             # request 1 finishes; block 1 trie-only
    sh.on_free(3, 0)
    try:
        sh.assert_drained()
        print("  clean lifecycle: alloc/claim/publish/share/drain ok")
    except SanitizerError as e:
        print(f"  FAILED clean lifecycle: {e}", file=sys.stderr)
        ok = False

    # -- mutation 1: scatter into a published block -------------------------
    sh = ShadowBlockPool(8, 4)
    sh.on_alloc([1])
    sh.claim(0, [1])
    sh.on_share(1, 2)
    sh.publish(1)
    ok &= _expect_raise("write into a published prefix block",
                        lambda: sh.check_write(0, 1))

    # -- mutation 2: trie reference dropped without unpublish ---------------
    sh = ShadowBlockPool(8, 4)
    sh.on_alloc([1])
    sh.claim(0, [1])
    sh.on_share(1, 2)
    sh.publish(1)
    sh.on_free(1, 1)             # slot lets go; block is trie-only now
    ok &= _expect_raise("published block freed without evicting the node",
                        lambda: sh.on_free(1, 0))

    # -- mutation 3: allocator recycles a block that still has a holder -----
    sh = ShadowBlockPool(8, 4)
    sh.on_alloc([1])
    sh.claim(0, [1])
    ok &= _expect_raise("re-allocation of a live block",
                        lambda: sh.on_alloc([1]))

    # -- mutation 4: a slot writes a block another slot owns ----------------
    sh = ShadowBlockPool(8, 4)
    sh.on_alloc([1])
    sh.claim(0, [1])
    ok &= _expect_raise("cross-slot write into an exclusively-owned block",
                        lambda: sh.check_write(1, 1))
    return ok


def tracecheck_selftest() -> bool:
    """A well-formed trace passes; seeded malformations are each caught."""
    from repro_torch.analysis.tracecheck import check_trace

    ok = True
    good = {"traceEvents": [
        {"name": "process_name", "ph": "M", "pid": 1,
         "args": {"name": "engine"}},
        {"name": "commit", "cat": "step", "ph": "X", "ts": 0.0, "dur": 5.0,
         "pid": 1, "tid": 5, "args": {"step": 0}},
        {"name": "first_token", "cat": "request", "ph": "i", "ts": 2.0,
         "pid": 2, "tid": 1, "s": "t"},
    ]}
    errs = check_trace(good)
    if errs:
        print(f"  FAILED: well-formed trace rejected: {errs}",
              file=sys.stderr)
        ok = False
    else:
        print("  clean trace: object form / X / i / M events ok")
    bad_cases = [
        ("unsupported phase", {"traceEvents": [
            {"name": "x", "ph": "Z", "ts": 0, "pid": 1, "tid": 1}]}),
        ("complete event without dur", {"traceEvents": [
            {"name": "x", "ph": "X", "ts": 0, "pid": 1, "tid": 1}]}),
        ("non-object args", {"traceEvents": [
            {"name": "x", "ph": "X", "ts": 0, "dur": 1, "pid": 1,
             "tid": 1, "args": [1, 2]}]}),
        ("negative timestamp", {"traceEvents": [
            {"name": "x", "ph": "X", "ts": -1, "dur": 1, "pid": 1,
             "tid": 1}]}),
        ("missing traceEvents", {"events": []}),
    ]
    for what, doc in bad_cases:
        if check_trace(doc):
            print(f"  caught : {what}")
        else:
            print(f"  MISSED : {what} — tracecheck did not flag it",
                  file=sys.stderr)
            ok = False
    return ok


def retrace_selftest() -> bool:
    """Watchdog mechanics on a CPU stub engine (imports torch): a repeated
    signature is fine, a new one after freeze() is caught, and no kernel
    build is counted on the CPU."""
    import torch

    from repro_torch.analysis.retrace import RetraceError, RetraceWatchdog

    class _Stub:
        def _decode_impl(self, tokens, index, block_tables, draw):
            return tokens * 2

    stub = _Stub()
    wd = RetraceWatchdog.attach(stub)
    try:
        tok = torch.ones((4,), dtype=torch.int32)
        bt = torch.zeros((4, 2), dtype=torch.int32)
        stub._decode_impl(tok, tok, bt, [0, 1])
        stub._decode_impl(tok, tok, bt, [2])     # same shapes: no new signature
        wd.freeze()
        stub._decode_impl(tok, tok, bt, [0])
        wd.check()
        if wd.signatures_per_impl() != {"_decode_impl": 1} or wd.builds:
            print(f"  FAILED: expected one signature and no build, saw "
                  f"{wd.signatures_per_impl()} and {wd.builds} builds",
                  file=sys.stderr)
            return False
        stub._decode_impl(tok, tok, torch.zeros((4, 4), dtype=torch.int32), [0])
        try:
            wd.check()
        except RetraceError:
            print("  caught : a new block-table width after freeze")
            return True
        print("  MISSED : a new signature after freeze not flagged",
              file=sys.stderr)
        return False
    finally:
        wd.detach()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="static lint + sanitizer/watchdog self-tests")
    ap.add_argument("--write-baseline", action="store_true",
                    help="grandfather current findings into baseline.json")
    ap.add_argument("--retrace-smoke", action="store_true",
                    help="also self-test the step-signature watchdog (torch)")
    ap.add_argument("--verbose", action="store_true",
                    help="list suppressed/baselined findings too")
    args = ap.parse_args(argv)

    if args.write_baseline:
        path = write_baseline()
        print(f"wrote {path}")
        return 0

    rc = 0
    print(f"lint: {len(RULES)} rules over src/repro_torch "
          f"(baseline: {default_baseline_path().name})")
    res = run_lint()
    for f in res.active:
        print(f"  {f.render()}", file=sys.stderr)
    if args.verbose:
        for f in res.suppressed:
            print(f"  suppressed: {f.render()}")
        for f in res.baselined:
            print(f"  baselined : {f.render()}")
    print(f"  {len(res.active)} active, {len(res.suppressed)} suppressed, "
          f"{len(res.baselined)} baselined")
    if not res.ok:
        rc = 1

    print("shadow pool self-test:")
    if not shadow_selftest():
        rc = 1

    print("trace schema self-test:")
    if not tracecheck_selftest():
        rc = 1

    if args.retrace_smoke:
        print("step-signature watchdog self-test:")
        if not retrace_selftest():
            rc = 1

    print("analysis: " + ("ok" if rc == 0 else "FAILED"))
    return rc


if __name__ == "__main__":
    sys.exit(main())
