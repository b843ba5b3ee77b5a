"""The comparison that decides ``correct`` can fail: the harness driven
through a whole reduced run (its look for a card skipped) with the timed
path broken underneath sees ``correct`` come out false, once for each fault
a cell can have; and the control (the reference one precision below the
configuration's) reads far above a sound run."""
import sys

import bench_local
import pytest

sys.path.insert(0, bench_local.BENCH)
import control  # noqa: E402

SERVE = "qwen3-0.6b.serve.summarize"
CLASSIFY = "qwen3-0.6b.serve.classify"


@pytest.mark.parametrize("cell,fault", [
    (SERVE, "altered_token"),
    (SERVE, "unchanged_kv"),
    (CLASSIFY, "altered_token"),
    (CLASSIFY, "unchanged_kv"),
    ("qwen3-0.6b.distill", "half_batch"),
    ("qwen3-0.6b.distill", "unchanged_state"),
    ("mamba2-780m.distill", "half_batch"),
    ("mamba2-780m.distill", "unchanged_state"),
])
def test_a_broken_timed_path_is_not_correct(cell, fault, monkeypatch):
    control.plant(fault, monkeypatch.setattr)
    ctx = bench_local.run_tiny(cell, seconds=0.2)
    assert ctx.checks and not all(c.ok for c in ctx.checks), ctx.checks


# The served model's widest gap grows with depth, so at a test's two layers
# the cell's limit (set from 28 layers on the card) cannot separate; the
# test size has its own, set by the same rule from its own readings on the
# CPU at 2 layers over a second's window and a sample of ~100-200 served
# tokens (the program 0.0-0.0174; the control 0.26-0.43, seeds 1-3 and the
# tests' seed): 0.08.  A sample of ~24 tokens let the control read as low as
# 0.05, so the test checks the larger one.
TEST_SIZE_LIMITS = {c: {"widest_gap": 0.08, "failed_requests": 0} for c in (SERVE, CLASSIFY)}


@pytest.mark.parametrize("cell", ["qwen3-0.6b.distill", "mamba2-780m.distill", SERVE,
                                  CLASSIFY])
def test_the_control_reads_above_the_limits(cell):
    """At a CPU's size the program (fp32 here) reads ~1e-7 on the training
    numbers; the control's float8 activations read past the limits."""
    served = cell in TEST_SIZE_LIMITS
    extra = {"limits": TEST_SIZE_LIMITS[cell], "check": {"tokens": 200}} if served else {}
    ctx = bench_local.run_tiny(cell, seconds=1.0 if served else 0.2, **extra)
    if served:
        assert ctx.readings["checked_tokens"] >= 64, ctx.readings
    low = control.control_readings(ctx)
    limits = ctx.traffic["limits"]
    assert any(v > limits[k] for k, v in low.items() if k in limits), (low, limits)
