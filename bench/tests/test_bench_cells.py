"""Every cell of BENCHMARK.json, cut to a CPU's size, run through the
program's plain routes: correct, every end-to-end metric of the cell read;
one traced run reads the per-layer metrics' plumbing (its numbers are the
CPU's, not device metrics)."""
import json
import math
import os

import bench_local
import pytest

from harness.main import metrics_of, result_line

with open(os.path.join(bench_local.ROOT, "BENCHMARK.json")) as f:
    CELLS = [w["name"] for w in json.load(f)["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_reduced_and_is_correct(cell):
    ctx = bench_local.run_tiny(cell)
    assert ctx.checks and all(c.ok for c in ctx.checks), ctx.checks
    got = metrics_of(ctx)
    want = {m.name for m in ctx.cell.end_to_end}
    assert set(got) == want
    assert all(math.isfinite(v["value"]) and v["value"] > 0 for v in got.values())
    assert ctx.attempted > 0 and ctx.failed == 0


def test_traced_serving_run_reads_its_layers():
    cell = next(c for c in CELLS if ".serve." in c)
    ctx = bench_local.run_tiny(cell, trace=True)
    line = result_line(ctx, {"platform": "cpu"})
    assert line["correct"]
    assert {"host_ms_per_step.serve", "step_mfu.serve", "idle_pct.serve"} <= set(line["metrics"])
    assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]
    assert len(line["breakdown"]["device_ops"]) <= 10
    assert list(line)[-1] == "checks"
