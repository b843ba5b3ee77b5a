"""A later change adds a configuration, a traffic mix and a metric by adding
files and entries only: dropped into a scratch copy of the benchmark, they
are found by name and run."""
import json
import os
import shutil

import bench_local


def test_new_config_traffic_and_metric_are_found_by_name(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(bench_local.BENCH, root / "bench",
                    ignore=shutil.ignore_patterns("out", "__pycache__"))
    shutil.copy(os.path.join(bench_local.ROOT, "BENCHMARK.json"), root)
    with open(root / "bench" / "configs" / "qwen3-0.6b.json") as f:
        cfg = json.load(f)
    cfg["num_hidden_layers"] = 3
    (root / "bench" / "configs" / "qwen3-3layer.json").write_text(json.dumps(cfg))
    with open(root / "bench" / "traffic" / "summarize.json") as f:
        mix = json.load(f)
    mix["loop"] = {"type": "poisson", "rate": 40.0, "clients": 4}
    (root / "bench" / "traffic" / "poisson.json").write_text(json.dumps(mix))
    (root / "bench" / "metrics" / "requests_done.serve.py").write_text(
        "def read(run):\n"
        "    return float(sum(1 for r in run.requests if r.reason == 'LENGTH'))\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "qwen3-3layer", "source": "x",
                             "file": "bench/configs/qwen3-3layer.json",
                             "reduced": ["num_hidden_layers"], "why": "x"})
    bench["workloads"].append({"name": "qwen3-3layer.poisson", "config": "qwen3-3layer",
                               "traffic": "poisson", "chips": 1, "why": "x"})
    bench["end_to_end"].append({"name": "requests_done.serve", "unit": "count",
                                "better": "higher", "bound": 0.25,
                                "source": "host_clock",
                                "workloads": ["qwen3-3layer.poisson"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    ctx = bench_local.run_tiny("qwen3-3layer.poisson", root=str(root), seconds=0.5)
    from harness.main import metrics_of
    got = metrics_of(ctx)
    assert got["requests_done.serve"]["value"] > 0
    assert set(got) == {"requests_done.serve", "setup_s"}
    assert all(c.ok for c in ctx.checks)
