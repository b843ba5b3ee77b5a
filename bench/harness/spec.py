"""A cell as ``BENCHMARK.json`` names it, and the files that belong to it,
found by name: ``bench/configs/<config>.json``, ``bench/traffic/<traffic>.json``
and one reader ``bench/metrics/<metric>.py`` a metric."""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
from typing import List, Optional


@dataclasses.dataclass
class Metric:
    name: str
    unit: str
    better: str
    source: str
    kind: str                       # "end_to_end" or "per_layer"
    workloads: Optional[List[str]]
    read: object                    # read(run) -> float | None

    def applies(self, cell: str) -> bool:
        return self.workloads is None or cell in self.workloads


@dataclasses.dataclass
class Cell:
    name: str
    config_name: str
    traffic_name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: List[Metric]
    per_layer: List[Metric]


def _load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_reader(bench_dir: str, name: str):
    """``bench/metrics/<name>.py``'s ``read`` function."""
    path = os.path.join(bench_dir, "metrics", name + ".py")
    if not os.path.exists(path):
        raise FileNotFoundError(f"metric {name!r} has no reader {path}")
    spec = importlib.util.spec_from_file_location(f"bench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def load_cell(root: str, cell: str) -> Cell:
    bench = _load_json(os.path.join(root, "BENCHMARK.json"))
    bench_dir = os.path.join(root, "bench")
    found = [w for w in bench["workloads"] if w["name"] == cell]
    if not found:
        raise KeyError(f"no workload {cell!r} in BENCHMARK.json; known: "
                       f"{[w['name'] for w in bench['workloads']]}")
    w = found[0]
    conf = [c for c in bench["configs"] if c["name"] == w["config"]][0]
    config = _load_json(os.path.join(root, conf["file"]))
    traffic = _load_json(os.path.join(bench_dir, "traffic", w["traffic"] + ".json"))

    def metrics(kind):
        out = []
        for m in bench[kind]:
            metric = Metric(m["name"], m["unit"], m["better"], m["source"], kind,
                            m.get("workloads"), None)
            if metric.applies(cell):
                metric.read = load_reader(bench_dir, m["name"])
                out.append(metric)
        return out

    return Cell(cell, w["config"], w["traffic"], int(w["chips"]), config,
                traffic, metrics("end_to_end"), metrics("per_layer"))
