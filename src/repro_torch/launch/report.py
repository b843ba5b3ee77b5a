"""Render the dry run's JSON into JAX's roofline table — port of
``repro/launch/report.py``.

    PYTHONPATH=src python -m repro_torch.launch.report [--results DIR] [--multi-pod] [--tag TAG]

The times are floors from the H100 data sheet's peaks
(``launch/roofline.py``), not measurements.  Each row names its step's
route (``split``, every step kind's by default, or ``gathered``); a
train_4k row is followed by the arch's distill cell where ``--all`` ran
it.
"""
from __future__ import annotations

import argparse
import json
import pathlib
from typing import Optional

from repro_torch.launch.dryrun import RESULTS, cell_path, distill_tag
from repro_torch.launch.roofline import Roofline, mfu, model_flops

ARCH_ORDER = [
    "qwen1.5-0.5b", "qwen2.5-3b", "gemma-7b", "llama-3.2-vision-11b",
    "mistral-large-123b", "granite-moe-1b-a400m", "grok-1-314b",
    "whisper-medium", "mamba2-780m", "jamba-1.5-large-398b",
]
SHAPE_ORDER = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]
TOKENS = {"train_4k": 256 * 4096, "prefill_32k": 32 * 32768,
          "decode_32k": 128, "long_500k": 1}


def load(results: pathlib.Path, arch: str, shape: str, multi_pod: bool,
         tag: str = "") -> Optional[dict]:
    p = cell_path(results, arch, shape, multi_pod, tag)
    if not p.exists():
        return None
    return json.loads(p.read_text())


def render_row(d: dict) -> str:
    if d["status"] == "skipped":
        return (f"| {d['arch']} | {d['shape']} | — | — | — | — | — | — | — | — | "
                f"skip: sub-quadratic only |")
    if d["status"] != "ok":
        return (f"| {d['arch']} | {d['shape']} | ERROR | | | | | | | | "
                f"{d.get('error', '')[:60]} |")
    r = d["roofline"]
    mf = model_flops(d["params"], d["active_params"], TOKENS[d["shape"]], d["step"])
    roof = Roofline(r["flops"], r["bytes_accessed"], r["wire_bytes_per_chip"],
                    d["n_devices"], group_size=r.get("group_size", 1))
    ratio = mf / max(r["flops"], 1.0)
    frac = mfu(mf, roof)
    mem_gib = d["memest_per_chip"]["total"] / 2 ** 30
    return (f"| {d['arch']} | {d['shape']} | {d['step']} | {d.get('route', '—')} "
            f"| {r['t_compute_s'] * 1e3:.1f} | {r['t_memory_s'] * 1e3:.1f} "
            f"| {r['t_collective_s'] * 1e3:.1f} | **{r['bottleneck'][:4]}** "
            f"| {ratio:.2f} | {frac * 100:.1f}% | {mem_gib:.1f} GiB"
            f"{'' if d['fits_hbm'] else ' ⚠'} |")


HEADER = ("| arch | shape | step | route | t_comp ms | t_mem ms | t_coll ms "
          "| bound | useful/counted | roofline frac | mem/chip |\n"
          "|---|---|---|---|---|---|---|---|---|---|---|")


def table(results: pathlib.Path = RESULTS, multi_pod: bool = False,
          tag: str = "") -> str:
    rows = [HEADER]
    for a in ARCH_ORDER:
        for s in SHAPE_ORDER:
            for t in ((tag, distill_tag(tag)) if s == "train_4k" else (tag,)):
                d = load(results, a, s, multi_pod, t)
                if d is not None:
                    rows.append(render_row(d))
    return "\n".join(rows)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.report")
    ap.add_argument("--results", default=str(RESULTS))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--tag", default="")
    args = ap.parse_args(argv)
    print(table(pathlib.Path(args.results), args.multi_pod, args.tag))


if __name__ == "__main__":
    main()
