"""Dry run of every (architecture x input shape) on the production meshes —
port of ``repro/launch/dryrun.py``.

JAX lowers and compiles each cell for 256 (or 512) fake devices and reads
XLA's analyses.  Here each cell is one rank's step on the meta device
(``launch/specs.py``), counted by ``launch/op_analysis.count``: nothing is
allocated and nothing runs on a card, so the whole grid runs on a CPU.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2.5-3b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod | --both-meshes]

``--all`` runs every (arch x shape) cell and, unless ``--step`` names one,
each arch's distill step on ``train_4k`` (tagged ``distill``).  Each cell
records and prints its step's route (``launch/specs.py::build_cell``:
``split`` for every family and step kind, ``gathered`` where asked for).

One JSON per cell under ``--out`` (default ``build/dryrun/`` in the
checkout), with JAX's keys where they mean the same: ``status`` (``ok``,
``skipped`` with the reason, or ``error`` with the message and the line
that raised: no cell is dropped in silence), ``op_cost`` (with
``kernel_calls``), ``roofline``, ``memest_per_chip``,
``peak_live_bytes_per_chip``, ``fits_hbm``, ``collectives``.
``launch/report.py`` renders them.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time
import traceback

import torch

from repro_torch.configs import ASSIGNED
from repro_torch.configs.shapes import SHAPES, applicable
from repro_torch.distributed import tensor_parallel as tp
from repro_torch.launch.memest import estimate
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.op_analysis import count
from repro_torch.launch.roofline import Roofline, plan_collectives
from repro_torch.launch.specs import build_cell, resolve_variants
from repro_torch.models.base import get_config
from repro_torch.training.trainer import jax_ranks

RESULTS = pathlib.Path(__file__).resolve().parents[3] / "build" / "dryrun"


def run_cell(arch: str, shape: str, multi_pod: bool, step_override=None,
             rules_overrides=None, model_overrides=None, remat_policy=None,
             accum: int = 1, tag: str = "", use_kernels: bool = False,
             verbose: bool = True) -> dict:
    mesh = make_production_mesh(multi_pod=multi_pod)
    t0 = time.time()
    cell = build_cell(arch, shape, mesh, step_override=step_override,
                      rules_overrides=rules_overrides,
                      model_overrides=model_overrides,
                      remat_policy=remat_policy, accum=accum,
                      use_kernels=use_kernels)
    n_dev = cell.n_devices
    t_build = time.time() - t0
    with tp.recording() as recorded:
        cost = count(cell.step_fn, *cell.args,
                     resident=(cell.model, cell.teacher))
    t_count = time.time() - t0 - t_build
    params = whole_params(cell.model)
    coll = plan_collectives(cell.plan, params, cell.step_kind,
                            axes=cell.model.param_axes(),
                            opt_8bit=cell.opt_8bit, ranks=jax_ranks(params),
                            accum=cell.accum, rows=SHAPES[shape].global_batch,
                            route=cell.route, recorded=recorded,
                            metric_parts=_metric_parts(cell))
    # per-rank counts -> whole program (every rank runs the same step)
    roof = Roofline(cost.flops * n_dev, cost.hbm_bytes * n_dev,
                    coll.wire_bytes, n_dev, group_size=coll.group_size)
    memest = estimate(cell.model_cfg, SHAPES[shape], n_dev, cell.tp,
                      opt_8bit=cell.opt_8bit, step_kind=cell.step_kind,
                      with_teacher=cell.step_kind == "distill", route=cell.route)
    op_cost = cost.to_dict()
    op_cost.pop("op_flops")
    res = {
        "arch": arch, "shape": shape, "multi_pod": multi_pod,
        "step": cell.step_kind, "route": cell.route,
        "n_devices": n_dev, "dp": cell.dp, "tp": cell.tp,
        "rows_per_chip": cell.rows,
        "status": "ok",
        "build_s": round(t_build, 2), "count_s": round(t_count, 2),
        "op_cost": op_cost,
        "peak_live_bytes_per_chip": cost.peak_live_bytes,
        "memest_per_chip": {k: (float(v) if not isinstance(v, bool) else v)
                            for k, v in memest.items()},
        "fits_hbm": bool(memest["fits_hbm"]),
        "collectives": coll.to_dict(),
        "roofline": roof.to_dict(),
        "fallbacks": sorted(set(cell.plan.fallbacks)),
        "params": cell.model_cfg.param_count(),
        "active_params": cell.model_cfg.active_param_count(),
        "use_kernels": use_kernels,
        "tag": tag,
    }
    if verbose:
        print(f"[{arch} × {shape} × {'2pod' if multi_pod else '1pod'}"
              f"{' × ' + tag if tag else ''} × {cell.route}] "
              f"count {t_count:.1f}s  memest {memest['total'] / 2**30:.2f} GiB/chip "
              f"(peak live {cost.peak_live_bytes / 2**30:.2f})  "
              f"flops/chip {cost.flops:.3e}  bottleneck {roof.bottleneck}")
        print(f"  roofline: compute {roof.t_compute * 1e3:.2f}ms  "
              f"memory {roof.t_memory * 1e3:.2f}ms  "
              f"collective {roof.t_collective * 1e3:.2f}ms")
        print("  collectives:", coll.counts,
              " kernels:", {k: v["calls"] for k, v in cost.kernel_calls.items()})
    return res


def whole_params(model) -> dict:
    """The model's parameters at their whole shapes (a split cell's model
    holds the rank's shards, each remembering its whole shape)."""
    out = {}
    for k, p in model.named_parameters():
        whole = getattr(p, "_tp_whole", None)
        out[k] = p if whole is None else torch.empty(whole, dtype=p.dtype,
                                                     device="meta")
    return out


def _metric_parts(cell) -> int:
    """The metric values a step sums over its batch axes: CE and MoE, or
    the distill step's CE, KL, relation loss (with attention) and total."""
    if cell.step_kind != "distill":
        return 2
    return 3 + (cell.model_cfg.family != "ssm")


def cell_path(out: pathlib.Path, arch: str, shape: str, multi_pod: bool,
              tag: str = "") -> pathlib.Path:
    pod = "2pod" if multi_pod else "1pod"
    name = f"{arch}__{shape}__{pod}{('__' + tag) if tag else ''}.json"
    return out / name


def distill_tag(tag: str = "") -> str:
    """The tag of ``--all``'s distill cells (beside the train_4k cell)."""
    return f"{tag}+distill" if tag else "distill"


def _error(e: BaseException) -> str:
    """The message and the innermost frame in the package that raised it
    (the op or feature a meta run cannot take)."""
    frames = [f for f in traceback.extract_tb(e.__traceback__)
              if "repro_torch" in f.filename]
    where = (f" at {pathlib.Path(frames[-1].filename).name}:{frames[-1].lineno} "
             f"({frames[-1].line})" if frames else "")
    return f"{type(e).__name__}: {e}{where}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--step", default=None,
                    choices=[None, "train", "prefill", "decode", "distill"])
    ap.add_argument("--remat", default=None)
    ap.add_argument("--variants", default="",
                    help="'+'-joined VARIANTS keys (e.g. dp_zero3+bf16s)")
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--kernels", action="store_true",
                    help="the kernels' wrappers (counted at their boundary)")
    ap.add_argument("--tag", default="")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--out", default=str(RESULTS))
    args = ap.parse_args(argv)
    if args.variants and not args.tag:
        args.tag = args.variants + (f"+acc{args.accum}" if args.accum > 1 else "")
    out = pathlib.Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    if args.all:
        # every (arch, shape) on its own step, and each arch's distill
        # step on train_4k
        cells = [(c.name, s, args.step, args.tag) for c in ASSIGNED for s in SHAPES]
        if args.step is None:
            cells += [(c.name, "train_4k", "distill", distill_tag(args.tag))
                      for c in ASSIGNED]
    elif args.arch and args.shape:
        cells = [(args.arch, args.shape, args.step, args.tag)]
    else:
        ap.error("give --arch and --shape, or --all")
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    failures = 0
    t0 = time.time()
    for arch, shape, step, tag in cells:
        fam = get_config(arch).family
        for mp in meshes:
            path = cell_path(out, arch, shape, mp, tag)
            if path.exists() and not args.force:
                print(f"[skip cached] {path.name}")
                continue
            if not applicable(fam, shape):
                res = {"arch": arch, "shape": shape, "multi_pod": mp,
                       "status": "skipped",
                       "reason": f"{shape} requires sub-quadratic sequence "
                                 f"mixing; {arch} ({fam}) is full-attention "
                                 "(configs/shapes.py::applicable)"}
                path.write_text(json.dumps(res, indent=1))
                print(f"[skip-by-design] {arch} × {shape}")
                continue
            try:
                v_rules, v_model = resolve_variants(args.variants)
                res = run_cell(arch, shape, mp, step_override=step,
                               rules_overrides=v_rules or None,
                               model_overrides=v_model or None,
                               remat_policy=args.remat, accum=args.accum,
                               tag=tag, use_kernels=args.kernels)
            except Exception as e:  # noqa: BLE001 — record and continue
                traceback.print_exc()
                res = {"arch": arch, "shape": shape, "multi_pod": mp,
                       "status": "error", "error": _error(e)}
                failures += 1
            path.write_text(json.dumps(res, indent=1))
    print(f"[dryrun] {len(cells) * len(meshes)} cells in {time.time() - t0:.1f}s, "
          f"{failures} errors")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
