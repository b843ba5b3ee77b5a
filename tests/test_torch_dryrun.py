"""The port's dry run (``launch/specs.py``, ``launch/dryrun.py``,
``launch/report.py``) and ``roofline.plan_collectives``.

JAX's dry-run smoke test (``tests/test_multidevice.py::TestDryRunSmoke``,
which fails in this container) run on the port as a subprocess into
``tmp_path``: the cell counts on the meta device, so it needs no fake
devices; a ``skipped`` and an ``error`` cell; the report's rows; and
``plan_collectives`` against ``CommDebugMode``'s counts of one CE step of
reduced qwen3-0.6b on 4 gloo ranks (dp 2 x tp 2, as in
``tests/test_torch_distributed.py``; the split route), with fp32 and with
int8 moments.  CommDebugMode sees the port's own ``c10d`` calls (the
split's all-reduces, all-gathers and reduce-scatters, the metrics' sum and
the 8-bit moments' block maxima) beside DTensor's functional collectives,
so every call is counted where it is made; the collectives the split
recorded on the gloo ranks are the ones a meta run of the same rank step
records (what the dry run counts).
"""
import json
import pathlib
import subprocess
import sys

import pytest
import torch

from repro_torch.distributed.sharding import ShardingPlan, default_rules
from repro_torch.launch import dryrun, report
from repro_torch.launch.roofline import plan_collectives
from repro_torch.launch.specs import build_cell, resolve_variants
from repro_torch.models import build_model, get_config
from repro_torch.training.trainer import jax_ranks

ROOT = pathlib.Path(__file__).resolve().parents[1]
ENV = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}


def test_dryrun_cell_produces_roofline(tmp_path):
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "qwen1.5-0.5b", "--shape", "decode_32k", "--force", "--tag", "citest",
         "--out", str(tmp_path)],
        capture_output=True, text=True, timeout=600, cwd=ROOT, env=ENV)
    assert r.returncode == 0, r.stderr[-2000:]
    d = json.loads((tmp_path / "qwen1.5-0.5b__decode_32k__1pod__citest.json")
                   .read_text())
    assert d["status"] == "ok"
    assert d["roofline"]["flops"] > 0
    assert d["roofline"]["bottleneck"] in ("compute", "memory", "collective")
    assert d["n_devices"] == 256
    # one rank's step on the split route: its 8 of the 128 rows against its
    # share of a 32k cache (one of the 16 kv heads), its shard of the model,
    # the split's collectives on the wire
    assert (d["dp"], d["rows_per_chip"], d["step"], d["route"]) == \
        (16, 8, "decode", "split")
    counts = d["collectives"]["counts"]
    assert counts["all-reduce"] > 0 and counts["all-gather"] > 0
    assert d["roofline"]["t_collective_s"] > 0
    assert d["op_cost"]["flops"] * 256 == d["roofline"]["flops"]
    m = d["memest_per_chip"]
    assert d["peak_live_bytes_per_chip"] > m["caches"]
    assert m["total"] == pytest.approx(m["params"] + m["at_use_params"]
                                       + m["caches"] + m["layer_transient"])
    assert d["fits_hbm"] is True


def test_skipped_error_and_kernel_cells(tmp_path):
    assert dryrun.main(["--arch", "qwen1.5-0.5b", "--shape", "long_500k",
                        "--out", str(tmp_path)]) == 0
    d = json.loads((tmp_path / "qwen1.5-0.5b__long_500k__1pod.json").read_text())
    assert d["status"] == "skipped" and "sub-quadratic" in d["reason"]
    # a step the cell's shape cannot take: recorded as an error naming it
    assert dryrun.main(["--arch", "qwen1.5-0.5b", "--shape", "decode_32k",
                        "--step", "train", "--tag", "d", "--out",
                        str(tmp_path)]) == 1
    d = json.loads((tmp_path / "qwen1.5-0.5b__decode_32k__1pod__d.json").read_text())
    assert d["status"] == "error" and "needs a train shape" in d["error"] \
        and "specs.py" in d["error"]
    # a variant the port does not know
    with pytest.raises(ValueError, match="unknown variant"):
        resolve_variants("nope")
    # --kernels: the wrappers counted at their boundary on meta
    res = dryrun.run_cell("mamba2-780m", "decode_32k", False, use_kernels=True,
                          verbose=False)
    assert res["op_cost"]["kernel_calls"]["bitlinear"]["calls"] == 2 * 48


def test_train_cell_is_one_ranks_step():
    mesh = {"data": 16, "model": 16}
    cell = build_cell("qwen2.5-3b", "train_4k", mesh)
    assert (cell.n_devices, cell.dp, cell.tp, cell.rows) == (256, 16, 16, 16)
    state, batch = cell.args
    assert tuple(batch["tokens"].shape) == (16, 4096)
    whole = dryrun.whole_params(cell.model)
    # the rank holds its share of each parameter, and so does the model on
    # the split route (a dense config): each block gathers its own at use
    assert cell.route == "split"
    assert sum(p.numel() for p in state.params.values()) < \
        sum(p.numel() for p in whole.values()) / 64
    assert sum(p.numel() for p in cell.model.parameters()) == \
        sum(p.numel() for p in state.params.values())
    assert all(p.device.type == "meta" for p in whole.values())


# a dense config cut to two layers: a cell counts in seconds
TWO_LAYERS = {"n_layers": 2}


def _decode_cell(arch, route="split"):
    """``arch``'s decode_32k cell at two layers on the production mesh,
    counted on meta: (cell, the collectives it recorded, its cost)."""
    from repro_torch.distributed import tensor_parallel as tp
    from repro_torch.launch.op_analysis import count
    cell = build_cell(arch, "decode_32k", {"data": 16, "model": 16},
                      model_overrides=TWO_LAYERS, route=route)
    with tp.recording() as rec:
        cost = count(cell.step_fn, *cell.args, resident=(cell.model,))
    return cell, rec, cost


@pytest.mark.parametrize("arch,heads,seq", [("qwen1.5-0.5b", 1, 32768),
                                            ("qwen3-0.6b", 8, 2048)])
def test_split_decode_cell_places_the_cache(arch, heads, seq):
    """qwen1.5-0.5b's 16 kv heads split one a rank; qwen3-0.6b's 8 do not
    divide over 16, so its cache splits by positions (2048 of 32768 a rank)
    and the decode merges the ranks' attention: a max and a sum all-reduce
    a layer beside the split's projections' sums, the logits gathered."""
    cell, rec, _ = _decode_cell(arch)
    batch, cache, index = cell.args
    assert cell.route == "split" and cell.rows == 8
    for layer in cache:
        assert tuple(layer["attn"]["k"].shape) == (8, heads, seq,
                                                   cell.model_cfg.head_dim)
    kinds = {(k, a) for k, a, _, _ in rec}
    assert ("all-gather", "model") in kinds and ("all-reduce", "model") in kinds
    stats = plan_collectives(cell.plan, dryrun.whole_params(cell.model), "decode",
                             route="split", recorded=rec)
    assert sum(stats.counts.values()) == len(rec) and stats.group_size == 16
    # the logits' gather: the whole padded vocabulary of the rank's rows
    item = torch.empty((), dtype=cell.model_cfg.policy().compute_dtype).element_size()
    vocab = 8 * cell.model_cfg.padded_vocab * item
    assert any(k == "all-gather" and b == vocab for k, _, _, b in rec)


def test_decode_cell_on_the_gathered_route():
    """``route="gathered"``: the rank holds the whole model and every
    head's cache of its rows, and moves nothing."""
    cell, rec, _ = _decode_cell("qwen1.5-0.5b", route="gathered")
    _, cache, _ = cell.args
    assert cell.route == "gathered" and rec == []
    assert tuple(cache[0]["attn"]["k"].shape) == (8, 16, 32768, 64)
    assert all(p.shape == w.shape for p, w in zip(
        cell.model.parameters(), dryrun.whole_params(cell.model).values()))
    assert plan_collectives(cell.plan, dict(cell.model.named_parameters()),
                            "decode").counts == {}


def test_distill_cell_builds_under_a_plan():
    """A distill cell under a 2 x 4 plan: the student and the FP teacher
    split over "model", the step counted with both kernels' wrappers."""
    from repro_torch.launch.op_analysis import count
    from repro_torch.distributed import tensor_parallel as tp
    cell = build_cell("qwen3-0.6b", "train_4k", {"data": 2, "model": 4},
                      step_override="distill", model_overrides=TWO_LAYERS,
                      use_kernels=True)
    assert (cell.step_kind, cell.route, cell.dp, cell.tp) == ("distill", "split", 2, 4)
    assert cell.teacher is not None
    assert all(p.shape != w.shape for p, w in zip(
        cell.teacher.parameters(), dryrun.whole_params(cell.teacher).values())
        if len(p.shape) == 2)
    with tp.recording() as rec:
        cost = count(cell.step_fn, *cell.args, resident=(cell.model, cell.teacher))
    # 7 projections a layer, forward and the remat recompute; the relation
    # loss's three states at its unsplit shapes
    assert cost.kernel_calls["bitlinear"]["calls"] == 2 * 7 * 2
    assert cost.kernel_calls["relation_kd"]["calls"] == 3
    kinds = {k for k, *_ in rec}
    assert kinds == {"all-reduce", "all-gather", "reduce-scatter"}
    # the relation states gathered over "model": q, k, v of student and teacher
    heads = [b for k, a, g, b in rec if k == "all-gather" and a == "model"]
    assert len(heads) >= 6
    res = dryrun.run_cell("qwen3-0.6b", "train_4k", False, step_override="distill",
                          model_overrides=TWO_LAYERS, verbose=False)
    assert res["status"] == "ok" and res["route"] == "split"
    assert res["collectives"]["counts"]["all-gather"] > 0


def test_split_train_cell_counts_a_tp_share_of_the_flops():
    """qwen2.5-3b (two layers; 2 kv heads, which do not divide over 4
    ranks, so each rank projects both): a rank's counted FLOPs on the split
    route are the gathered route's over the "model" size, plus at most the
    replicated kv projections (forward, remat recompute and backward)."""
    from repro_torch.launch.op_analysis import count
    mesh = {"data": 2, "model": 4}
    cost = {}
    for route in ("gathered", "split"):
        cell = build_cell("qwen2.5-3b", "train_4k", mesh, model_overrides=TWO_LAYERS,
                          route=route)
        cost[route] = count(cell.step_fn, *cell.args, resident=cell.model).flops
    cfg = cell.model_cfg
    tokens = cell.rows * 4096
    kv = 4 * 2 * tokens * cfg.d_model * cfg.n_kv_heads * cfg.head_dim * 2 * 2
    assert cost["gathered"] / 4 <= cost["split"] <= cost["gathered"] / 4 + kv
    assert cost["split"] < cost["gathered"] / 3.5


def test_report_renders_the_cells(tmp_path):
    assert dryrun.main(["--arch", "qwen1.5-0.5b", "--shape", "decode_32k",
                        "--out", str(tmp_path)]) == 0
    assert dryrun.main(["--arch", "qwen1.5-0.5b", "--shape", "long_500k",
                        "--out", str(tmp_path)]) == 0
    text = report.table(tmp_path)
    rows = text.splitlines()
    assert rows[0].startswith("| arch | shape | step |")
    assert any(r.startswith("| qwen1.5-0.5b | decode_32k | decode |") for r in rows)
    assert any(r.startswith("| qwen1.5-0.5b | long_500k | — |") for r in rows)
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.report",
                          "--results", str(tmp_path)], capture_output=True,
                         text=True, timeout=120, cwd=ROOT, env=ENV)
    assert out.returncode == 0 and out.stdout.strip() == text


_KIND = {"c10d_functional.all_gather_into_tensor": "all-gather",
         "c10d_functional.reduce_scatter_tensor": "reduce-scatter",
         "c10d_functional.all_reduce": "all-reduce",
         "c10d.allreduce_": "all-reduce",
         "c10d._allgather_base_": "all-gather",
         "c10d._reduce_scatter_base_": "reduce-scatter"}


@pytest.fixture(scope="module")
def comm_counts(tmp_path_factory):
    io = tmp_path_factory.mktemp("comm")
    store = io / "store"
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "_torch_comm_worker.py"), str(r), "4",
         str(store), str(io)], cwd=ROOT, env=ENV, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(4)]
    outs = [p.communicate(timeout=600)[0] for p in procs]
    for p, o in zip(procs, outs):
        assert p.returncode == 0, o[-3000:]
    return [json.loads((io / f"comm_{r}.json").read_text()) for r in range(4)]


def _meta_rank_step_records(state_dtype):
    """The collectives the dry run's rank step records on meta for the
    comm worker's step (reduced qwen3-0.6b, dp 2 x tp 2, 2 rows of 16)."""
    from repro_torch.distributed import tensor_parallel as tp
    from repro_torch.launch import specs
    from repro_torch.training.optimizer import AdamW, AdamWConfig
    from repro_torch.training.trainer import TrainState, ce_loss_parts, make_split
    plan = ShardingPlan({"data": 2, "model": 2}, default_rules(False))
    model = build_model(get_config("qwen3-0.6b").reduced(), device="meta")
    ranks = jax_ranks(dict(model.named_parameters()))
    tp.shard_model(model, plan)
    split = make_split(plan, model, local=True)
    split.batch_axes = ("data",)
    opt = AdamW(AdamWConfig(state_dtype=state_dtype))
    local = dict(model.named_parameters())
    fn = specs._rank_step(model, opt, 1, ce_loss_parts(model), 2, split, lambda g: g)
    batch = {k: torch.empty((2, 16), dtype=dt, device="meta") for k, dt in
             (("tokens", torch.int32), ("labels", torch.int32),
              ("loss_mask", torch.float32))}
    with tp.recording() as rec:
        fn(TrainState(local, opt.init(local, ranks), 0), batch)
    return [list(r) for r in rec]


@pytest.mark.parametrize("state_dtype", ["float32", "int8_blockwise"])
def test_plan_collectives_match_comm_debug_mode(comm_counts, state_dtype):
    seen = {}
    counts = [c["counts"][state_dtype] for c in comm_counts]
    for k, v in counts[0].items():
        seen[_KIND[k]] = seen.get(_KIND[k], 0) + v
    assert all(c == counts[0] for c in counts)
    recorded = comm_counts[0]["recorded"][state_dtype]
    assert all(c["recorded"][state_dtype] == recorded for c in comm_counts)
    assert sorted(map(tuple, _meta_rank_step_records(state_dtype))) == \
        sorted(map(tuple, recorded))
    model = build_model(get_config("qwen3-0.6b").reduced(), device="meta")
    params = dict(model.named_parameters())
    plan = ShardingPlan({"data": 2, "model": 2}, default_rules(False))
    stats = plan_collectives(plan, params, "train", axes=model.param_axes(),
                             opt_8bit=state_dtype == "int8_blockwise",
                             ranks=jax_ranks(params), rows=4, route="split",
                             recorded=recorded)
    assert stats.counts == seen
    assert stats.wire_bytes > 0 and stats.group_size == 2
    assert plan_collectives(plan, params, "decode", axes=model.param_axes()).counts == {}
