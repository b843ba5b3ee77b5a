"""One rank of tests/test_torch_tp_families.py's gloo jobs (a script, not a
test module: the test starts jobs of one, two and four of these).

    python tests/_torch_tp_families_worker.py RANK WORLD STORE_FILE IO_DIR

It reads ``IO_DIR/inputs.npz`` (the test's seeded inputs and JAX params),
runs the split route's cases for the MoE, SSM and hybrid families over one
gloo group on the CPU and writes what it got to
``IO_DIR/out<WORLD>_<rank>.pt``:

* one rank: each case's CE and distill step without a plan and under the
  (1, 1) plan, both kept, for the test to hold bitwise;
* two ranks (tp 2): the MoE layer split by experts, the Mamba2 block split
  by heads, and the CE and distill steps of granite and mamba2;
* four ranks (tp 4): the same layers (one expert a rank; ``in_proj``'s and
  the conv's flat shards cut mid-group), the MoE layer split by ``d_ff``
  (two experts), and the steps of every case, granite's, mamba2's and
  jamba's with each compute copy's shape, the SSD's heads and the step's
  FLOPs recorded.

Imports torch and the port only.
"""
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch import bridge  # noqa: E402
from repro_torch.core import distill as TD  # noqa: E402
from repro_torch.core import quant as Q  # noqa: E402
from repro_torch.distributed import tensor_parallel as tp  # noqa: E402
from repro_torch.distributed.sharding import ShardingPlan, default_rules  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.launch.op_analysis import count  # noqa: E402
from repro_torch.models import get_config  # noqa: E402
from repro_torch.nn import ssm as ssm_mod  # noqa: E402
from repro_torch.nn.module import flatten_with_paths  # noqa: E402
from repro_torch.nn.moe import MoEMLP  # noqa: E402
from repro_torch.nn.ssm import Mamba2Block  # noqa: E402
from repro_torch.training.optimizer import AdamW, AdamWConfig  # noqa: E402
from repro_torch.training.trainer import (  # noqa: E402
    init_train_state, make_distill_step, make_train_step, place_model)

QAT_KERNEL = Q.QuantConfig(mode="qat", use_kernel=True)
LR = 1e-3
# case -> (config, its reduced() pattern cut to its first positions (one
# layer each) or None, overrides, quant route, the meshes (dp, tp) it runs
# on).  jamba: attention + dense, mamba + MoE, mamba + dense, mamba + MoE
CASES = {
    "granite": ("granite-moe-1b-a400m", None, {}, "plain", ((1, 2), (1, 4))),
    "granite_e2": ("granite-moe-1b-a400m", None, {"n_experts": 2}, "plain",
                   ((1, 4),)),
    "grok": ("grok-1-314b", None, {}, "plain", ((2, 2),)),
    "mamba2": ("mamba2-780m", None, {}, "kernel", ((1, 2), (1, 4))),
    "jamba": ("jamba-1.5-large-398b", 4, {}, "plain", ((1, 4),)),
}
# the cases whose tp-4 step records its compute copies, SSD heads and FLOPs
WATCHED = ("granite", "granite_e2", "mamba2", "jamba")


def quant_of(route):
    return QAT_KERNEL if route == "kernel" else Q.QAT


def reduced(cfg, cut, over):
    """``cfg.reduced()`` with ``over``, its pattern cut to ``cut`` layers
    (the JAX package's config the same way)."""
    cfg = cfg.reduced().replace(**over)
    if cut:
        cfg = cfg.replace(pattern=cfg.resolved_pattern()[:cut], n_layers=cut)
    return cfg


def config(case):
    name, cut, over, route, _ = CASES[case]
    cfg = reduced(get_config(name), cut, over)
    return cfg.with_quant(quant_of(route)), cfg


def tree(inp, prefix):
    out = {}
    for path, v in inp.items():
        if not path.startswith(prefix):
            continue
        node = out
        *head, last = path[len(prefix):].split("/")
        for p in head:
            node = node.setdefault(p, {})
        node[last] = v
    return out


def batch(inp, case, i):
    return {k: torch.from_numpy(inp[f"{case}_{i}/{k}"])
            for k in ("tokens", "labels", "loss_mask")}


def state_np(cfg, state):
    flat = flatten_with_paths(bridge.train_state_to_jax(cfg, state))
    return {k: v.numpy() for k, v in flat.items() if k.startswith("params/")}


def optimizer():
    return AdamW(AdamWConfig(weight_decay=0.0, grad_clip=0.0))


def distill_config(cfg):
    if cfg.family == "ssm":                     # attention-free: CE + logits KD
        return TD.DistillConfig(use_ad=False, use_kernel=True)
    return TD.DistillConfig(distill_layer=0, use_kernel=True)


def run_steps(inp, case, plan, kind, steps):
    """``steps`` steps of ``kind`` ("ce" or "distill") of ``case``'s
    reduced student (its FP teacher placed by the plan) -> (the route taken, per step
    the metrics, the parameters after the last step)."""
    scfg, tcfg = config(case)
    student = bridge.jax_params_to_torch(scfg, tree(inp, f"{case}/student/"),
                                         device="cpu")
    opt = optimizer()
    state = init_train_state(student, opt, plan)
    if kind == "distill":
        teacher = bridge.jax_params_to_torch(tcfg, tree(inp, f"{case}/teacher/"),
                                             device="cpu")
        if plan is not None:
            place_model(teacher, plan)
        step = make_distill_step(student, teacher, opt, lambda s: LR,
                                 distill_config(scfg), plan=plan)
    else:
        step = make_train_step(student, opt, lambda s: LR, plan=plan)
    ms = []
    tp.counter.reset()
    for i in range(steps):
        state, m = step(state, batch(inp, case, i))
        ms.append({k: float(v) for k, v in m.items()})
    # the split route makes the Megatron pair's calls, on one rank too
    return ("split" if tp.counter.count else "plain"), ms, state_np(scfg, state)


def watch(inp, case, plan):
    """One CE step of ``case`` under ``plan`` with each compute copy's
    (spec, whole shape, used whole, shape), the SSD's x shapes and the
    step's FLOPs recorded."""
    seen, ssd = [], []
    copy, scan = tp.param_copy, ssm_mod.ssd_scan

    def watched(split, p, info):
        y = copy(split, p, info)
        seen.append((info.spec, info.shape, info.whole, tuple(y.shape)))
        return y

    def watched_scan(x, *a, **k):
        ssd.append(tuple(x.shape))
        return scan(x, *a, **k)

    tp.param_copy, ssm_mod.ssd_scan = watched, watched_scan
    try:
        scfg, _ = config(case)
        model = bridge.jax_params_to_torch(scfg, tree(inp, f"{case}/student/"),
                                           device="cpu")
        opt = optimizer()
        state = init_train_state(model, opt, plan)
        step = make_train_step(model, opt, lambda s: LR, plan=plan)
        flops = count(step, state, batch(inp, case, 0)).flops
    finally:
        tp.param_copy, ssm_mod.ssd_scan = copy, scan
    return seen, ssd, flops


def layer(inp, plan, case, build, call):
    """``build()``'s layer (the same seeded weights on every rank) placed by
    ``plan`` and run under its split on the layer's inputs: (y, dx, {name:
    (spec, the rank's gradient)})."""
    mod = build()
    place_model(mod, plan)
    split = tp.Split(plan)
    split.register(mod)
    x = torch.from_numpy(inp[f"{case}/x"]).clone().requires_grad_(True)
    with tp.activated(split), tp.using(mod):
        y = call(mod, x)
        (y * torch.from_numpy(inp[f"{case}/r"])).sum().backward()
    grads = {n: (split.params[id(p)][1].spec, p.grad.to_local())
             for n, p in mod.named_parameters()}
    return y.detach(), x.grad, grads


def moe_layer(n_experts):
    cfg = get_config("granite-moe-1b-a400m").reduced().with_quant(Q.QAT)
    cfg = cfg.replace(n_experts=n_experts)
    gen = torch.Generator().manual_seed(27)
    return MoEMLP(cfg.d_model, cfg.d_ff, cfg.n_experts, cfg.top_k, cfg.activation,
                  capacity_factor=cfg.capacity_factor, group_size=cfg.moe_group_size,
                  subln=True, quant=cfg.quant, policy=cfg.policy(), gen=gen)


def mamba_layer():
    cfg = get_config("mamba2-780m").reduced().with_quant(QAT_KERNEL)
    gen = torch.Generator().manual_seed(27)
    blk = Mamba2Block(cfg.d_model, d_state=cfg.ssm_state, head_dim=cfg.ssm_head_dim,
                      chunk=cfg.ssm_chunk, quant=cfg.quant, policy=cfg.policy(),
                      gen=gen)
    with torch.no_grad():
        blk.D.uniform_(0.5, 1.5, generator=gen)
        blk.conv_b.uniform_(-0.1, 0.1, generator=gen)
        blk.norm.scale.uniform_(0.8, 1.2, generator=gen)
    return blk


def layers(inp, world, out):
    plan = ShardingPlan(make_mesh(1, world), default_rules(False))
    moe_call = lambda m, x: m(x)[0]          # noqa: E731
    out["layer/moe"] = layer(inp, plan, "moe", lambda: moe_layer(4), moe_call)
    if world == 4:
        out["layer/moe_e2"] = layer(inp, plan, "moe", lambda: moe_layer(2), moe_call)
    out["layer/ssm"] = layer(inp, plan, "ssm", mamba_layer, lambda m, x: m(x))


def main(rank: int, world: int, store: str, io: Path) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=world)
    inp = dict(np.load(io / "inputs.npz"))
    out = {}
    if world == 1:
        plan = ShardingPlan(make_mesh(1, 1), default_rules(False))
        for case in CASES:
            for kind in ("ce", "distill"):
                out[f"{case}/{kind}"] = (run_steps(inp, case, None, kind, 1),
                                         run_steps(inp, case, plan, kind, 1))
    else:
        layers(inp, world, out)
        for case, (*_, meshes) in CASES.items():
            for dp, n in meshes:
                if dp * n != world:
                    continue
                plan = ShardingPlan(make_mesh(dp, n), default_rules(False))
                out[f"{case}/ce"] = run_steps(inp, case, plan, "ce", 2)
                out[f"{case}/distill"] = run_steps(inp, case, plan, "distill", 1)
                if world == 4 and case in WATCHED:
                    out[f"{case}/watch"] = watch(inp, case, plan)
    torch.save(out, io / f"out{world}_{rank}.pt")
    dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], Path(sys.argv[4]))
