"""One rank of tests/test_torch_tensor_parallel.py's gloo jobs (a script,
not a test module: the test starts two ranks and four of these).

    python tests/_torch_tp_worker.py RANK WORLD STORE_FILE IO_DIR

It reads ``IO_DIR/inputs.npz`` (the test's seeded inputs and JAX params),
runs the split's cases over one gloo group on the CPU and writes what it
got to ``IO_DIR/out<WORLD>_<rank>.pt``.  Two ranks: the layers at tp 2 and
the QAT CE step at dp 1 x tp 2.  Four ranks: the layers at tp 4, the QAT CE
step at dp 2 x tp 2 (with the shapes of every compute copy and of the
logits recorded, and the step's FLOPs counted), the same step at tp 4 on
qwen2.5-3b (one kv head, projected whole on every rank), the CE step at
dp 2 x tp 2 on the plain QAT route and the distill step at dp 2 x tp 2.
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
from repro_torch.core.bitlinear import BitLinear, SubLN  # noqa: E402
from repro_torch.distributed import tensor_parallel as tp  # noqa: E402
from repro_torch.distributed.sharding import ShardingPlan, default_rules  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.launch.op_analysis import count  # noqa: E402
from repro_torch.models import get_config  # noqa: E402
from repro_torch.models.lm import CausalLM  # noqa: E402
from repro_torch.nn.module import DTypePolicy, flatten_with_paths  # noqa: E402
from repro_torch.training.optimizer import AdamW, AdamWConfig  # noqa: E402
from repro_torch.training.trainer import (  # noqa: E402
    init_train_state, make_distill_step, make_train_step, place_model)

F32 = DTypePolicy(torch.float32, torch.float32)
QAT_KERNEL = Q.QuantConfig(mode="qat", use_kernel=True)
LR = 1e-3


def _tree(inp, prefix):
    tree = {}
    for path, v in inp.items():
        if not path.startswith(prefix):
            continue
        node = tree
        *head, last = path[len(prefix):].split("/")
        for p in head:
            node = node.setdefault(p, {})
        node[last] = v
    return tree


def _batch(inp, prefix):
    return {k: torch.from_numpy(inp[f"{prefix}/{k}"])
            for k in ("tokens", "labels", "loss_mask", "image_embeds")
            if f"{prefix}/{k}" in inp}


def _state_np(cfg, state):
    tree = bridge.train_state_to_jax(cfg, state)
    return {k: v.numpy() for k, v in flatten_with_paths(tree).items()
            if k.startswith("params/")}


def _optimizer():
    return AdamW(AdamWConfig(weight_decay=0.0, grad_clip=0.0))


def _layers(rank, n, inp, out):
    """BitLinear column- and row-parallel on three routes, SubLN and the
    vocabulary-parallel losses over a 1 x n mesh: the rank's outputs and
    gradients."""
    split = tp.Split(ShardingPlan(make_mesh(1, n), default_rules(False)))
    x, w, r = (torch.from_numpy(inp[f"layer/{k}"]) for k in ("x", "w", "r"))
    k_dim, n_dim = w.shape
    for route, quant in (("kernel", QAT_KERNEL), ("plain", Q.QAT), ("fp", Q.FP)):
        for kind, axes in (("col", ("embed", "mlp")), ("row", ("mlp", "embed"))):
            lin = BitLinear(k_dim, n_dim, quant=quant, policy=F32, axes=axes)
            lin.exact_product = True            # as a dense decoder's
            local = w.chunk(n, dim=1 if kind == "col" else 0)[rank]
            lin.w = torch.nn.Parameter(local.clone())
            xi = (x if kind == "col" else x.chunk(n, dim=1)[rank]).clone()
            xi.requires_grad_(True)
            with tp.activated(split):
                y = lin(tp.copy_to(xi) if kind == "col" else xi)
                rr = r if kind == "row" else r.chunk(n, dim=1)[rank]
                (y * rr).sum().backward()
            out[f"layer/{route}/{kind}"] = (y.detach(), xi.grad, lin.w.grad)
    # SubLN over the shards of its width
    h, scale = torch.from_numpy(inp["subln/x"]), torch.from_numpy(inp["subln/scale"])
    ln = SubLN(h.shape[-1], policy=F32, axis_name="mlp")
    ln.scale = torch.nn.Parameter(scale.chunk(n)[rank].clone())
    hi = h.chunk(n, dim=-1)[rank].clone().requires_grad_(True)
    with tp.activated(split):
        y = ln(hi)
        (y * torch.from_numpy(inp["subln/r"]).chunk(n, dim=-1)[rank]).sum().backward()
    out["subln"] = (y.detach(), hi.grad, ln.scale.grad)
    # the vocabulary-parallel CE and logits KL on the rank's columns
    s, t = (torch.from_numpy(inp[f"loss/{k}"]).chunk(n, dim=-1)[rank].clone()
            for k in ("s", "t"))
    labels, mask = torch.from_numpy(inp["loss/labels"]), torch.from_numpy(inp["loss/mask"])
    s.requires_grad_(True)
    with tp.activated(split):
        ce = TD.softmax_cross_entropy(s, labels, mask)
        nll = TD.nll_sum(s, labels, mask)
        ld = TD.logits_distill_loss(s, t, 5.0, mask)
        (ce + 10.0 * ld).backward()
    out["loss"] = (float(ce), float(nll), float(ld), s.grad)


def _steps(name, cfg, params, inp, plan, steps=2):
    """``steps`` QAT CE steps under ``plan``: per step the metrics and the
    gathered parameters."""
    model = bridge.jax_params_to_torch(cfg, params, device="cpu")
    opt = _optimizer()
    state = init_train_state(model, opt, plan)
    step = make_train_step(model, opt, lambda s: LR, plan=plan)
    ms, ps = [], []
    for i in range(steps):
        state, m = step(state, _batch(inp, f"{name}{i}"))
        ms.append({k: float(v) for k, v in m.items()})
        ps.append(_state_np(cfg, state))
    return ms, ps


def _watch_the_split(cfg, params, inp, plan):
    """One dp 2 x tp 2 CE step with the shape of every compute copy and of
    the logits recorded, and its FLOPs counted."""
    seen, logits = [], []
    copy = tp.param_copy

    def watched(split, p, info):
        y = copy(split, p, info)
        seen.append((info.spec, info.shape, info.whole, tuple(y.shape)))
        return y

    tp.param_copy = watched
    orig = CausalLM._logits

    def watched_logits(self, x):
        y = orig(self, x)
        logits.append(tuple(y.shape))
        return y

    CausalLM._logits = watched_logits
    try:
        model = bridge.jax_params_to_torch(cfg, params, device="cpu")
        opt = _optimizer()
        state = init_train_state(model, opt, plan)
        step = make_train_step(model, opt, lambda s: LR, plan=plan)
        cost = count(step, state, _batch(inp, "qwen3_0"))
    finally:
        tp.param_copy = copy
        CausalLM._logits = orig
    return seen, logits, cost.flops


def _distill(name, quant, key, inp, plan):
    """One distill step of ``name``'s reduced student on ``quant``'s route
    (its FP teacher placed by the plan) on batch ``<key>_0``: (the route
    taken, the metrics, the parameters)."""
    cfg = get_config(name).reduced().with_quant(quant)
    teacher = bridge.jax_params_to_torch(get_config(name).reduced(),
                                         _tree(inp, f"{key}/teacher/"), device="cpu")
    student = bridge.jax_params_to_torch(cfg, _tree(inp, f"{key}/student/"),
                                         device="cpu")
    place_model(teacher, plan)
    opt = _optimizer()
    state = init_train_state(student, opt, plan)
    dcfg = TD.DistillConfig(distill_layer=1, use_kernel=True)
    step = make_distill_step(student, teacher, opt, lambda s: LR, dcfg, plan=plan)
    tp.counter.reset()
    state, m = step(state, _batch(inp, f"{key}_0"))
    # the split route makes the Megatron pair's calls
    return (("split" if tp.counter.count else "plain"),
            {k: float(v) for k, v in m.items()}, _state_np(cfg, state))


def main(rank: int, world: int, store: str, io: Path) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=world)
    inp = dict(np.load(io / "inputs.npz"))
    out = {}
    qwen3 = get_config("qwen3-0.6b").reduced().with_quant(QAT_KERNEL)
    s_params = _tree(inp, "qwen3/student/")
    _layers(rank, world, inp, out)
    if world == 2:
        plan = ShardingPlan(make_mesh(1, 2), default_rules(False))
        out["ce_1x2"] = _steps("qwen3_", qwen3, s_params, inp, plan)
    else:
        plan = ShardingPlan(make_mesh(2, 2), default_rules(False))
        out["ce_2x2"] = _steps("qwen3_", qwen3, s_params, inp, plan)
        out["watch"] = _watch_the_split(qwen3, s_params, inp, plan)
        qwen25 = get_config("qwen2.5-3b").reduced().with_quant(QAT_KERNEL)
        out["ce_1x4"] = _steps("qwen25_", qwen25, _tree(inp, "qwen25/student/"),
                               inp, ShardingPlan(make_mesh(1, 4), default_rules(False)))
        out["ce_2x2_plain"] = _steps("qwen3_", qwen3.with_quant(Q.QAT), s_params,
                                     inp, plan)
        out["distill_2x2"] = _distill("qwen3-0.6b", QAT_KERNEL, "qwen3", inp, plan)
    torch.save(out, io / f"out{world}_{rank}.pt")
    dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], Path(sys.argv[4]))
