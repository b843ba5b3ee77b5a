"""One rank of tests/test_torch_tp_cross.py's gloo jobs (a script, not a
test module: the test starts jobs of one, two and four of these).

    python tests/_torch_tp_cross_worker.py RANK WORLD STORE_FILE IO_DIR

It reads ``IO_DIR/inputs.npz`` (the test's seeded batches and the JAX
params of each case's teacher and student), runs the cross-attention
families' CE and distill steps on the split route over one gloo group on
the CPU and writes what it got to ``IO_DIR/out<WORLD>_<rank>.pt``:

* one rank: each case's CE and distill step without a plan and under the
  (1, 1) plan, both kept, for the test to hold bitwise;
* two and four ranks (tp 2, tp 4): two CE steps and a distill step of each
  case under the (1, WORLD) plan, and at tp 4 one CE step with every
  compute copy's (spec, whole shape, shape) and the logits' shape recorded.

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
from repro_torch.models import get_config  # noqa: E402
from repro_torch.models.lm import CausalLM  # noqa: E402
from repro_torch.nn.module import flatten_with_paths  # noqa: E402
from repro_torch.training.optimizer import AdamW, AdamWConfig  # noqa: E402
from repro_torch.training.trainer import (  # noqa: E402
    default_distill_layer, init_train_state, make_distill_step, make_train_step,
    place_model)

QAT_KERNEL = Q.QuantConfig(mode="qat", use_kernel=True)
LR = 1e-3
WORLDS = (1, 2, 4)
# case -> (config, its reduced depth or None, the batch's memory key):
# whisper-medium (a 2-layer encoder, 2 decoder layers of self- and cross-
# attention, 4 heads and 4 kv heads), llama-3.2-vision-11b cut to one repeat
# of its pattern (4 attention layers and a cross layer; 4 heads, one kv
# head: the kv projections used whole, the memory's too)
CASES = {"whisper": ("whisper-medium", None, "frames"),
         "vision": ("llama-3.2-vision-11b", 5, "image_embeds")}


def config(case):
    name, layers, _ = CASES[case]
    cfg = get_config(name).reduced(layers=layers)
    return cfg.with_quant(QAT_KERNEL), cfg


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
    key = CASES[case][2]
    return {k: torch.from_numpy(inp[f"{case}_{i}/{k}"])
            for k in ("tokens", "labels", "loss_mask", key)}


def state_np(cfg, state):
    flat = flatten_with_paths(bridge.train_state_to_jax(cfg, state))
    return {k: v.numpy() for k, v in flat.items() if k.startswith("params/")}


def optimizer():
    return AdamW(AdamWConfig(weight_decay=0.0, grad_clip=0.0))


def distill_config(cfg):
    return TD.DistillConfig(distill_layer=default_distill_layer(cfg), use_kernel=True)


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
    (spec, whole shape, shape) and the decoder's logits' shape recorded."""
    seen, logits = [], []
    copy, orig = tp.param_copy, CausalLM._logits

    def watched(split, p, info):
        y = copy(split, p, info)
        seen.append((info.spec, info.shape, tuple(y.shape)))
        return y

    def watched_logits(self, x):
        y = orig(self, x)
        logits.append(tuple(y.shape))
        return y

    tp.param_copy, CausalLM._logits = watched, watched_logits
    try:
        scfg, _ = config(case)
        model = bridge.jax_params_to_torch(scfg, tree(inp, f"{case}/student/"),
                                           device="cpu")
        opt = optimizer()
        state = init_train_state(model, opt, plan)
        make_train_step(model, opt, lambda s: LR, plan=plan)(state, batch(inp, case, 0))
    finally:
        tp.param_copy, CausalLM._logits = copy, orig
    return seen, logits


def main(rank: int, world: int, store: str, io: Path) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=world)
    inp = dict(np.load(io / "inputs.npz"))
    plan = ShardingPlan(make_mesh(1, world), default_rules(False))
    out = {}
    for case in CASES:
        if world == 1:
            for kind in ("ce", "distill"):
                out[f"{case}/{kind}"] = (run_steps(inp, case, None, kind, 1),
                                         run_steps(inp, case, plan, kind, 1))
            continue
        out[f"{case}/ce"] = run_steps(inp, case, plan, "ce", 2)
        out[f"{case}/distill"] = run_steps(inp, case, plan, "distill", 1)
        if world == 4:
            out[f"{case}/watch"] = watch(inp, case, plan)
    torch.save(out, io / f"out{world}_{rank}.pt")
    dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], Path(sys.argv[4]))
