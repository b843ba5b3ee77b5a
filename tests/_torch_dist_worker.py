"""One rank of tests/test_torch_distributed.py's 4-rank gloo job (a script,
not a test module: the test starts four of these).

    python tests/_torch_dist_worker.py RANK WORLD STORE_FILE IO_DIR

It reads ``IO_DIR/inputs.npz`` (the test's seeded inputs and JAX params),
runs every collective case on the CPU over one gloo group, and writes what
it got to ``IO_DIR/out_<rank>.pt``; rank 0 writes the gathered states.
Imports torch and the port only.
"""
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch import bridge  # noqa: E402
from repro_torch.core import quant as Q  # noqa: E402
from repro_torch.distributed.compression import (  # noqa: E402
    compressed_psum, make_compressed_allreduce)
from repro_torch.distributed.pipeline_parallel import (  # noqa: E402
    gpipe_forward, pipeline_stage_from_stack)
from repro_torch.distributed.sharding import ShardingPlan, default_rules  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models import build_model, get_config  # noqa: E402
from repro_torch.nn.module import flatten_with_paths  # noqa: E402
from repro_torch.training.optimizer import AdamW, AdamWConfig, Moment8  # noqa: E402
from repro_torch.training.trainer import init_train_state, make_train_step  # noqa: E402


def _unflatten(flat):
    tree = {}
    for path, v in flat.items():
        node = tree
        *head, last = path.split("/")
        for p in head:
            node = node.setdefault(p, {})
        node[last] = v
    return tree


def _batch(inp, prefix):
    return {k: torch.from_numpy(inp[f"{prefix}/{k}"])
            for k in ("tokens", "labels", "loss_mask")}


def _local_shapes(state):
    out = {}
    for part, tree in (("params", state.params), ("m", state.opt_state.m),
                       ("v", state.opt_state.v)):
        for k, t in tree.items():
            if isinstance(t, Moment8):
                out[f"{part}/{k}/code"] = tuple(t.code.to_local().shape)
                out[f"{part}/{k}/scale"] = tuple(t.scale.to_local().shape)
            else:
                out[f"{part}/{k}"] = tuple(t.to_local().shape)
    return out


def _gathered(cfg, state):
    """The whole train state in JAX layout as numpy (every rank gathers)."""
    tree = bridge.train_state_to_jax(cfg, state)
    return {k: v.numpy() for k, v in flatten_with_paths(tree).items()}


def main(rank: int, world: int, store: str, io: Path) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=world)
    inp = dict(np.load(io / "inputs.npz"))
    out = {}
    whole = dist.group.WORLD

    # compressed_psum: two rounds with error feedback
    e = torch.zeros(inp["psum/x1"].shape[1])
    for r in (1, 2):
        y, e = compressed_psum(torch.from_numpy(inp[f"psum/x{r}"][rank]), whole, e)
        out[f"psum/y{r}"], out[f"psum/e{r}"] = y.numpy(), e.numpy()

    # GPipe over the four ranks: stage s = tanh(x @ w_s)
    pp = gpipe_forward(lambda w, x: torch.tanh(x @ w), whole, 4)
    out["gpipe"] = pp(torch.from_numpy(inp["gpipe/ws"][rank]),
                      torch.from_numpy(inp["gpipe/xs"])).numpy()

    # two stages of a reduced qwen3 stack over ranks 0 and 1
    pair = dist.new_group([0, 1])
    if rank < 2:
        cfg = get_config("qwen3-0.6b").reduced()
        model = build_model(cfg, gen=torch.Generator().manual_seed(0), device="cpu")
        xs = torch.from_numpy(inp["stack/xs"])
        with torch.no_grad():
            got = gpipe_forward(pipeline_stage_from_stack(model.stack, 1), pair, 2)(
                rank, xs)
            want = torch.stack([model.stack(x)[0] for x in xs])
        out["stack/got"], out["stack/want"] = got.numpy(), want.numpy()

    # the CE step at dp 2 x tp 2: qwen1.5-0.5b reduced, FP, JAX's params
    mesh = make_mesh(2, 2)
    plan = ShardingPlan(mesh, default_rules(False))
    cfg = get_config("qwen1.5-0.5b").reduced()
    params = _unflatten({k[len("fp/params/"):]: v for k, v in inp.items()
                         if k.startswith("fp/params/")})
    model = bridge.jax_params_to_torch(cfg, params, device="cpu")
    opt = AdamW(AdamWConfig(weight_decay=0.0, grad_clip=0.0))
    state = init_train_state(model, opt, plan)
    out["fp/local_shapes"] = _local_shapes(state)
    step = make_train_step(model, opt, lambda s: 1e-3, plan=plan)
    state, m = step(state, _batch(inp, "fp"))
    out["fp/metrics"] = {k: float(v) for k, v in m.items()}
    state_np = _gathered(cfg, state)
    if rank == 0:
        out["fp/state"] = state_np

    # the QAT step with int8 moments and grad_clip, two steps, at pods 2 x tp 2
    mesh = make_mesh(1, 2, pods=2)
    # first the EF-int8 gradient mean over its "pod" axis, a tree of two
    reduce_tree = make_compressed_allreduce(mesh, "pod")
    x = torch.from_numpy(inp["psum/x1"][rank])
    means, errs = reduce_tree({"a": x[:2000].reshape(40, 50), "b": x[2000:]},
                              {"a": torch.zeros(40, 50), "b": torch.zeros(500)})
    out["pod/means"] = {k: v.numpy() for k, v in means.items()}
    out["pod/errs"] = {k: v.numpy() for k, v in errs.items()}
    plan = ShardingPlan(mesh, default_rules(True))
    cfg = get_config("qwen3-0.6b").reduced().with_quant(Q.QAT)
    model = build_model(cfg, gen=torch.Generator().manual_seed(0), device="cpu")
    opt = AdamW(AdamWConfig(state_dtype="int8_blockwise"))
    state = init_train_state(model, opt, plan)
    out["qat/local_shapes"] = _local_shapes(state)
    step = make_train_step(model, opt, lambda s: 1e-3, plan=plan)
    out["qat/metrics"] = []
    for i in range(2):
        state, m = step(state, _batch(inp, f"qat{i}"))
        out["qat/metrics"].append({k: float(v) for k, v in m.items()})
    state_np = _gathered(cfg, state)
    if rank == 0:
        out["qat/state"] = state_np

    torch.save(out, io / f"out_{rank}.pt")
    dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], Path(sys.argv[4]))
