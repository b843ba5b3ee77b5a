"""One rank of tests/test_torch_tp_decode.py's gloo jobs (a script, not a
test module: the test starts jobs of two and four of these).

    python tests/_torch_tp_decode_worker.py RANK WORLD STORE_FILE IO_DIR

Every rank builds each case's model from its seed (the same weights on
every rank), cuts its shard under the (1, WORLD) plan
(``tensor_parallel.shard_model``), places its share of the decode cache
(``init_cache`` under the split) and decodes the test's prompt, one token a
step, then greedy steps (:func:`decode`); it writes each case's logits and
tokens, the shapes of its cache and the packed kernels' calls it made
(each wrapper's, at ``kernels/boundary.py``) to
``IO_DIR/out<WORLD>_<rank>.pt``.

Imports torch and the port only.
"""
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.core import quant as Q  # noqa: E402
from repro_torch.distributed import tensor_parallel as tp  # noqa: E402
from repro_torch.distributed.sharding import ShardingPlan, default_rules  # noqa: E402
from repro_torch.kernels import boundary  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models import build_model, get_config  # noqa: E402
from repro_torch.training.trainer import make_split  # noqa: E402

MAX_LEN, STEPS = 16, 6
# case -> (config, quant mode, seed): qwen1.5-0.5b's 4 kv heads split by
# heads at tp 2 and 4; qwen2.5-3b's one kv head does not divide, so its
# cache splits by positions; mamba2-780m's state by heads and its conv
# tail by channels; granite-moe-1b-a400m's 4 experts by rank (its 2 kv
# heads by heads at tp 2, by positions at tp 4); a packed qwen1.5-0.5b on
# column and row shards (the row shards through the plain w2a8_forward_acc);
# qwen1.5-0.5b and qwen2.5-3b in bf16 with bf16 scores and a bf16 cache, QAT
# on the kernel route (its accumulators exact, so the projections' shards
# sum to the unsharded step's), one by heads and one by positions
CASES = {
    "mha": ("qwen1.5-0.5b", "fp", 31),
    "kv_seq": ("qwen2.5-3b", "fp", 32),
    "mamba2": ("mamba2-780m", "fp", 33),
    "moe": ("granite-moe-1b-a400m", "fp", 35),
    "packed": ("qwen1.5-0.5b", "packed", 34),
    "bf16_heads": ("qwen1.5-0.5b", "bf16", 36),
    "bf16_kv_seq": ("qwen2.5-3b", "bf16", 37),
}
QAT_KERNEL = Q.QuantConfig(mode="qat", use_kernel=True)


def model_of(case):
    name, mode, seed = CASES[case]
    cfg = get_config(name).reduced()
    if mode == "packed":
        cfg = cfg.with_quant(Q.QuantConfig(mode="packed", use_kernel=True))
    elif mode == "bf16":
        cfg = cfg.with_quant(QAT_KERNEL).replace(compute_dtype="bfloat16",
                                                 attn_scores_dtype="bfloat16")
    return cfg, build_model(cfg, gen=torch.Generator().manual_seed(seed),
                            device="cpu")


def cache_dtype(case):
    return torch.bfloat16 if CASES[case][1] == "bf16" else torch.float32


def decode(model, prompt, split=None, steps=STEPS, dtype=torch.float32):
    """``prompt`` [B, P] fed a token a step, then ``steps`` greedy steps
    (each row at its own depth: row b starts at position b), on a cache of
    ``dtype`` -> (the logits of every step [P - 1 + steps, B, V], the
    greedy tokens [steps, B], the cache)."""
    b, p = prompt.shape
    with torch.no_grad(), tp.activated(split):
        cache = model.init_cache(b, MAX_LEN, dtype, torch.device("cpu"))
        start = torch.arange(b, dtype=torch.int32)
        tok, logits, toks = prompt[:, 0], [], []
        for i in range(p - 1 + steps):
            out, cache = model.decode_step(tok, cache, start + i)
            logits.append(out)
            greedy = out.argmax(-1)
            if i + 1 < p:
                tok = prompt[:, i + 1]
            else:
                tok = greedy
                toks.append(greedy)
    return torch.stack(logits), torch.stack(toks), cache


class Calls:
    """A boundary observer: each kernel wrapper's calls, by name."""

    def __init__(self):
        self.calls = {}

    def kernel_call(self, name, impl, args):
        self.calls[name] = self.calls.get(name, 0) + 1
        return impl(*args)


def prompt_of(inp, case):
    return torch.from_numpy(inp[f"{case}/prompt"]).long()


def main(rank: int, world: int, store: str, io: Path) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=world)
    inp = dict(np.load(io / "inputs.npz"))
    plan = ShardingPlan(make_mesh(1, world), default_rules(False))
    out = {}
    for case in CASES:
        _, model = model_of(case)
        tp.shard_model(model, plan)
        split = make_split(plan, model, local=True)
        calls = Calls()
        boundary.set_observer(calls)
        try:
            logits, toks, cache = decode(model, prompt_of(inp, case), split,
                                         dtype=cache_dtype(case))
        finally:
            boundary.set_observer(None)
        shapes = [{k: {n: tuple(t.shape) for n, t in part.items()}
                   for k, part in layer.items()} for layer in cache]
        out[case] = (logits, toks, shapes, calls.calls)
    torch.save(out, io / f"out{world}_{rank}.pt")
    dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], Path(sys.argv[4]))
