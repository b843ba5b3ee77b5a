"""One rank of tests/test_torch_dryrun.py's 4-rank gloo job (a script, not a
test module: the test starts four of these).

    python tests/_torch_comm_worker.py RANK WORLD STORE_FILE OUT_DIR

Runs reduced qwen3-0.6b's CE step under a dp 2 x tp 2 plan (the split
route), with fp32 and with int8 moments, one warm step each and one step
under ``CommDebugMode``, and writes the collectives it counted, and those
the split recorded (``tensor_parallel.recording()``), to
``OUT_DIR/comm_<rank>.json``.  Imports torch and the port only.
"""
import json
import sys
from pathlib import Path

import torch
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from torch.distributed.tensor.debug import CommDebugMode  # noqa: E402

from repro_torch.distributed import tensor_parallel as tp  # noqa: E402
from repro_torch.distributed.sharding import ShardingPlan, default_rules  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models import build_model, get_config  # noqa: E402
from repro_torch.training.optimizer import AdamW, AdamWConfig  # noqa: E402
from repro_torch.training.trainer import init_train_state, make_train_step  # noqa: E402

ROWS, SEQ = 4, 16


def main(rank: int, world: int, store: str, out: Path) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=world)
    plan = ShardingPlan(make_mesh(2, 2), default_rules(False))
    cfg = get_config("qwen3-0.6b").reduced()
    batch = {"tokens": torch.zeros((ROWS, SEQ), dtype=torch.int32),
             "labels": torch.zeros((ROWS, SEQ), dtype=torch.int32),
             "loss_mask": torch.ones((ROWS, SEQ))}
    counts, recorded = {}, {}
    for state_dtype in ("float32", "int8_blockwise"):
        model = build_model(cfg, gen=torch.Generator().manual_seed(0), device="cpu")
        opt = AdamW(AdamWConfig(state_dtype=state_dtype))
        state = init_train_state(model, opt, plan)
        step = make_train_step(model, opt, lambda s: torch.tensor(1e-4), plan=plan)
        state, _ = step(state, batch)
        with CommDebugMode() as comm, tp.recording() as rec:
            step(state, batch)
        counts[state_dtype] = {str(k): v for k, v in comm.get_comm_counts().items()}
        recorded[state_dtype] = rec
    (out / f"comm_{rank}.json").write_text(json.dumps(
        {"counts": counts, "recorded": recorded}))
    dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], Path(sys.argv[4]))
