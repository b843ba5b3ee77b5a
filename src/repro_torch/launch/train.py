"""Training launcher — port of ``repro/launch/train.py``: arch config ->
QAT (or FP) model from a seeded init -> sharding plan -> CE train step ->
fault-tolerant loop over the synthetic loader (async checkpoints,
auto-resume, SIGTERM emergency save, straggler watchdog).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \\
        --steps 100 --batch 8 --seq 256 --task corpus --ckpt-dir /tmp/run1

runs on one card; ``--device cpu --reduced`` runs the small config on the
CPU.  Under ``torch.distributed.run`` (which sets ``RANK``, ``WORLD_SIZE``
and ``LOCAL_RANK``) every rank joins one process group (NCCL on the cards,
one a rank; gloo with ``--device cpu``), and ``--dp/--tp/--pods`` factor
the ranks into the mesh ``make_mesh`` builds; the parameters and moments
are placed by the plan and the step runs sharded (``training/trainer.py``):

    PYTHONPATH=src python -m torch.distributed.run --standalone \\
        --nproc-per-node 2 -m repro_torch.launch.train --arch qwen3-0.6b \\
        --reduced --device cpu --dp 2 --steps 3 --ckpt-dir /tmp/run2

Every rank draws the whole batch from the same loader stream (host 0's)
and takes its rows, so ``--dp 2`` trains on the tokens ``--dp 1`` does.  A
mesh of more ranks than the process group holds (``--dp 2`` alone) raises
``make_mesh``'s ``ValueError``.  Checkpoints go to ``--ckpt-dir`` every
``--ckpt-every`` steps and at the end, in the JAX package's format
(``checkpoint/ckpt.py``, the train state in the JAX ``TrainState`` layout
by ``bridge.py``), written by rank 0 from the leaves gathered whole.  A
directory that holds one resumes from its latest step, whichever package
wrote it and at whatever mesh; SIGTERM saves the state after the running
step (the ranks agree on the step) and exits 0.  The encoder-decoder (``whisper-medium``) and VLM (``llama-3.2-vision-11b``)
configs are refused with a ``ValueError``: the synthetic data pipeline makes
no ``frames`` or ``image_embeds`` (the JAX launcher fails there with a
``KeyError``); their step functions take such batches
(``training/trainer.py::forward``).
"""
from __future__ import annotations

import argparse
import os
import signal
import sys
import time

import torch
import torch.distributed as dist

from repro_torch import bridge
from repro_torch.checkpoint import CheckpointManager, load_checkpoint
from repro_torch.checkpoint.ckpt import latest_step
from repro_torch.core import quant as Q
from repro_torch.data.loader import DataLoader
from repro_torch.data.synth import get_task
from repro_torch.distributed import sharding as shlib
from repro_torch.distributed.elastic import StepWatchdog
from repro_torch.distributed.sharding import ShardingPlan, default_rules
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import build_model
from repro_torch.models.base import get_config
from repro_torch.nn.module import resolve_device
from repro_torch.training.optimizer import AdamW, AdamWConfig
from repro_torch.training.schedule import warmup_cosine
from repro_torch.training.trainer import init_train_state, make_train_step


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--dp", type=int, default=1)
    ap.add_argument("--tp", type=int, default=1)
    ap.add_argument("--pods", type=int, default=1)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--task", default="corpus")
    ap.add_argument("--ckpt-dir", default="/tmp/repro_ckpt")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--reduced", action="store_true",
                    help="train the smoke-scale config")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the config to this many layers (a multiple of "
                         "its pattern length): its width at less depth")
    ap.add_argument("--quant", default="qat", choices=["fp", "qat"])
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if cfg.n_encoder_layers > 0 or any(s.mixer in ("cross", "attn_cross")
                                       for s in cfg.resolved_pattern()):
        raise ValueError(
            f"--arch {args.arch}: the model reads "
            + ("audio frames ('frames')" if cfg.n_encoder_layers > 0
               else "image embeddings ('image_embeds')")
            + ", and the data pipeline makes no frames or image_embeds; "
            "train it through training/trainer.py's step functions with "
            "batches that hold them")
    if args.reduced:
        cfg = cfg.reduced()
    if args.layers is not None:
        cfg = cfg.replace(n_layers=args.layers)
    if args.quant == "qat":
        cfg = cfg.with_quant(Q.QAT)
    cfg = cfg.replace(max_seq=max(cfg.max_seq, args.seq))

    rank, world = 0, 1
    if "WORLD_SIZE" in os.environ:       # started by torch.distributed.run
        if device.type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
            device = torch.device("cuda", torch.cuda.current_device())
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo")
        rank, world = dist.get_rank(), dist.get_world_size()
    say = print if rank == 0 else (lambda *a, **k: None)
    try:
        plan = None
        if dist.is_initialized() or args.dp * args.tp * args.pods != 1:
            # raises unless pods x dp x tp is the process group's size
            mesh = make_mesh(args.dp, args.tp, args.pods, device.type)
            plan = ShardingPlan(mesh, default_rules(args.pods > 1))
        _train(args, cfg, device, plan, rank, world, say)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    say("done")


def _train(args, cfg, device, plan, rank: int, world: int, say) -> None:
    model = build_model(cfg, gen=torch.Generator(device=device).manual_seed(0),
                        device=device)
    opt = AdamW(AdamWConfig())
    lr_fn = lambda s: warmup_cosine(s, args.lr, min(20, args.steps // 10 + 1),
                                    args.steps)
    state = init_train_state(model, opt, plan)
    step_fn = make_train_step(model, opt, lr_fn, plan=plan)
    # every rank draws host 0's stream, the whole batch (the step splits it)
    loader = DataLoader(get_task(args.task), args.batch, args.seq)
    mgr = CheckpointManager(args.ckpt_dir, save_every=args.ckpt_every)
    watchdog = StepWatchdog()

    # ---- init or resume ------------------------------------------------------
    if latest_step(args.ckpt_dir) is not None:
        tmpl = bridge.train_state_to_jax(cfg, state, device="meta")
        restored, extra, start = load_checkpoint(args.ckpt_dir, tmpl, device=device)
        bridge.load_train_state(cfg, restored, state)   # each rank its share
        del restored
        loader.load_state_dict(extra.get("loader", {"step": 0}))
        say(f"[resume] from step {start}", flush=True)
    else:
        start = 0

    stop = {"now": False}

    def on_term(sig, frm):
        stop["now"] = True
    prev_handler = signal.signal(signal.SIGTERM, on_term)

    def stopping() -> bool:
        """Whether any rank was sent SIGTERM: the ranks stop after the same
        step, since saving gathers the state from all of them."""
        if world == 1:
            return stop["now"]
        flag = torch.tensor([float(stop["now"])], device=device)
        dist.all_reduce(flag, op=dist.ReduceOp.MAX)
        return bool(flag.item())

    def save(step: int, sync: bool) -> None:
        tree = bridge.train_state_to_jax(cfg, state)     # gathered on every rank
        if rank == 0:
            (mgr.emergency_save if sync else mgr.save_async)(
                step, tree, extra={"loader": loader.state_dict()})

    shlib.set_plan(plan)
    loader.start_prefetch()
    t_start = time.time()
    try:
        for i in range(start, args.steps):
            watchdog.start()
            batch = {k: torch.from_numpy(v).to(device)
                     for k, v in loader.next().items()
                     if k in ("tokens", "labels", "loss_mask")}
            state, metrics = step_fn(state, batch)
            if device.type == "cuda":
                torch.cuda.synchronize(device)   # the watchdog times the step
            flag = watchdog.stop()
            if flag:
                print(f"[straggler] step {flag.step}: {flag.duration:.3f}s "
                      f"(median {flag.median:.3f}s)", flush=True)   # any rank
            if i % args.log_every == 0 or i == args.steps - 1:
                m = {k: float(v) for k, v in metrics.items()}
                say(f"step {i}  loss {m['loss']:.4f}  loss_moe "
                    f"{m['loss_moe']:.4f}  grad_norm {m['grad_norm']:.3f}  "
                    f"lr {m['lr']:.2e}  ({time.time() - t_start:.1f}s)",
                    flush=True)
            if mgr.should_save(i + 1):
                save(i + 1, sync=False)
            if stopping():
                say("[sigterm] emergency checkpoint", flush=True)
                save(i + 1, sync=True)
                sys.exit(0)
        mgr.wait()
        save(args.steps, sync=True)
    finally:
        shlib.set_plan(None)
        signal.signal(signal.SIGTERM, prev_handler)
        loader.stop_prefetch()


if __name__ == "__main__":
    main()
