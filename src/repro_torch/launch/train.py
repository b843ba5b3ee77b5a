"""Training launcher (single device) — the single-device subset of
``repro/launch/train.py``: arch config -> QAT (or FP) model from a seeded
init -> CE train step -> fault-tolerant loop over the synthetic loader
(async checkpoints, auto-resume, SIGTERM emergency save, straggler
watchdog).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \\
        --steps 100 --batch 8 --seq 256 --task corpus --ckpt-dir /tmp/run1

runs on the card; ``--device cpu --reduced`` runs the small config on the
CPU.  Checkpoints go to ``--ckpt-dir`` every ``--ckpt-every`` steps and at
the end, in the JAX package's format (``checkpoint/ckpt.py``, the train
state in the JAX ``TrainState`` layout by ``bridge.py``).  A directory that
holds one resumes from its latest step, whichever package wrote it; SIGTERM
saves the state after the running step and exits 0.  Data/tensor
parallelism (``--dp/--tp/--pods``) is not ported: the parser rejects it.
The encoder-decoder (``whisper-medium``) and VLM (``llama-3.2-vision-11b``)
configs are refused with a ``ValueError``: the synthetic data pipeline makes
no ``frames`` or ``image_embeds`` (the JAX launcher fails there with a
``KeyError``); their step functions take such batches
(``training/trainer.py::forward``).
"""
from __future__ import annotations

import argparse
import signal
import sys
import time

import torch

from repro_torch import bridge
from repro_torch.checkpoint import CheckpointManager, load_checkpoint
from repro_torch.checkpoint.ckpt import latest_step
from repro_torch.core import quant as Q
from repro_torch.data.loader import DataLoader
from repro_torch.data.synth import get_task
from repro_torch.distributed.elastic import StepWatchdog
from repro_torch.models import build_model
from repro_torch.models.base import get_config
from repro_torch.nn.module import resolve_device
from repro_torch.training.optimizer import AdamW, AdamWConfig
from repro_torch.training.schedule import warmup_cosine
from repro_torch.training.trainer import init_train_state, make_train_step


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
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

    model = build_model(cfg, gen=torch.Generator(device=device).manual_seed(0),
                        device=device)
    opt = AdamW(AdamWConfig())
    lr_fn = lambda s: warmup_cosine(s, args.lr, min(20, args.steps // 10 + 1),
                                    args.steps)
    step_fn = make_train_step(model, opt, lr_fn)
    state = init_train_state(model, opt)
    loader = DataLoader(get_task(args.task), args.batch, args.seq)
    loader.start_prefetch()
    mgr = CheckpointManager(args.ckpt_dir, save_every=args.ckpt_every)
    watchdog = StepWatchdog()

    # ---- init or resume ------------------------------------------------------
    if latest_step(args.ckpt_dir) is not None:
        tmpl = bridge.train_state_to_jax(cfg, state, device="meta")
        restored, extra, start = load_checkpoint(args.ckpt_dir, tmpl, device=device)
        bridge.load_train_state(cfg, restored, state)
        del restored
        loader.load_state_dict(extra.get("loader", {"step": 0}))
        print(f"[resume] from step {start}", flush=True)
    else:
        start = 0

    stop = {"now": False}

    def on_term(sig, frm):
        stop["now"] = True
    prev_handler = signal.signal(signal.SIGTERM, on_term)

    def tree():
        return bridge.train_state_to_jax(cfg, state)

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
                      f"(median {flag.median:.3f}s)", flush=True)
            if i % args.log_every == 0 or i == args.steps - 1:
                m = {k: float(v) for k, v in metrics.items()}
                print(f"step {i}  loss {m['loss']:.4f}  loss_moe "
                      f"{m['loss_moe']:.4f}  grad_norm {m['grad_norm']:.3f}  "
                      f"lr {m['lr']:.2e}  ({time.time() - t_start:.1f}s)",
                      flush=True)
            if mgr.should_save(i + 1):
                mgr.save_async(i + 1, tree(),
                               extra={"loader": loader.state_dict()})
            if stop["now"]:
                print("[sigterm] emergency checkpoint", flush=True)
                mgr.emergency_save(i + 1, tree(),
                                   extra={"loader": loader.state_dict()})
                sys.exit(0)
        mgr.wait()
        mgr.emergency_save(args.steps, tree(),
                           extra={"loader": loader.state_dict()})
    finally:
        signal.signal(signal.SIGTERM, prev_handler)
        loader.stop_prefetch()
    print("done")


if __name__ == "__main__":
    main()
