"""Training launcher (single device) — the single-device subset of
``repro/launch/train.py``: arch config -> QAT (or FP) model from a seeded
init -> CE train step -> loop over the synthetic loader.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \\
        --steps 100 --batch 8 --seq 256 --task corpus

runs on the card; ``--device cpu --reduced`` runs the small config on the
CPU.  Data/tensor parallelism (``--dp/--tp/--pods``) and checkpoints
(``--ckpt-dir/--ckpt-every``) are not ported: the parser rejects them.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.core import quant as Q
from repro_torch.data.loader import DataLoader
from repro_torch.data.synth import get_task
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
    ap.add_argument("--reduced", action="store_true",
                    help="train the smoke-scale config")
    ap.add_argument("--quant", default="qat", choices=["fp", "qat"])
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
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
    t_start = time.time()
    try:
        for i in range(args.steps):
            batch = {k: torch.from_numpy(v).to(device)
                     for k, v in loader.next().items()
                     if k in ("tokens", "labels", "loss_mask")}
            state, metrics = step_fn(state, batch)
            if i % args.log_every == 0 or i == args.steps - 1:
                m = {k: float(v) for k, v in metrics.items()}
                print(f"step {i}  loss {m['loss']:.4f}  grad_norm "
                      f"{m['grad_norm']:.3f}  lr {m['lr']:.2e}  "
                      f"({time.time() - t_start:.1f}s)", flush=True)
    finally:
        loader.stop_prefetch()
    print("done")


if __name__ == "__main__":
    main()
