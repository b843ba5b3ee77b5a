"""Distillation cells: BitDistill stage 3 through the port's
``training/trainer.py::make_distill_step``: the full-precision teacher, the
QAT student after refine (SubLN) on the bitlinear kernel
(``QuantConfig(use_kernel=True)``), the relation loss on its kernel
(``DistillConfig(use_kernel=True)``), ``training/optimizer.py::AdamW``.

Set-up builds the one step object (student, teacher, optimizer state) from
the seed's master weights and drives it through its first
``traffic["checked_steps"]`` steps on batches of rows that all differ;
those steps are the warm-up, and what they left (each step's loss terms,
the first gradient as the optimizer got it, each tensor's change) is kept.
The same object then runs the window: each step ends at a synchronize, the
window closes at the end of the first step that ends past ``--seconds``.
After the window the reference (``reference/train.py``) follows the
checked steps from the same master weights and batches."""
from __future__ import annotations

import gc
import time
from typing import Dict

import torch

from harness.context import Context, port_config
from harness.record import Run
from harness.traffic import DistillFeed
from harness.weights import model_weights


def build(ctx: Context):
    from repro_torch.core import quant as Q
    from repro_torch.core.distill import DistillConfig
    from repro_torch.models import build_model
    from repro_torch.training.optimizer import AdamW, AdamWConfig
    from repro_torch.training.trainer import (default_distill_layer, init_train_state,
                                              make_distill_step)
    dev = torch.device(ctx.device)
    if dev.type == "cuda":
        from repro_torch.kernels.build import build as build_kernels
        build_kernels()                 # a checkout's first run compiles here
    cfg, tr = ctx.config, ctx.traffic
    base = port_config(cfg)
    teacher_w, student_w = model_weights(cfg, ctx.seed, dev)
    teacher = build_model(base, device=dev)
    teacher.load_state_dict(teacher_w, strict=True)
    teacher.requires_grad_(False)
    scfg = base.with_quant(Q.QuantConfig(mode="qat", use_kernel=True))
    student = build_model(scfg, device=dev)
    student.load_state_dict(student_w, strict=True)
    d = tr["distill"]
    kw = dict(tau=float(d["tau"]), lambda_ld=float(d["lambda_ld"]),
              gamma_ad=float(d["gamma_ad"]), split_heads=int(d["split_heads"]),
              relation_temperature=float(d["relation_temperature"]), use_kernel=True)
    if cfg["family"] == "dense":
        layer = default_distill_layer(scfg)
        dcfg = DistillConfig(distill_layer=layer, **kw)
        d["distill_layer"] = layer
    else:
        dcfg = DistillConfig(use_ad=False, **kw)
        d["use_ad"] = False
    o = tr["optimizer"]
    opt = AdamW(AdamWConfig(b1=o["b1"], b2=o["b2"], eps=o["eps"],
                            weight_decay=o["weight_decay"], grad_clip=o["grad_clip"]))
    state = init_train_state(student, opt)
    lr = float(o["lr"])
    step = make_distill_step(student, teacher, opt, lambda s: lr, dcfg,
                             accum=int(tr.get("accum", 1)))
    return step, state, teacher_w, student_w


def _norms(ts: Dict[str, torch.Tensor], scale: float = 1.0) -> Dict[str, float]:
    names = list(ts)
    vals = torch.stack([torch.linalg.vector_norm(ts[k].detach().float()) for k in names])
    return dict(zip(names, (vals * scale).tolist()))


def run(ctx: Context) -> None:
    cfg, tr = ctx.config, ctx.traffic
    vocab = cfg["vocab_size"]
    step, state, teacher_w, student_w = build(ctx)
    run = Run(ctx.cell.name, cfg, tr, ctx.seconds, trace=ctx.trace)
    ctx.run = run
    if cfg["family"] == "dense":
        d = tr["distill"]
        width = cfg["num_attention_heads"] * cfg["head_dim"] // int(d["split_heads"])
        run.extra["relation"] = (int(d["split_heads"]), width)
    feed = DistillFeed(tr, vocab, ctx.seed, ctx.device)
    tokens = int(tr["batch"]) * int(tr["seq"])
    checked, prog_losses = [], []
    first = None
    b1 = float(tr["optimizer"]["b1"])
    for i in range(int(tr["checked_steps"])):
        batch = feed.next()
        checked.append(batch)
        state, m = step(state, batch)
        prog_losses.append({k: float(v) for k, v in m.items() if k.startswith("loss")})
        if first is None:
            first = _norms(state.opt_state.m, 1.0 / (1.0 - b1))
    change = {k: float(torch.linalg.vector_norm(state.params[k].detach() - student_w[k]))
              for k in student_w}
    ctx.sync()
    from repro_torch.kernels import boundary
    if ctx.trace:
        boundary.set_observer(run.kernels)
        run.device.start(ctx.device)
        run.kernels.recording = True
    run.t_open = time.perf_counter()
    run.setup_s = run.t_open - ctx.t_start
    end = run.t_open
    while end < run.t_open + ctx.seconds:
        batch = feed.next()
        t0 = time.perf_counter()
        state, _ = step(state, batch)
        ctx.sync()
        end = time.perf_counter()
        run.spans.add("trainer.step", t0, end)
        run.steps.append({"start": t0, "end": end, "tokens": tokens})
    run.t_close = end
    if ctx.trace:
        run.kernels.recording = False
        run.device.stop(run.t_open, run.t_close, ctx.device)
        boundary.set_observer(None)
    ctx.readings["window_step_ms"] = [round((x["end"] - x["start"]) * 1e3, 1)
                                      for x in run.steps]
    ctx.attempted = len(run.steps) + len(checked)
    ctx.failed = 0
    if ctx.device == "cuda":
        ctx.memory_peak_bytes = torch.cuda.max_memory_allocated()
    del step, state
    gc.collect()
    if ctx.device == "cuda":
        torch.cuda.empty_cache()
    judge(ctx, teacher_w, student_w, checked, prog_losses, first, change)


def judge(ctx: Context, teacher_w, student_w, batches, prog_losses, first, change):
    from reference import train
    ref = train.steps(ctx.config, ctx.traffic, teacher_w, student_w, batches)
    numbers, where = train.compare(prog_losses, first, change, ref)
    for name, value in numbers.items():
        ctx.check(name, value)
    ctx.readings.update(where, losses_program=prog_losses,
                        losses_reference=ref["losses"])
