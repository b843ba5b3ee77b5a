"""End-to-end run on the PyTorch port: the paper's full three-stage
BitDistill pipeline on a ~1M-param model, a few hundred steps — FP16-SFT
teacher -> SubLN refinement -> continual pre-training -> distillation
fine-tuning -> eval, with the BitNet-SFT baseline for comparison.  The
counterpart of ``examples/bitdistill_pipeline.py``, printing the same lines.

    PYTHONPATH=src python examples_torch/bitdistill_pipeline.py [--steps 250] \\
        [--task sst2-syn] [--device cpu]

The default device is ``cuda``; without a card the script exits non-zero.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.core.distill import DistillConfig
from repro_torch.core.pipeline import BitDistillPipeline, PipelineConfig
from repro_torch.models.base import ModelConfig
from repro_torch.nn.module import resolve_device

CFG = ModelConfig(name="example-100m-proxy", family="dense", vocab=288,
                  d_model=128, n_layers=3, n_heads=4, n_kv_heads=4,
                  head_dim=32, d_ff=256, qk_norm=True,
                  param_dtype="float32", compute_dtype="float32",
                  remat=False, max_seq=64)


def bitdistill(cfg: ModelConfig, device, steps: int = 250,
               task: str = "sst2-syn") -> dict:
    """Teacher, BitNet-SFT baseline, continual pre-training and
    distillation of ``cfg`` for ``steps`` SFT steps (continual
    pre-training: max(40, steps // 4)) on ``task``; prints the example's
    lines and returns their values."""
    pcfg = PipelineConfig(
        task=task, seq_len=40, batch_size=32,
        ct_steps=max(40, steps // 4), sft_steps=steps,
        sft_lr=6e-4, ct_lr=6e-4, log_every=50, eval_batches=8,
        distill=DistillConfig(tau=5.0, lambda_ld=1.0, gamma_ad=10.0,
                              split_heads=2))
    pipe = BitDistillPipeline(cfg, pcfg, device=torch.device(device))

    print("== stage 0: FP16-SFT teacher ==")
    _, tres = pipe.train_teacher(seed=0)
    teacher = pipe.teacher
    t_acc = pipe.eval_accuracy(teacher, quantized=False)
    print(f"teacher acc: {t_acc:.3f}  ({tres.seconds:.0f}s)")

    print("== baseline: BitNet-SFT (no CT, no KD) ==")
    s0 = pipe.refine(teacher)
    s_sft, _ = pipe.bitnet_sft(s0)
    sft_acc = pipe.eval_accuracy(s_sft, quantized=True)
    print(f"bitnet-sft acc: {sft_acc:.3f}")

    print("== stage 2: continual pre-training ==")
    # the port's stages train their model in place: the baseline trained
    # s0, so the pipeline refines the teacher again (the same student)
    s_ct, ctres = pipe.continue_pretrain(pipe.refine(teacher))
    print(f"ct loss: {ctres.metrics_history[0]['loss']:.3f} -> "
          f"{ctres.final_loss:.3f}")

    print("== stage 3: distillation fine-tuning (CE + λ·LD + γ·AD) ==")
    s_bd, dres = pipe.distill_finetune(s_ct, teacher)
    bd_acc = pipe.eval_accuracy(s_bd, quantized=True)

    print("\n== results ==")
    print(f"{'FP16-SFT (teacher)':24s} {t_acc:.3f}")
    print(f"{'BitNet-SFT':24s} {sft_acc:.3f}")
    print(f"{'BitDistill (ours)':24s} {bd_acc:.3f}")
    print(f"gap closed: {bd_acc - sft_acc:+.3f} "
          f"(teacher gap remaining: {t_acc - bd_acc:+.3f})")
    return {"steps": steps, "task": task, "teacher_acc": t_acc,
            "teacher_seconds": tres.seconds, "bitnet_sft_acc": sft_acc,
            "ct_loss_first": ctres.metrics_history[0]["loss"],
            "ct_loss_final": ctres.final_loss, "bitdistill_acc": bd_acc,
            "distill_loss_final": dres.final_loss}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=250)
    ap.add_argument("--task", default="sst2-syn")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain paths)")
    args = ap.parse_args(argv)
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        raise SystemExit(f"bitdistill_pipeline.py: {e}") from None
    return bitdistill(CFG, device, args.steps, args.task)


if __name__ == "__main__":
    main()
