"""Continuous-batching serving of a 1.58-bit student with 2-bit-packed
ternary weights, on the PyTorch port: the counterpart of
``examples/serve_batch.py``, printing the same lines.

Trains a tiny student on the summarization task first (so generations are
meaningful), converts it to the packed serving artifact, then serves requests
through the continuous-batching engine: half the requests are submitted up
front and the rest are injected mid-flight, with tokens streamed as they are
generated.  Reports tokens/s + weight-memory ratio.  On the card the packed
projections run the w2a8 kernel and attention the paged kernels (head_dim
32); on the CPU their plain versions.

    PYTHONPATH=src python examples_torch/serve_batch.py [--steps 200] [--device cpu]

The default device is ``cuda``; without a card the script exits non-zero.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.distill import DistillConfig
from repro_torch.core.pipeline import BitDistillPipeline, PipelineConfig
from repro_torch.data.synth import get_task
from repro_torch.models import CausalLM
from repro_torch.models.base import ModelConfig
from repro_torch.nn.module import resolve_device, tree_bytes
from repro_torch.serving.api import SamplingParams
from repro_torch.serving.engine import Engine, ServeConfig, convert_to_packed

CFG = ModelConfig(name="serve-demo", family="dense", vocab=288, d_model=128,
                  n_layers=3, n_heads=4, n_kv_heads=4, head_dim=32, d_ff=256,
                  param_dtype="float32", compute_dtype="float32",
                  remat=False, max_seq=96)


def distill_student(cfg: ModelConfig, device, steps: int = 200
                    ) -> Tuple[ModelConfig, CausalLM]:
    """The FP teacher trained ``steps`` steps on cnndm-syn from a seeded init
    (generator 0), refined into a QAT student and distilled ``steps``
    steps: (the student's config, the student)."""
    pcfg = PipelineConfig(task="cnndm-syn", seq_len=72, batch_size=32,
                          ct_steps=40, sft_steps=steps, sft_lr=6e-4,
                          log_every=50,
                          distill=DistillConfig(lambda_ld=1.0, gamma_ad=10.0,
                                                split_heads=2))
    pipe = BitDistillPipeline(cfg, pcfg, device=torch.device(device))
    pipe.train_teacher(seed=0)
    s_bd, _ = pipe.distill_finetune(pipe.refine(pipe.teacher), pipe.teacher)
    return pipe.student_config(), s_bd


def cnndm_prompts(n: int = 8, seed: int = 0) -> List[List[int]]:
    """``n`` cnndm-syn documents from ``np.random.default_rng(seed)``, each
    as BOS + doc + SEP."""
    task = get_task("cnndm-syn")
    rng = np.random.default_rng(seed)
    prompts = []
    for _ in range(n):
        doc, _ = task.sample(rng, 72)
        prompts.append([task.tok.bos_id] + doc + [task.tok.sep_id])
    return prompts


def serve(qat_cfg: ModelConfig, student: CausalLM, prompts: Sequence[List[int]],
          max_tokens: int = 10, use_kernel: bool = True, attn_impl: str = "auto",
          cache_dtype: str = "float32", ignore_eos: bool = False) -> dict:
    """``student`` converted to the packed serving model (``use_kernel``: the
    w2a8 kernel on the card; the model's device) and served greedily: the
    first half of ``prompts`` submitted up front, the rest injected after
    the first step, ``max_tokens`` each (``max_len`` = longest prompt +
    ``max_tokens``; ``ignore_eos`` keeps a request past EOS, so that every
    one decodes its ``max_tokens``).  Prints the weight bytes and the served line; returns
    them with the engine's steps, every request's tokens and the packed
    model."""
    qat_cfg = qat_cfg.with_quant(dataclasses.replace(qat_cfg.quant,
                                                     use_kernel=use_kernel))
    packed_cfg, packed = convert_to_packed(qat_cfg, student)
    qat_bytes = tree_bytes(student.state_dict())
    packed_bytes = tree_bytes(packed.state_dict())
    print(f"weight bytes: qat fp32 {qat_bytes/2**20:.1f} MiB -> "
          f"packed {packed_bytes/2**20:.1f} MiB")

    task = get_task("cnndm-syn")
    plen = max(len(p) for p in prompts)
    eng = Engine(packed_cfg, packed,
                 ServeConfig(max_batch=4, max_len=plen + max_tokens,
                             eos_id=task.tok.eos_id, attn_impl=attn_impl,
                             cache_dtype=cache_dtype))
    sp = SamplingParams(max_tokens=max_tokens, ignore_eos=ignore_eos)
    half = len(prompts) // 2
    t0 = time.time()
    reqs = [eng.submit(p, sp) for p in prompts[:half]]
    n, steps, injected = 0, 0, False
    while eng.has_pending() or not injected:
        for out in eng.step():
            n += 1 if out.token >= 0 else 0
        steps += 1
        if not injected:   # continuous batching: add load mid-flight
            reqs += [eng.submit(p, sp) for p in prompts[half:]]
            injected = True
    dt = time.time() - t0
    dev = packed.vocab_mask.device
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "the CPU"
    print(f"served {len(reqs)} requests / {n} tokens in {dt:.1f}s "
          f"({n/dt:.1f} tok/s on {where}; {len(prompts) - half} submitted "
          "mid-flight)")
    for r in reqs[:3]:
        print(f"  req {r.uid} [{r.finish_reason.value}]: {r.output_tokens}")
    return {"qat_bytes": qat_bytes, "packed_bytes": packed_bytes,
            "requests": len(reqs), "tokens": n, "steps": steps, "seconds": dt,
            "tok_per_s": n / dt, "device": where, "attn_impl": eng.attn_impl,
            "outputs": [list(r.output_tokens) for r in reqs],
            "finish": [r.finish_reason.value for r in reqs],
            "packed_cfg": packed_cfg, "packed_model": packed}


def serve_batch(cfg: ModelConfig, device, steps: int = 200,
                max_tokens: int = 10) -> dict:
    """The example: :func:`distill_student`, then :func:`serve` of the 8
    :func:`cnndm_prompts`.  Returns what it printed, the QAT student and its
    config and the prompts."""
    print("training teacher + distilling student (a few minutes on CPU)...")
    qat_cfg, student = distill_student(cfg, device, steps)
    prompts = cnndm_prompts()
    out = serve(qat_cfg, student, prompts, max_tokens)
    return dict(out, train_steps=steps, qat_cfg=qat_cfg, student=student,
                prompts=prompts)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=200,
                    help="teacher and distillation steps (the JAX file's 200)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain paths)")
    args = ap.parse_args(argv)
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        raise SystemExit(f"serve_batch.py: {e}") from None
    return serve_batch(CFG, device, args.steps)


if __name__ == "__main__":
    main()
