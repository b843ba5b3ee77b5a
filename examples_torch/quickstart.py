"""Quickstart on the PyTorch port: convert a (randomly initialized stand-in)
FP model to a 1.58-bit BitDistill student, run one QAT train step, and
inspect the quantized weights.  The port's counterpart of
``examples/quickstart.py``; it prints the same lines.

    PYTHONPATH=src python examples_torch/quickstart.py [--device cpu]

The default device is ``cuda``; without a card the script exits non-zero.
"""
from __future__ import annotations

import argparse
from typing import Dict, Optional

import torch

from repro_torch.core import quant as Q
from repro_torch.models import build_model, get_config
from repro_torch.models.base import ModelConfig
from repro_torch.nn.module import resolve_device
from repro_torch.training.optimizer import AdamW, AdamWConfig
from repro_torch.training.trainer import init_train_state, make_train_step


def random_batch(vocab: int, device) -> Dict[str, torch.Tensor]:
    """The 4 x 32 random CE batch: tokens from generator 1, labels from
    generator 2 (the JAX file's PRNGKeys 1 and 2)."""
    draw = lambda seed: torch.randint(0, vocab, (4, 32), generator=torch.Generator(
        device=device).manual_seed(seed), device=device)
    return {"tokens": draw(1), "labels": draw(2),
            "loss_mask": torch.ones((4, 32), dtype=torch.float32, device=device)}


def quickstart(cfg: ModelConfig, device, model: Optional[torch.nn.Module] = None,
               batch: Optional[Dict[str, torch.Tensor]] = None) -> dict:
    """One QAT step of ``cfg``'s student and layer 0's ``wq`` through the
    quantizer; prints the example's lines and returns their values.
    ``model`` (a QAT student of ``cfg`` on ``device``) and ``batch`` replace
    the seeded init (generator 0) and :func:`random_batch`."""
    device = torch.device(device)
    # 1. an architecture (any of the assigned configs, or qwen3-*), cut to
    #    laptop scale by the caller
    print(f"arch={cfg.name}  layers={cfg.n_layers}  d_model={cfg.d_model}")

    # 2. stage-1 modeling refinement: BitLinear (absmean ternary + int8 acts,
    #    STE) and SubLN before every output projection
    student_cfg = cfg.with_quant(Q.QAT)
    if model is None:
        model = build_model(student_cfg, gen=torch.Generator(device=device).manual_seed(0),
                            device=device)

    # 3. one QAT train step (CE loss on random tokens)
    opt = AdamW(AdamWConfig())
    step = make_train_step(model, opt, lambda s: 1e-4)
    state = init_train_state(model, opt)
    state, metrics = step(state, batch if batch is not None
                          else random_batch(cfg.vocab, device))
    loss, grad_norm = float(metrics["loss"]), float(metrics["grad_norm"])
    print(f"loss={loss:.4f}  grad_norm={grad_norm:.3f}")

    # 4. what the quantizer does to one weight matrix
    w = state.params["stack.layers.0.attn.wq.w"].detach()
    _, delta = Q.weight_quant_absmean(w)
    hist = [int(c) for c in Q.ternary_histogram(w)]
    mass = float(Q.boundary_mass(w))
    print(f"ternary histogram (-1/0/+1): {hist}  delta={float(delta):.5f}")
    print(f"boundary mass: {mass:.4f}")
    print("quickstart OK")
    return {"arch": cfg.name, "layers": cfg.n_layers, "d_model": cfg.d_model,
            "loss": loss, "grad_norm": grad_norm, "histogram": hist,
            "delta": float(delta), "boundary_mass": mass}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain paths)")
    args = ap.parse_args(argv)
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        raise SystemExit(f"quickstart.py: {e}") from None
    # pick an architecture and shrink it to laptop scale
    return quickstart(get_config("qwen2.5-3b").reduced(), device)


if __name__ == "__main__":
    main()
