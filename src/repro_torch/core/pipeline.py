"""BitDistill: the paper's three-stage pipeline as one orchestrator — port of
``repro/core/pipeline.py``.

  Stage 1  Modeling refinement — re-architect the FP teacher with SubLN and
           BitLinear (QAT), re-using the teacher's weights (§3.1).
  Stage 2  Continual pre-training — short LM warm-up on generic corpus (§3.2).
  Stage 3  Distillation fine-tuning — CE + λ·logits-KD + γ·attention-relation
           KD against the task-finetuned FP teacher (§3.3).

Also the paper's baselines: FP16-SFT (the teacher itself) and BitNet-SFT
(stage 1 + task SFT only).  Where the JAX pipeline passes parameter trees,
this one passes the models that hold them (``CausalLM``); each stage trains
the model it is given in place and returns it.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple, Union

import torch

from repro_torch.core import quant as Q
from repro_torch.core.distill import DistillConfig
from repro_torch.data.loader import DataLoader
from repro_torch.data.synth import get_task
from repro_torch.data.tokenizer import ByteTokenizer
from repro_torch.models import CausalLM, build_model
from repro_torch.models.base import ModelConfig
from repro_torch.nn.module import resolve_device
from repro_torch.training.optimizer import AdamW, AdamWConfig
from repro_torch.training.schedule import warmup_cosine
from repro_torch.training.trainer import (TrainState, default_distill_layer,
                                          init_train_state, make_distill_step,
                                          make_eval_classify, make_train_step)


@dataclasses.dataclass
class StageResult:
    name: str
    steps: int
    final_loss: float
    metrics_history: List[Dict[str, float]]
    seconds: float


@dataclasses.dataclass
class PipelineConfig:
    task: str = "mnli-syn"
    seq_len: int = 64
    batch_size: int = 32
    seed: int = 0
    # stage 2 (continual pre-training)
    ct_steps: int = 100
    ct_lr: float = 3e-4
    # stage 3 / SFT
    sft_steps: int = 200
    sft_lr: float = 1e-4
    warmup: int = 10
    distill: DistillConfig = dataclasses.field(default_factory=DistillConfig)
    weight_quant_scheme: str = "absmean"
    eval_batches: int = 8
    log_every: int = 25


def _loader(pcfg: PipelineConfig, task_name: str, seed_offset: int = 0) -> DataLoader:
    return DataLoader(get_task(task_name, seed=pcfg.seed),
                      pcfg.batch_size, pcfg.seq_len, seed=pcfg.seed + seed_offset)


def _to_device(batch, device, keys=None):
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()
            if keys is None or k in keys}


def _run_steps(step_fn, state, loader, n_steps, log_every, device):
    hist, t0 = [], time.time()
    loss = float("nan")
    for i in range(n_steps):
        batch = _to_device(loader.next(), device, ("tokens", "labels", "loss_mask"))
        state, metrics = step_fn(state, batch)
        if i % log_every == 0 or i == n_steps - 1:
            m = {k: float(v) for k, v in metrics.items()}
            hist.append(dict(step=i, **m))
            loss = m.get("loss", m.get("loss_ce", float("nan")))
    return state, hist, loss, time.time() - t0


class BitDistillPipeline:
    """End-to-end orchestrator.  All stages share one tokenizer/data
    pipeline and run on ``device`` (default ``cuda``)."""

    def __init__(self, base_cfg: ModelConfig, pcfg: PipelineConfig,
                 device: Union[str, torch.device, None] = None):
        self.tok = ByteTokenizer()
        if base_cfg.vocab < self.tok.vocab_size:
            raise ValueError("config vocab too small for the byte tokenizer")
        self.base_cfg = base_cfg
        self.pcfg = pcfg
        self.device = resolve_device(device)
        self.results: Dict[str, StageResult] = {}

    # -- model constructors ------------------------------------------------------

    def teacher_config(self) -> ModelConfig:
        return self.base_cfg  # FP, no SubLN

    def student_config(self) -> ModelConfig:
        qat = Q.QuantConfig(mode="qat", scheme=self.pcfg.weight_quant_scheme)
        return self.base_cfg.with_quant(qat)   # stage 1: SubLN + BitLinear

    # -- stage 0: FP16-SFT teacher -------------------------------------------------

    def train_teacher(self, seed: Optional[int] = None,
                      model: Optional[CausalLM] = None
                      ) -> Tuple[TrainState, StageResult]:
        """Train a teacher from a seeded init (``seed``, default
        ``pcfg.seed``) or the given ``model``; returns its TrainState.  The
        trained teacher (``model``, or the one built) is ``self.teacher``."""
        cfg, pcfg = self.teacher_config(), self.pcfg
        if model is None:
            gen = torch.Generator(device=self.device).manual_seed(
                pcfg.seed if seed is None else seed)
            model = build_model(cfg, gen=gen, device=self.device)
        self.teacher = model
        opt = AdamW(AdamWConfig(weight_decay=0.01))
        lr = lambda s: warmup_cosine(s, pcfg.sft_lr, pcfg.warmup, pcfg.sft_steps)
        step = make_train_step(model, opt, lr)
        state = init_train_state(model, opt)
        loader = _loader(pcfg, pcfg.task)
        state, hist, loss, secs = _run_steps(step, state, loader, pcfg.sft_steps,
                                             pcfg.log_every, self.device)
        res = StageResult("fp16-sft(teacher)", pcfg.sft_steps, loss, hist, secs)
        self.results["fp16_sft"] = res
        return state, res

    # -- stage 1: modeling refinement ------------------------------------------------

    def refine(self, teacher: CausalLM) -> CausalLM:
        """FP teacher -> QAT student (SubLN scales initialized to 1)."""
        student = build_model(self.student_config(), device=self.device)
        _copy_matching(teacher, student)
        return student

    # -- stage 2: continual pre-training ----------------------------------------------

    def continue_pretrain(self, student: CausalLM, steps: Optional[int] = None
                          ) -> Tuple[CausalLM, StageResult]:
        pcfg = self.pcfg
        steps = pcfg.ct_steps if steps is None else steps
        opt = AdamW(AdamWConfig(weight_decay=0.01))
        lr = lambda s: warmup_cosine(s, pcfg.ct_lr, pcfg.warmup, steps)
        step = make_train_step(student, opt, lr)
        state = init_train_state(student, opt)
        loader = _loader(pcfg, "corpus", seed_offset=17)
        state, hist, loss, secs = _run_steps(step, state, loader, steps,
                                             pcfg.log_every, self.device)
        res = StageResult("continue-pretrain", steps, loss, hist, secs)
        self.results["ct"] = res
        return student, res

    # -- stage 3: distillation fine-tuning ----------------------------------------------

    def distill_finetune(self, student: CausalLM, teacher: CausalLM,
                         dcfg: Optional[DistillConfig] = None
                         ) -> Tuple[CausalLM, StageResult]:
        pcfg = self.pcfg
        dcfg = dcfg or pcfg.distill
        scfg = self.student_config()
        if dcfg.use_ad:
            if scfg.family == "ssm":
                # attention-free -> logits distillation only
                dcfg = dataclasses.replace(dcfg, use_ad=False)
            elif dcfg.distill_layer < 0:
                dcfg = dataclasses.replace(
                    dcfg, distill_layer=default_distill_layer(scfg))
        opt = AdamW(AdamWConfig(weight_decay=0.01))
        lr = lambda s: warmup_cosine(s, pcfg.sft_lr, pcfg.warmup, pcfg.sft_steps)
        step = make_distill_step(student, teacher, opt, lr, dcfg)
        state = init_train_state(student, opt)
        loader = _loader(pcfg, pcfg.task)
        state, hist, loss, secs = _run_steps(step, state, loader, pcfg.sft_steps,
                                             pcfg.log_every, self.device)
        res = StageResult("distill-finetune", pcfg.sft_steps, loss, hist, secs)
        self.results["distill"] = res
        return student, res

    # -- baseline: BitNet-SFT (no CT, no KD) -----------------------------------------------

    def bitnet_sft(self, student: CausalLM) -> Tuple[CausalLM, StageResult]:
        pcfg = self.pcfg
        opt = AdamW(AdamWConfig(weight_decay=0.01))
        lr = lambda s: warmup_cosine(s, pcfg.sft_lr, pcfg.warmup, pcfg.sft_steps)
        step = make_train_step(student, opt, lr)
        state = init_train_state(student, opt)
        loader = _loader(pcfg, pcfg.task)
        state, hist, loss, secs = _run_steps(step, state, loader, pcfg.sft_steps,
                                             pcfg.log_every, self.device)
        res = StageResult("bitnet-sft", pcfg.sft_steps, loss, hist, secs)
        self.results["bitnet_sft"] = res
        return student, res

    # -- eval ------------------------------------------------------------------------------

    def eval_accuracy(self, model: CausalLM, quantized: bool) -> float:
        if model.cfg.quant.is_quantized != quantized:
            raise ValueError(f"quantized={quantized} but the model's quant mode "
                             f"is {model.cfg.quant.mode!r}")
        ev = make_eval_classify(model, self.tok.label_base,
                                get_task(self.pcfg.task).spec.n_classes)
        loader = _loader(self.pcfg, self.pcfg.task, seed_offset=9999)
        accs = [float(ev(_to_device(loader.next(), self.device)))
                for _ in range(self.pcfg.eval_batches)]
        return sum(accs) / len(accs)

    # -- the full pipeline ------------------------------------------------------------------

    def run(self, seed: Optional[int] = None) -> Dict[str, float]:
        tstate, _ = self.train_teacher(seed)
        teacher = self.teacher
        student = self.refine(teacher)
        student, _ = self.continue_pretrain(student)
        student, _ = self.distill_finetune(student, teacher)
        return {
            "teacher_acc": self.eval_accuracy(teacher, quantized=False),
            "bitdistill_acc": self.eval_accuracy(student, quantized=True),
        }


def _copy_matching(src: torch.nn.Module, dst: torch.nn.Module) -> torch.nn.Module:
    """Copy identically named and shaped tensors of ``src`` into ``dst`` (stage-1
    reuse: new SubLN scales keep their init; everything else loads the FP
    weights)."""
    s = src.state_dict()
    with torch.no_grad():
        for name, t in dst.state_dict().items():
            if name in s and s[name].shape == t.shape:
                t.copy_(s[name].to(t.dtype))
    return dst
