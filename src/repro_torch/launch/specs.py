"""Dry-run cells — port of ``repro/launch/specs.py``: meta-device
inputs and a per-rank step for each (architecture x shape x mesh x step
kind).  Nothing is allocated: the model, its optimizer state, the caches
and the batch are meta tensors, and ``launch/op_analysis.count`` runs the
step on them.

Where JAX lowers the whole SPMD program over a mesh of devices, a port cell
is what ONE rank of that mesh computes, as the port computes it:

* a train step takes the rank's rows of the global batch (split over the
  mesh axes of the ``"batch"`` rule) with every parameter gathered whole,
  and updates the rank's share of each parameter and moment
  (``training/trainer.py::_sharded_train_step``); the plan's collectives
  are counted apart (``roofline.plan_collectives``);
* a prefill step is the forward over the rank's rows, a decode step
  ``decode_step`` of one token against a ``seq``-long contiguous cache of
  the rank's rows, as in JAX; the serving engine takes no plan, so the
  rank holds the whole model.

The plan resolves against ``launch/mesh.py::make_production_mesh()`` (a
shape only: 16 x 16, or 2 x 16 x 16).  The model is built with
``build_model(cfg, device="meta")``, not under a global ``torch.device``
context, since attention computes its scale on a host tensor.  A variant
or a step the port cannot take raises a ``ValueError`` that names it.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs.shapes import SHAPES, ShapeSpec
from repro_torch.core import quant as Q
from repro_torch.core.distill import softmax_cross_entropy
from repro_torch.distributed.sharding import ShardingPlan, default_rules
from repro_torch.models import build_model
from repro_torch.models.base import ModelConfig, get_config
from repro_torch.models.encdec import EncDecLM
from repro_torch.training.optimizer import AdamW, AdamWConfig
from repro_torch.training.trainer import (TrainState, _accumulate, forward,
                                          jax_ranks)

META = torch.device("meta")

# archs whose param+optimizer footprint takes the 8-bit optimizer (JAX's
# list: DESIGN.md §8)
BIG = ("mistral-large-123b", "grok-1-314b", "jamba-1.5-large-398b")

# §Perf hillclimb variants (JAX's).  Each = (rules_overrides, model_overrides).
# Composable by "+" in the tag: e.g. "dp_zero3+bf16s+flash".
VARIANTS = {
    # pure data parallel over all 256/512 chips with ZeRO-3 parameter
    # sharding
    "dp_zero3": (
        {"batch": (("pod", "data", "model"), ("data", "model"), ("data",), ()),
         "heads": ((),), "kv_heads": ((),), "mlp": ((),), "vocab": ((),),
         "expert": ((),), "ssm_inner": ((),), "ssm_heads": ((),),
         "ssm_in": ((),), "ssm_conv": ((),), "kv_seq": ((),),
         "embed": (("data", "model"), ("data",), ())},
        {}),
    # bf16 attention scores (fp32 softmax accumulation retained)
    "bf16s": ({}, {"attn_scores_dtype": "bfloat16"}),
    # blocked attention (never materializes SxT)
    "flash": ({}, {"attn_impl": "blocked"}),
    # Megatron-SP: inter-layer residuals sequence-sharded over `model`
    "sp": ({"seq_sp": (("model",), ())}, {}),
    # store master weights bf16
    "bf16p": ({}, {"param_dtype": "bfloat16"}),
    # packed 2-bit ternary weights (decode cells)
    "packed": ({}, {"__packed__": True}),
    # bf16-elementwise quantizer math
    "lpq": ({}, {"__lpq__": True}),
    # inference weight placement: TP over `model` only
    "infer_repl": ({"embed": ((),)}, {}),
    # bf16 parameters at inference
    "bf16w": ({}, {"param_dtype": "bfloat16"}),
    # SSD chunk sweep
    "ssdq128": ({}, {"ssm_chunk": 128}),
    "ssdq64": ({}, {"ssm_chunk": 64}),
}


def resolve_variants(tag: str):
    rules: Dict = {}
    model: Dict = {}
    for part in [p for p in tag.split("+") if p]:
        if part not in VARIANTS:
            raise ValueError(f"unknown variant {part!r}; known: {sorted(VARIANTS)}")
        r, m = VARIANTS[part]
        rules.update(r)
        model.update(m)
    return rules, model


def student_config(cfg: ModelConfig, use_kernels: bool = False,
                   packed: bool = False) -> ModelConfig:
    """The BitDistill student: QAT BitLinear + SubLN, bf16 activations,
    padded vocab for TP logits.  packed=True -> 2-bit serving weights;
    use_kernels=True -> the hand-written kernels' wrappers (counted at
    their boundary)."""
    mode = "packed" if packed else "qat"
    q = Q.QuantConfig(mode=mode, use_kernel=use_kernels)
    return cfg.with_quant(q).replace(vocab_pad_multiple=512)


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def input_structs(cfg: ModelConfig, shape: ShapeSpec,
                  rows: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """Meta stand-ins for every model input of ``shape`` (``rows`` rows of
    it: a rank's; default the global batch)."""
    b, s = (shape.global_batch if rows is None else rows), shape.seq
    if shape.kind == "train":
        batch: Dict[str, torch.Tensor] = {
            "tokens": _meta((b, s), torch.int32),
            "labels": _meta((b, s), torch.int32),
            "loss_mask": _meta((b, s), torch.float32),
        }
    elif shape.kind == "prefill":
        batch = {"tokens": _meta((b, s), torch.int32)}
    else:  # decode
        batch = {"token": _meta((b,), torch.int32)}
    if cfg.family == "vlm" and shape.kind != "decode":
        batch["image_embeds"] = _meta((b, cfg.num_image_tokens, cfg.d_model),
                                      torch.bfloat16)
    if cfg.family == "audio" and shape.kind != "decode":
        batch["frames"] = _meta((b, cfg.encoder_seq, cfg.d_model), torch.bfloat16)
    return batch


# spec-mandated name: meta stand-ins for every model input
input_specs = input_structs


def batch_axes(batch: Dict[str, Any]) -> Dict[str, Tuple]:
    ax = {}
    for k in batch:
        if k in ("tokens", "labels", "loss_mask"):
            ax[k] = ("batch", "seq")
        elif k == "token":
            ax[k] = ("batch",)
        else:  # image_embeds / frames
            ax[k] = ("batch", "seq", "act_embed")
    return ax


@dataclasses.dataclass
class Cell:
    """Everything needed to count one dry-run cell (one rank's step)."""
    arch: str
    shape: ShapeSpec
    step_kind: str                  # train | prefill | decode | distill
    step_fn: Callable
    args: Tuple                     # meta tensors and states
    plan: ShardingPlan
    model_cfg: ModelConfig
    model: Any                      # the whole model, on meta
    dp: int                         # ranks the batch is split over
    rows: int                       # the rank's batch rows
    opt_8bit: bool = False
    accum: int = 1

    @property
    def n_devices(self) -> int:
        n = 1
        for v in self.plan.shape.values():
            n *= v
        return n

    @property
    def tp(self) -> int:
        return max(1, self.n_devices // self.dp)


def _shard(t: torch.Tensor, spec, shape: Dict[str, int]) -> torch.Tensor:
    """The first rank's share of ``t`` under ``spec`` (a view)."""
    for d, axes in enumerate(spec):
        n = 1
        for a in axes:
            n *= shape[a]
        if n > 1:
            t = t.narrow(d, 0, t.shape[d] // n)
    return t


def _rank_train_step(model, opt: AdamW, accum: int, specs, mesh_shape):
    """One rank's CE step: forward and backward on its rows with the whole
    model, then the update of its share of each parameter and moment."""
    whole = dict(model.named_parameters())

    def loss_fn(mb):
        logits, _, moe = forward(model, mb)
        ce = softmax_cross_entropy(logits, mb["labels"], mb.get("loss_mask"))
        return ce + moe, {"loss_ce": ce, "loss_moe": moe}

    def step(state: TrainState, batch):
        loss, metrics, grads = _accumulate(TrainState(whole, None, 0), batch,
                                           accum, loss_fn)
        local = {k: _shard(g, specs[k], mesh_shape) for k, g in grads.items()}
        lr = torch.tensor(1e-4, dtype=torch.float32)
        _, state.opt_state, opt_metrics = opt.update(local, state.opt_state,
                                                     state.params, lr)
        state.step += 1
        return state, dict(metrics, loss=loss, **opt_metrics)

    return step


def build_cell(arch: str, shape_name: str, mesh, step_override: Optional[str] = None,
               rules_overrides: Optional[Dict] = None,
               model_overrides: Optional[Dict] = None,
               remat_policy: Optional[str] = None,
               accum: int = 1, use_kernels: bool = False) -> Cell:
    """``mesh`` is ``{axis: size}`` (``make_production_mesh()``)."""
    base = get_config(arch)
    shape = SHAPES[shape_name]
    multi_pod = "pod" in mesh
    rules = default_rules(multi_pod)
    if rules_overrides:
        rules.update(rules_overrides)
    plan = ShardingPlan(dict(mesh), rules)

    mo = dict(model_overrides or {})
    packed = bool(mo.pop("__packed__", False))
    lpq = bool(mo.pop("__lpq__", False))
    cfg = student_config(base, use_kernels=use_kernels, packed=packed)
    if lpq:
        cfg = cfg.replace(quant=dataclasses.replace(
            cfg.quant, low_precision_quant=True))
    try:
        if mo:
            cfg = cfg.replace(**mo)
        if remat_policy is not None:
            cfg = cfg.replace(remat_policy=remat_policy)
    except TypeError as e:
        raise ValueError(f"the port's ModelConfig takes no {sorted(mo)} "
                         f"({e})") from e
    step_kind = step_override or shape.kind
    if step_kind == "distill" and len(plan.shape) and any(
            v > 1 for v in plan.shape.values()):
        raise ValueError(
            "step 'distill' under a sharding plan: the port's distill step "
            "takes no plan (training/trainer.py::make_distill_step)")
    if step_kind in ("train", "distill") and shape.kind != "train":
        raise ValueError(f"step {step_kind!r} needs a train shape, not "
                         f"{shape_name!r} ({shape.kind})")
    model = build_model(cfg, device=META)

    # the rank's rows: the global batch split as the plan places its inputs
    first, struct = next(iter(input_structs(cfg, shape).items()))
    dp = 1
    for a in plan.spec(batch_axes({first: struct})[first], struct.shape)[0]:
        dp *= plan.shape[a]
    rows = shape.global_batch // dp
    batch = input_structs(cfg, shape, rows)
    opt_8bit = arch in BIG

    if step_kind in ("train", "distill"):
        if rows % accum:
            raise ValueError(f"accum={accum} does not divide the rank's "
                             f"{rows} rows")
        params = dict(model.named_parameters())
        axes = model.param_axes()
        specs = {k: plan.spec(axes[k], tuple(p.shape)) for k, p in params.items()}
        local = {k: _meta(_shard(p, specs[k], plan.shape).shape, p.dtype)
                 for k, p in params.items()}
        opt = AdamW(AdamWConfig(
            state_dtype="int8_blockwise" if opt_8bit else "float32"))
        state = TrainState(local, opt.init(local, jax_ranks(params)), 0)
        fn = _rank_train_step(model, opt, accum, specs, plan.shape)
        return Cell(arch, shape, step_kind, fn, (state, batch), plan, cfg,
                    model, dp, rows, opt_8bit, accum)

    if step_kind == "prefill":
        @torch.no_grad()
        def prefill_fn(b):
            logits, _, _ = _forward(model, b)
            return logits
        return Cell(arch, shape, step_kind, prefill_fn, (batch,), plan, cfg,
                    model, dp, rows)

    if step_kind != "decode":
        raise ValueError(f"unknown step {step_kind!r}")
    # decode: one new token against a seq-long cache
    cache = _init_cache(model, cfg, shape, rows)
    index = _meta((rows,), torch.int32)

    @torch.no_grad()
    def decode_fn(b, cache, index):
        return model.decode_step(b["token"], cache, index)

    return Cell(arch, shape, step_kind, decode_fn, (batch, cache, index), plan,
                cfg, model, dp, rows)


def _forward(model, batch):
    if isinstance(model, EncDecLM):
        return model.apply(batch["frames"], batch["tokens"])
    return model.apply(batch["tokens"], memory=batch.get("image_embeds"))


def _init_cache(model, cfg, shape: ShapeSpec, rows: int):
    """The contiguous cache of ``rows`` rows at ``shape.seq`` (bf16), its
    cross caches seeded from zero frames or image embeddings (JAX's)."""
    with torch.no_grad():
        if cfg.family == "audio":
            frames = _meta((rows, cfg.encoder_seq, cfg.d_model), torch.bfloat16)
            return model.init_cache(rows, shape.seq, torch.bfloat16, META,
                                    frames=frames)
        if cfg.family == "vlm":
            mem = _meta((rows, cfg.num_image_tokens, cfg.d_model), torch.bfloat16)
            return model.init_cache(rows, shape.seq, torch.bfloat16, META,
                                    memory=mem)
        return model.init_cache(rows, shape.seq, torch.bfloat16, META)

