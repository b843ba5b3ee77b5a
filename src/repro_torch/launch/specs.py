"""Dry-run cells — port of ``repro/launch/specs.py``: meta-device
inputs and a per-rank step for each (architecture x shape x mesh x step
kind).  Nothing is allocated: the model, its optimizer state, the caches
and the batch are meta tensors, and ``launch/op_analysis.count`` runs the
step on them.

Where JAX lowers the whole SPMD program over a mesh of devices, a port cell
is what ONE rank of that mesh computes, as the port computes it:

* a train or distill step takes the rank's rows of the global batch (split
  over the mesh axes of the ``"batch"`` rule) on one of two routes: on
  ``"split"`` (the trainer's, ``training/trainer.py``) the model holds the
  rank's shard of each parameter, each block gathers its own along the
  other axes at its use and computes its heads, ``d_ff`` columns, experts,
  SSM heads and vocabulary slice, and the split's collectives record
  themselves as the step runs; on ``"gathered"`` (``route="gathered"``, for
  comparison) every parameter is gathered whole.  Either way the rank
  updates its share of each parameter and moment, and
  ``roofline.plan_collectives`` counts the plan's collectives.  A distill
  cell's FP teacher is placed and split as the student is (JAX's
  ``t_shardings``);
* a prefill step is the forward over the rank's rows, a decode step
  ``decode_step`` of one token against a ``seq``-long contiguous cache of
  the rank's rows, as in JAX.  On ``"split"`` the rank holds its shard of
  each parameter and packed buffer (JAX's ``p_shardings``) and of the cache
  (placed by the plan from ``model.cache_axes()``: JAX's ``c_shardings``),
  and the split's collectives record themselves; on ``"gathered"`` it
  holds the whole model and every head's cache of its rows.

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
from repro_torch.core.distill import DistillConfig
from repro_torch.distributed import tensor_parallel as tp
from repro_torch.distributed.sharding import ShardingPlan, default_rules
from repro_torch.models import build_model
from repro_torch.models.base import ModelConfig, get_config
from repro_torch.models.encdec import EncDecLM
from repro_torch.training.optimizer import AdamW, AdamWConfig
from repro_torch.training.trainer import (TrainState, _microbatches,
                                          ce_loss_parts, default_distill_layer,
                                          distill_loss_parts, jax_ranks,
                                          make_split)

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
    route: str = "split"            # split | gathered
    teacher: Any = None             # a distill cell's teacher, on meta

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


def _rank_step(model, opt: AdamW, accum: int, parts, dp: int, split,
               shard_grads) -> Callable:
    """One rank's train or distill step: forward and backward of ``parts``
    (the trainer's loss parts) on its rows, under ``split`` (the split
    route) or with the whole model, then the update of its share of each
    parameter and moment (``shard_grads`` cuts a whole gradient to it)."""
    params = dict(model.named_parameters())

    def step(state: TrainState, batch):
        for p in params.values():
            p.grad = None
        rows, seq = batch["tokens"].shape
        den = float(rows * seq * dp)
        keys, vals = None, []
        with tp.activated(split):
            for mb in (_microbatches(batch, accum) if accum > 1 else [batch]):
                loss, m = parts(mb, den, dp)
                loss.backward()
                keys = list(m)
                vals.append(torch.stack([v.detach().to(torch.float32)
                                         for v in m.values()]))
        grads = {k: (p.grad if p.grad is not None else torch.zeros_like(p)) / accum
                 for k, p in params.items()}
        for p in params.values():
            p.grad = None
        metrics = dict(zip(keys, torch.stack(vals).mean(dim=0)))
        lr = torch.tensor(1e-4, dtype=torch.float32)
        _, state.opt_state, opt_metrics = opt.update(
            shard_grads(grads), state.opt_state, state.params, lr)
        state.step += 1
        return state, dict(metrics, **opt_metrics)

    return step


def build_cell(arch: str, shape_name: str, mesh, step_override: Optional[str] = None,
               rules_overrides: Optional[Dict] = None,
               model_overrides: Optional[Dict] = None,
               remat_policy: Optional[str] = None,
               accum: int = 1, use_kernels: bool = False,
               route: str = "split") -> Cell:
    """``mesh`` is ``{axis: size}`` (``make_production_mesh()``).  A cell
    takes the trainer's route (``"split"``), or ``route="gathered"`` (every
    parameter whole on the rank, for comparison)."""
    if route not in ("split", "gathered"):
        raise ValueError(f"route {route!r}: 'split' or 'gathered'")
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
        ranks = jax_ranks(params)
        axes = model.param_axes()
        specs = {k: plan.spec(axes[k], tuple(p.shape)) for k, p in params.items()}
        teacher = None
        if step_kind == "distill":
            # the FP teacher of the same config, frozen (JAX's)
            tcfg = base.replace(vocab_pad_multiple=512, **mo)
            if remat_policy is not None:
                tcfg = tcfg.replace(remat_policy=remat_policy)
            teacher = build_model(tcfg, device=META)
            for p in teacher.parameters():
                p.requires_grad_(False)
            # an attention-free stack distills without the relation loss
            use_ad = cfg.family != "ssm"
            dcfg = DistillConfig(
                distill_layer=default_distill_layer(cfg) if use_ad else -1,
                use_ad=use_ad, use_kernel=use_kernels)
            parts = distill_loss_parts(model, teacher, dcfg)
        else:
            parts = ce_loss_parts(model)
        opt = AdamW(AdamWConfig(
            state_dtype="int8_blockwise" if opt_8bit else "float32"))
        if route == "split":
            for m in (model, teacher):
                if m is not None:
                    tp.shard_model(m, plan)
            split = make_split(plan, *[m for m in (model, teacher) if m is not None],
                               local=True)
            split.batch_axes = tuple(
                plan.spec(("batch", "seq"), (shape.global_batch, shape.seq),
                          record=False)[0])
            local = dict(model.named_parameters())
            fn = _rank_step(model, opt, accum, parts, dp, split, lambda g: g)
        else:
            local = {k: _meta(_shard(p, specs[k], plan.shape).shape, p.dtype)
                     for k, p in params.items()}
            fn = _rank_step(model, opt, accum, parts, dp, None, lambda g: {
                k: _shard(v, specs[k], plan.shape) for k, v in g.items()})
        state = TrainState(local, opt.init(local, ranks), 0)
        return Cell(arch, shape, step_kind, fn, (state, batch), plan, cfg,
                    model, dp, rows, opt_8bit, accum, route, teacher)

    if step_kind not in ("prefill", "decode"):
        raise ValueError(f"unknown step {step_kind!r}")
    split = None
    if route == "split":
        tp.shard_model(model, plan)
        split = make_split(plan, model, local=True)
    if step_kind == "prefill":
        @torch.no_grad()
        def prefill_fn(b):
            with tp.activated(split):
                logits, _, _ = _forward(model, b)
            return logits
        return Cell(arch, shape, step_kind, prefill_fn, (batch,), plan, cfg,
                    model, dp, rows, route=route)

    # decode: one new token against a seq-long cache, the rank's share of it
    # on the split route (placed from the whole batch's)
    if split is None:
        cache = _init_cache(model, cfg, shape, rows)
    else:
        cache = split.place_cache(_init_cache(model, cfg, shape, shape.global_batch,
                                              seed=False), model.cache_axes(), META)
    index = _meta((rows,), torch.int32)

    @torch.no_grad()
    def decode_fn(b, cache, index):
        with tp.activated(split):
            return model.decode_step(b["token"], cache, index)

    return Cell(arch, shape, step_kind, decode_fn, (batch, cache, index), plan,
                cfg, model, dp, rows, route=route)


def _forward(model, batch):
    if isinstance(model, EncDecLM):
        return model.apply(batch["frames"], batch["tokens"])
    return model.apply(batch["tokens"], memory=batch.get("image_embeds"))


def _init_cache(model, cfg, shape: ShapeSpec, rows: int, seed: bool = True):
    """The contiguous cache of ``rows`` rows at ``shape.seq`` (bf16), its
    cross caches seeded from zero frames or image embeddings (JAX's), or
    without ``seed`` only of their length (the step reads the cache, not
    its seeding)."""
    if not seed:
        dec = model.decoder if isinstance(model, EncDecLM) else model
        t = {"audio": cfg.encoder_seq, "vlm": cfg.num_image_tokens}.get(cfg.family)
        mem = None if t is None else _meta((rows, t, cfg.d_model), torch.bfloat16)
        return dec.stack.init_cache(rows, shape.seq, torch.bfloat16, META, mem)
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

