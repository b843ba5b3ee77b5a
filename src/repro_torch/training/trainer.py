"""Train-step factories: plain CE (stages 1-2 / SFT baselines) and the
distillation step (stage 3), with gradient accumulation — port of
``repro/training/trainer.py``.

The JAX steps are pure functions ``(state, batch) -> (state, metrics)``;
here the parameters live in the ``nn.Module`` and ``TrainState.params`` is
that module's ``{name: Parameter}`` dict, so a step updates the module and
the optimizer state in place and returns the same state object with the
JAX metrics dict (``loss``, ``loss_ce``, [``loss_ld``, ``loss_ad``,]
``grad_norm``, ``lr``; values are 0-d tensors, read with ``float``).  The
teacher of the distill step is a module holding its own weights; it runs
under ``torch.no_grad()``.

The CE and distill steps also run under a sharding plan
(``distributed/sharding.py``; JAX's launcher jits them with the plan's
``in_shardings``): ``init_train_state(model, opt, plan)`` replaces the
model's parameters by DTensors placed by the plan from ``param_axes()``,
and the AdamW moments by theirs (``state_axes``), so a rank holds the
plan's share of each; ``place_model(teacher, plan)`` places the distill
step's teacher likewise.  The
step takes the whole batch on every rank and computes on the rank's rows
of it (split over the mesh axes of the ``"batch"`` rule), and the ranks
along ``"model"`` split the compute (``distributed/tensor_parallel.py``;
every family: the dense, MoE, SSM and hybrid decoders and the
cross-attention families, whisper-medium's encoder-decoder and
llama-3.2-vision-11b): each block gathers its parameters along the other
axes at its use, keeps their ``"model"`` shards and computes its heads (a
cross layer's K/V projected from the memory by kv heads), ``d_ff``
columns, experts (or each expert's ``d_ff`` columns), SSM heads and
vocabulary slice.  A ``"model"``-sharded parameter's gradient is the
rank's own; a replicated one is left alone where *f* and *g* made the
ranks' equal (the norms, the MoE router) and summed where their
contributions differ (the kv projections replicated by the fallback, the
qk norms); a tensor used whole (Mamba2's in_proj and conv) gets its shard
of the ranks' sum.

A gradient is summed over the ranks that split the batch.  The CE is the
whole batch's token mean (each rank's NLL sum over the batch's mask count),
the MoE loss the mean of the ranks' that split the batch (every ``"model"``
rank computes the same one from the replicated routing, and the metrics are
summed over the batch's axes only), and the metrics and ``grad_norm`` are
the whole batch's.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch
from torch import nn

from repro_torch.core.distill import (DistillConfig, bitdistill_loss, nll_sum,
                                      softmax_cross_entropy)
from repro_torch.distributed import tensor_parallel as tp
from repro_torch.distributed.sharding import is_dtensor
from repro_torch.models.base import ModelConfig
from repro_torch.models.encdec import EncDecLM
from repro_torch.nn.layers import Embedding
from repro_torch.nn.moe import MoEMLP, group_count
from repro_torch.training.optimizer import AdamW, AdamWState

Batch = Dict[str, torch.Tensor]
Metrics = Dict[str, torch.Tensor]


@dataclasses.dataclass
class TrainState:
    params: Dict[str, nn.Parameter]
    opt_state: AdamWState
    step: int


def init_train_state(model: nn.Module, optimizer: AdamW, plan=None) -> TrainState:
    """The model's parameters and zero moments; with a sharding ``plan``
    both placed by it (the model's parameters become DTensors)."""
    params = dict(model.named_parameters())
    ranks = jax_ranks(params)
    if plan is None:
        return TrainState(params, optimizer.init(params, ranks), 0)
    axes = model.param_axes()
    params = place_model(model, plan)
    return TrainState(params, optimizer.init(params, ranks, plan=plan, axes=axes), 0)


# the port's names of the stacks whose block tensors JAX stacks over repeats:
# a CausalLM's, and an EncDecLM's encoder and decoder
STACKED = ("stack.layers.", "encoder.layers.", "decoder.stack.layers.")


def jax_ranks(params: Dict[str, torch.Tensor]) -> Dict[str, int]:
    """Rank of each tensor in the JAX param tree, where the blocks' tensors
    (``stack.layers.<l>.*``, and an encoder-decoder's ``encoder.layers.<l>.*``
    and ``decoder.stack.layers.<l>.*``) are stacked over repeats: one axis
    more.  So, as in the JAX package, the blocks' norm scales are
    weight-decayed and the final norms' scales (``enc_norm`` too) are not."""
    return {k: p.dim() + (1 if k.startswith(STACKED) else 0)
            for k, p in params.items()}


# ---------------------------------------------------------------------------
# forward adapters
# ---------------------------------------------------------------------------

def forward(model, batch: Batch, distill_layer: Optional[int] = None):
    """-> (logits, qkv_states|None, moe_loss) for any model family: an
    encoder-decoder reads ``batch["frames"]``, a VLM ``batch["image_embeds"]``."""
    if isinstance(model, EncDecLM):
        return model.apply(batch["frames"], batch["tokens"],
                           distill_layer=distill_layer)
    return model.apply(batch["tokens"], memory=batch.get("image_embeds"),
                       distill_layer=distill_layer)


def default_distill_layer(cfg: ModelConfig) -> int:
    """Fig. 3b: late layers distill best -> last attention-bearing layer."""
    pat = cfg.resolved_pattern()
    for li in range(cfg.n_layers - 1, -1, -1):
        if pat[li % len(pat)].mixer in ("attn", "attn_cross"):
            return li
    raise ValueError(f"{cfg.name}: no attention layers; AD inapplicable")


def _microbatches(batch: Batch, accum: int):
    for k, v in batch.items():
        if v.shape[0] % accum:
            raise ValueError(f"batch[{k!r}] has {v.shape[0]} rows, not a "
                             f"multiple of accum={accum}")
    chunks = {k: torch.chunk(v, accum, dim=0) for k, v in batch.items()}
    return [{k: c[i] for k, c in chunks.items()} for i in range(accum)]


def _accumulate(state: TrainState, batch: Batch, accum: int,
                loss_fn: Callable[[Batch], Tuple[torch.Tensor, Metrics]]
                ) -> Tuple[torch.Tensor, Metrics, Dict[str, torch.Tensor]]:
    """Mean loss, mean metrics and mean gradients over ``accum`` equal
    micro-batches (one backward each; the gradients sum in ``.grad``)."""
    for p in state.params.values():
        p.grad = None
    losses, per_mb = [], []
    for mb in (_microbatches(batch, accum) if accum > 1 else [batch]):
        loss, metrics = loss_fn(mb)
        loss.backward()
        losses.append(loss.detach())
        per_mb.append({k: v.detach() for k, v in metrics.items()})
    grads = {}
    for name, p in state.params.items():
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        grads[name] = g / accum if accum > 1 else g
        p.grad = None
    loss = torch.stack(losses).sum() / accum if accum > 1 else losses[0]
    metrics = {k: torch.stack([m[k] for m in per_mb]).mean() for k in per_mb[0]}
    return loss, metrics, grads


# ---------------------------------------------------------------------------
# plain CE step (stage 2 continual pre-training, SFT baselines)
# ---------------------------------------------------------------------------

def make_train_step(model, optimizer: AdamW, lr_fn: Callable,
                    accum: int = 1, plan=None) -> Callable:
    """step(state, batch) -> (state, metrics); ``state.params`` must be
    ``model``'s parameters (``init_train_state(model, ..., plan)``); with a
    ``plan`` every rank of its mesh passes the same whole batch."""
    if plan is not None:
        return _sharded_step(model, optimizer, lr_fn, accum, plan,
                             ce_loss_parts(model))

    loss_fn = ce_loss_parts(model)

    def step(state: TrainState, batch: Batch) -> Tuple[TrainState, Metrics]:
        loss, metrics, grads = _accumulate(state, batch, accum, loss_fn)
        lr = lr_fn(state.step)
        _, state.opt_state, opt_metrics = optimizer.update(
            grads, state.opt_state, state.params, lr)
        state.step += 1
        return state, dict(metrics, loss=loss, **opt_metrics)

    return step


# ---------------------------------------------------------------------------
# the CE step under a sharding plan
# ---------------------------------------------------------------------------

def _owner(model: nn.Module, name: str) -> Tuple[nn.Module, str]:
    *path, attr = name.split(".")
    return model.get_submodule(".".join(path)), attr


def place_model(model: nn.Module, plan) -> Dict[str, nn.Parameter]:
    """Replace every parameter of ``model`` (alike on every rank) by a
    DTensor parameter placed by ``plan`` from ``model.param_axes()``; the
    placed parameters by name."""
    axes = model.param_axes()
    placed = {}
    for name, p in list(model.named_parameters()):
        owner, attr = _owner(model, name)
        placed[name] = owner._parameters[attr] = nn.Parameter(
            plan.place(p.detach(), axes[name]), requires_grad=p.requires_grad)
    for m in model.modules():
        if isinstance(m, Embedding):     # drop the whole table's compute copy
            m._refresh()
    return placed


class BatchSplit(NamedTuple):
    rows: slice          # this rank's rows of the batch
    n: int               # ranks the batch is split over
    axes: Tuple[str, ...]


def batch_split(plan, rows: int, seq: int) -> BatchSplit:
    """This rank's rows of a [rows, seq] batch: the mesh axes of the
    ``"batch"`` rule (JAX's batch sharding), the rank's index along them
    major to minor."""
    axes = plan.spec(("batch", "seq"), (rows, seq), record=False)[0]
    coord = plan.mesh.get_coordinate()
    names = list(plan.shape)
    idx, n = 0, 1
    for a in axes:
        idx = idx * plan.shape[a] + coord[names.index(a)]
        n *= plan.shape[a]
    per = rows // n
    return BatchSplit(slice(idx * per, (idx + 1) * per), n, axes)


def check_moe_groups(model: nn.Module, tokens: int, n: int) -> None:
    """An MoE layer groups the tokens of the batch it sees; split over
    ``n`` ranks, its groups must be the whole batch's, or the routing (and
    each group's capacity) would differ from the unsharded step's."""
    for name, m in model.named_modules():
        if isinstance(m, MoEMLP) and n > 1:
            g = group_count(tokens, m.group_size)
            g_rank = group_count(tokens // n, m.group_size)
            if g != n * g_rank:
                raise ValueError(
                    f"{name}: the batch's {tokens} tokens form {g} MoE groups "
                    f"(moe_group_size {m.group_size}), which do not split "
                    f"evenly over the {n} ranks of the batch ({g_rank} groups "
                    f"of {tokens // n} tokens each): a group would straddle "
                    "ranks")


def _all_sum(t: torch.Tensor, plan, axes) -> torch.Tensor:
    import torch.distributed as dist
    for a in axes:
        dist.all_reduce(t, group=plan.mesh.get_group(a))
    return t


def make_split(plan, *models, local: bool = False) -> tp.Split:
    """The split of a step over ``models`` (student first, then teacher)."""
    split = tp.Split(plan)
    for m in models:
        split.register(m, local=local)
    return split


def ce_loss_parts(model) -> Callable:
    """parts(mb, den=None, n=1) -> (the loss to differentiate, its metric
    parts): the token-mean CE plus the MoE loss.  With ``den`` and ``n`` (a
    sharded step's rows of a batch) the CE is the rows' NLL sum over the
    batch's mask count ``den`` and the MoE loss is divided by the ``n``
    ranks the batch is split over, so that each metric summed over those
    ranks is the whole batch's."""
    def parts(mb, den=None, n=1):
        logits, _, moe = forward(model, mb)
        mask = mb.get("loss_mask")
        if den is None:
            ce = softmax_cross_entropy(logits, mb["labels"], mask)
        else:
            ce = nll_sum(logits, mb["labels"], mask) / den
        if n > 1:
            moe = moe / n
        return ce + moe, {"loss_ce": ce, "loss_moe": moe}
    return parts


def distill_loss_parts(student_model, teacher_model, dcfg: DistillConfig) -> Callable:
    """As :func:`ce_loss_parts`, Eq. 13 (``bitdistill_loss``, its ``den``
    and ``n`` likewise); ``loss`` is reported without the MoE loss, as
    ``bitdistill_loss`` reports it."""
    dl = _distill_layer(dcfg)

    def parts(mb, den=None, n=1):
        with torch.no_grad():
            t_logits, t_states, _ = forward(teacher_model, mb, distill_layer=dl)
        logits, states, moe = forward(student_model, mb, distill_layer=dl)
        loss, m = bitdistill_loss(logits, t_logits, states, t_states, mb["labels"],
                                  mb.get("loss_mask"), dcfg, den=den, n=n)
        return loss + (moe / n if n > 1 else moe), m
    return parts


def _sharded_step(model, optimizer: AdamW, lr_fn: Callable, accum: int, plan,
                  parts: Callable, teacher=None) -> Callable:
    """A step under ``plan``: each rank takes its rows of the whole batch
    and a block's parameters are their compute copies at its use; the
    teacher (placed by the caller) likewise, without gradients."""
    if teacher is not None and not all(is_dtensor(p) for p in teacher.parameters()):
        raise ValueError("a distill step under a plan takes a teacher placed "
                         "by it: place_model(teacher, plan) first, as "
                         "init_train_state(student, opt, plan) places the student")
    split = make_split(plan, model, *([teacher] if teacher is not None else []))

    def step(state: TrainState, batch: Batch) -> Tuple[TrainState, Metrics]:
        for p in state.params.values():
            p.grad = None
        keys, rows_parts = None, []
        for mb in (_microbatches(batch, accum) if accum > 1 else [batch]):
            rows, seq = mb["tokens"].shape
            bs = batch_split(plan, rows, seq)
            check_moe_groups(model, rows * seq, bs.n)
            local = {k: v[bs.rows] for k, v in mb.items()}
            mask = mb.get("loss_mask")
            den = (torch.clamp(torch.sum(mask.to(torch.float32)), min=1.0)
                   if mask is not None else float(rows * seq))
            split.batch_axes = bs.axes
            with tp.activated(split):
                loss, m = parts(local, den, bs.n)
                loss.backward()
            keys = list(m)
            rows_parts.append(torch.stack([m[k].detach().to(torch.float32)
                                           for k in keys]))
        sums = _all_sum(torch.stack(rows_parts), plan, bs.axes)
        grads = {}
        for name, p in state.params.items():
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            grads[name] = g / accum if accum > 1 else g
            p.grad = None
        metrics = {k: sums[:, i].mean() for i, k in enumerate(keys)}
        if "loss" not in metrics:
            col = {k: sums[:, i] for i, k in enumerate(keys)}
            total = col["loss_ce"] + col["loss_moe"]
            metrics["loss"] = total.sum() / accum if accum > 1 else total[0]
        lr = lr_fn(state.step)
        _, state.opt_state, opt_metrics = optimizer.update(
            grads, state.opt_state, state.params, lr)
        state.step += 1
        return state, dict(metrics, **opt_metrics)

    return step


# ---------------------------------------------------------------------------
# stage-3 distillation step
# ---------------------------------------------------------------------------

def _distill_layer(dcfg: DistillConfig) -> Optional[int]:
    dl = dcfg.distill_layer if dcfg.use_ad else None
    if dl is not None and dl < 0:
        raise ValueError("resolve DistillConfig.distill_layer=-1 first "
                         "(default_distill_layer), as the pipeline does")
    return dl


def make_distill_step(student_model, teacher_model, optimizer: AdamW,
                      lr_fn: Callable, dcfg: DistillConfig,
                      accum: int = 1, plan=None) -> Callable:
    """step(state, batch) -> (state, metrics): teacher frozen (its module
    holds its weights), student QAT.  With a ``plan`` (``state`` from
    ``init_train_state(student, ..., plan)``, the teacher's parameters from
    ``place_model(teacher, plan)``: JAX's ``t_shardings``) the step runs as
    the CE step does under one, the teacher split as the student is."""
    if plan is not None:
        return _sharded_step(student_model, optimizer, lr_fn, accum, plan,
                             distill_loss_parts(student_model, teacher_model, dcfg),
                             teacher=teacher_model)
    loss_fn = distill_loss_parts(student_model, teacher_model, dcfg)

    def step(state: TrainState, batch: Batch) -> Tuple[TrainState, Metrics]:
        _, metrics, grads = _accumulate(state, batch, accum, loss_fn)
        lr = lr_fn(state.step)
        _, state.opt_state, opt_metrics = optimizer.update(
            grads, state.opt_state, state.params, lr)
        state.step += 1
        return state, dict(metrics, **opt_metrics)

    return step


# ---------------------------------------------------------------------------
# eval steps
# ---------------------------------------------------------------------------

def make_eval_loss(model) -> Callable:
    """eval_step(batch) -> token-mean CE of ``model`` (no gradient)."""
    @torch.no_grad()
    def eval_step(batch: Batch) -> torch.Tensor:
        logits, _, _ = forward(model, batch)
        return softmax_cross_entropy(logits, batch["labels"], batch.get("loss_mask"))
    return eval_step


def make_eval_classify(model, label_base: int, n_labels: int) -> Callable:
    """eval_step(batch) -> accuracy of the answer-position label-token argmax."""
    @torch.no_grad()
    def eval_step(batch: Batch) -> torch.Tensor:
        logits, _, _ = forward(model, batch)                   # [B, S, V]
        pos = batch["answer_pos"].long()                       # [B]
        rows = logits[torch.arange(logits.shape[0], device=logits.device), pos]
        pred = torch.argmax(rows[:, label_base:label_base + n_labels], dim=-1)
        return torch.mean((pred == batch["class_label"].long()).to(torch.float32))
    return eval_step
