"""Analytic per-chip HBM estimate for dry-run cells — port of
``repro/launch/memest.py``.

Every term of JAX's model is kept with JAX's value (per chip):

  params            P·bytes_param / n_dev                (the rank's share)
  teacher_params    P·bytes_param / n_dev                (distill)
  grads             P·4 / n_dev                          (fp32)
  opt_states        P·(8 | 2.06) / n_dev                 (JAX's moments)
  residual_stack    L · T_loc · d · 2                    (bf16 layer inputs)
  logits            3 · T_loc · V_pad/tp · 2             (logits+softmax+cot)
  layer_transient   max(attn scores, ssd decay, moe dispatch, ffn act) · 2
  caches            KV + SSM state over (batch·dp, heads/tp)   (decode)

The port stores more than that, and these terms say what:

  gathered_params   P·bytes_param: the whole model on every rank, as a
                    step on the ``"gathered"`` route (``route="gathered"``,
                    for comparison) holds it: every parameter gathered
                    whole.  On the ``"split"`` route (every family, every
                    step kind) the weights live a rank at use: one block's
                    parameters, gathered along the axes but ``"model"``,
                    and the embedding and head, each /tp, plus a Mamba2
                    block's in_proj, which the split uses whole
                    (``at_use_params``, in its place);
  moments           P · 8 / n_dev (fp32 m and v), or P · (2 + 8/256) / n_dev
                    with 8-bit moments (int8 codes in blocks of 256 along the
                    last axis, one fp32 scale a block:
                    ``training/optimizer.py::Moment8``); JAX's ``opt_states``
                    rounds the 8-bit figure to 2.06;
  caches_whole      the decode caches of the rank's rows over every head and
                    position, as the gathered route holds them: caches · tp.

``total`` sums what a rank of the port holds: for a train or distill step
params, gathered_params (at_use_params on the split route), grads, moments
(in place of JAX's opt_states), teacher_params, residual_stack, logits and
layer_transient; for inference on the split route JAX's params and caches
(the cache placed by the plan: split by kv heads or positions) with
at_use_params and layer_transient, and on the gathered route
gathered_params, caches_whole and layer_transient.  The activation terms
are JAX's model, split over tp where JAX's are; the port's rank computes
its rows unsplit, which the dry run's counted ``peak_live_bytes`` shows.
``fits_hbm`` reads the total against the card's 80 GB
(``roofline.HBM_PER_CHIP``).
"""
from __future__ import annotations

from typing import Dict

from repro_torch.configs.shapes import ShapeSpec
from repro_torch.launch.roofline import HBM_PER_CHIP
from repro_torch.models.base import ModelConfig

# bytes per parameter of the port's AdamW moments (m and v)
MOMENT_BYTES = {False: 8.0, True: 2.0 + 8.0 / 256}

TRAIN_TERMS = ("params", "gathered_params", "grads", "moments",
               "teacher_params", "residual_stack", "logits", "layer_transient")
INFER_TERMS = ("gathered_params", "caches_whole", "layer_transient")
SPLIT_INFER_TERMS = ("params", "at_use_params", "caches", "layer_transient")


def estimate(cfg: ModelConfig, shape: ShapeSpec, n_dev: int, tp: int,
             opt_8bit: bool, step_kind: str, with_teacher: bool = False,
             route: str = "split") -> Dict[str, float]:
    p = cfg.param_count()
    bytes_param = 2 if cfg.param_dtype == "bfloat16" else 4
    dp = n_dev // tp
    b_loc = max(1, shape.global_batch // dp)     # batch rows per chip
    t_loc = b_loc * (shape.seq if step_kind in ("train", "prefill", "distill") else 1)
    d = cfg.d_model
    vp_tp = -(-cfg.padded_vocab // tp)
    train = step_kind in ("train", "distill")

    terms: Dict[str, float] = {}
    terms["params"] = p * bytes_param / n_dev
    if with_teacher:
        terms["teacher_params"] = p * bytes_param / n_dev

    if train:
        terms["grads"] = p * 4 / n_dev
        terms["opt_states"] = p * (2.06 if opt_8bit else 8.0) / n_dev
        terms["residual_stack"] = cfg.n_layers * t_loc * d * 2
        terms["logits"] = 3 * t_loc * vp_tp * 2

    # per-layer transient working set (one layer live at a time under remat)
    heads_loc = max(1, cfg.n_heads // tp)
    scores = b_loc * heads_loc * min(shape.seq, cfg.max_seq) ** 2 * 4 \
        if any(s.mixer in ("attn", "attn_cross") for s in cfg.resolved_pattern()) \
        and step_kind in ("train", "prefill", "distill") else 0
    ssd = 0
    if any(s.mixer == "mamba" for s in cfg.resolved_pattern()) and \
            step_kind in ("train", "prefill", "distill"):
        q = cfg.ssm_chunk
        h_loc = max(1, (2 * d // cfg.ssm_head_dim) // tp)
        nc = max(1, shape.seq // q)
        ssd = b_loc * nc * h_loc * q * q * 4
    moe = 0
    if cfg.n_experts and step_kind in ("train", "distill", "prefill"):
        cap = int(cfg.moe_group_size * cfg.top_k / cfg.n_experts
                  * cfg.capacity_factor)
        groups_loc = max(1, t_loc // cfg.moe_group_size)
        e_loc = max(1, cfg.n_experts // tp) if cfg.n_experts % tp == 0 else cfg.n_experts
        moe = groups_loc * cfg.moe_group_size * e_loc * cap * 2 // max(cap, 1)  # dispatch mask dominates
        moe += groups_loc * e_loc * cap * d * 2
    ffn = t_loc * max(cfg.d_ff // tp if cfg.d_ff else 2 * d // tp, 1) * 2 * 3
    terms["layer_transient"] = float(max(scores, ssd, moe, ffn)) * 2  # fwd+bwd copies

    if step_kind == "decode":
        # caches sharded over (batch·dp, heads|seq over tp)
        kv_layers = sum(1 for s in cfg.resolved_pattern()
                        if s.mixer in ("attn", "attn_cross")) * cfg.repeats
        ssm_layers = sum(1 for s in cfg.resolved_pattern()
                         if s.mixer == "mamba") * cfg.repeats
        kv = kv_layers * b_loc * shape.seq * cfg.n_kv_heads * cfg.head_dim * 2 * 2 / tp
        d_inner = 2 * d
        ssm_state = ssm_layers * b_loc * (d_inner // cfg.ssm_head_dim) \
            * cfg.ssm_head_dim * cfg.ssm_state * 4 / tp
        terms["caches"] = kv + ssm_state
        terms["caches_whole"] = terms["caches"] * tp

    # the port's own terms
    terms["gathered_params"] = float(p * bytes_param)
    if train:
        terms["moments"] = p * MOMENT_BYTES[bool(opt_8bit)] / n_dev
    port = TRAIN_TERMS if train else INFER_TERMS
    if route == "split":
        vocab_params = cfg.padded_vocab * d * (1 if cfg.tie_embeddings else 2)
        block = (p - vocab_params) / max(cfg.n_layers, 1)
        teachers = 2 if with_teacher else 1
        in_proj = 0
        if any(s.mixer == "mamba" for s in cfg.resolved_pattern()):
            di = 2 * d
            in_proj = d * (2 * di + 2 * cfg.ssm_state + di // cfg.ssm_head_dim)
        terms["at_use_params"] = float(
            ((block + vocab_params) / tp + in_proj * (1 - 1 / tp))
            * bytes_param * teachers)
        port = (tuple("at_use_params" if k == "gathered_params" else k
                      for k in port) if train else SPLIT_INFER_TERMS)
    terms["total"] = sum(terms[k] for k in port if k in terms)
    terms["fits_hbm"] = terms["total"] < HBM_PER_CHIP
    return terms
