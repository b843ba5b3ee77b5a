"""Master weights made from ``--seed`` on the device, in a few large draws,
named as the program's modules name their tensors (``embed.table``,
``stack.layers.<l>.attn.wq.w``, ...).  The benchmark hands the same
tensors to the program (which loads and, for serving, packs them) and to
the plain reference (which works the ternary weights out again)."""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

Shapes = List[Tuple[str, Tuple[int, ...], str]]   # name, shape, init kind


def vocab_rows(cfg: dict) -> int:
    """The embedding's rows: ``vocab_size`` rounded up to the file's
    ``pad_vocab_size_multiple`` (Mamba's checkpoints pad so), or as it is."""
    m = int(cfg.get("pad_vocab_size_multiple", 1))
    return -(-int(cfg["vocab_size"]) // m) * m


def embed_kind(cfg: dict) -> str:
    """The embedding's init: N(0, std^2), std 0.02 unless the file's
    ``init_embed_std`` says otherwise (the tests' narrow models keep the
    logits' scale of the full width with it)."""
    return "embed:%r" % float(cfg.get("init_embed_std", 0.02))


def dense_shapes(cfg: dict, student: bool) -> Shapes:
    """The tensors of a dense decoder (Qwen3: qk-norm, tied head), with the
    student's SubLN scales when ``student``."""
    d, f, dh = cfg["hidden_size"], cfg["intermediate_size"], cfg["head_dim"]
    hq, hkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    out: Shapes = [("embed.table", (vocab_rows(cfg), d), embed_kind(cfg))]
    for l in range(cfg["num_hidden_layers"]):
        p = f"stack.layers.{l}."
        out += [(p + "norm1.scale", (d,), "norm"),
                (p + "attn.wq.w", (d, hq * dh), "fan_in"),
                (p + "attn.wk.w", (d, hkv * dh), "fan_in"),
                (p + "attn.wv.w", (d, hkv * dh), "fan_in"),
                (p + "attn.wo.w", (hq * dh, d), "fan_in"),
                (p + "attn.q_norm.scale", (dh,), "norm"),
                (p + "attn.k_norm.scale", (dh,), "norm")]
        if student:
            out.append((p + "attn.subln.scale", (hq * dh,), "norm"))
        out += [(p + "norm2.scale", (d,), "norm"),
                (p + "mlp.up.w", (d, f), "fan_in"),
                (p + "mlp.gate.w", (d, f), "fan_in"),
                (p + "mlp.down.w", (f, d), "fan_in")]
        if student:
            out.append((p + "mlp.subln.scale", (f,), "norm"))
    out.append(("final_norm.scale", (d,), "norm"))
    return out


def ssm_shapes(cfg: dict, student: bool) -> Shapes:
    """The tensors of a Mamba2 stack (tied head); the gated norm before
    ``out_proj`` is present in teacher and student alike."""
    d, n, hd = cfg["d_model"], cfg["d_state"], cfg["headdim"]
    di = cfg["expand"] * d
    h = di // hd
    conv_dim = di + 2 * n
    out: Shapes = [("embed.table", (vocab_rows(cfg), d), embed_kind(cfg))]
    for l in range(cfg["n_layer"]):
        p = f"stack.layers.{l}."
        out += [(p + "norm1.scale", (d,), "norm"),
                (p + "mamba.in_proj.w", (d, 2 * di + 2 * n + h), "fan_in"),
                (p + "mamba.out_proj.w", (di, d), "fan_in"),
                (p + "mamba.conv_w", (cfg["d_conv"], conv_dim), "conv"),
                (p + "mamba.conv_b", (conv_dim,), "zero"),
                (p + "mamba.A_log", (h,), "a_log"),
                (p + "mamba.D", (h,), "norm"),
                (p + "mamba.dt_bias", (h,), "dt_bias"),
                (p + "mamba.norm.scale", (di,), "norm")]
    out.append(("final_norm.scale", (d,), "norm"))
    return out


def make(shapes: Shapes, seed: int, device, base: Dict[str, torch.Tensor] = None
         ) -> Dict[str, torch.Tensor]:
    """fp32 tensors for ``shapes`` from one normal and one uniform draw of a
    generator seeded with ``seed`` on ``device``; a name already in
    ``base`` is taken from it (the student's copy of the teacher)."""
    base = base or {}
    todo = [(n, s, k) for n, s, k in shapes if n not in base]
    total = sum(math.prod(s) for _, s, _ in todo)
    gen = torch.Generator(device=device).manual_seed(int(seed) & ((1 << 63) - 1))
    normal = torch.randn(total, generator=gen, device=device)
    uniform = torch.rand(total, generator=gen, device=device)
    out, at = {}, 0
    for name, shape, kind in todo:
        k = math.prod(shape)
        z = normal[at:at + k].view(shape)
        u = uniform[at:at + k].view(shape)
        at += k
        if kind == "fan_in":
            t = z.mul_(shape[0] ** -0.5)
        elif kind.startswith("embed:"):
            t = z.mul_(float(kind.split(":", 1)[1]))
        elif kind == "norm":
            t = z.mul_(0.1).add_(1.0)
        elif kind == "conv":
            t = z.mul_(0.1)
        elif kind == "zero":
            t = z.zero_()
        elif kind == "a_log":
            t = torch.log1p(u * 7.0)
        elif kind == "dt_bias":
            dt = torch.exp(u * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3))
            t = dt + torch.log(-torch.expm1(-dt))
        else:
            raise ValueError(kind)
        out[name] = t
    del uniform
    for name, _, _ in shapes:
        if name in base:
            out[name] = base[name]
    return out


def model_weights(cfg: dict, seed: int, device, student: bool = True
                  ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """(teacher, student) master weights of ``cfg``'s family; the student
    shares the teacher's tensors and adds its SubLN scales."""
    fam = cfg["family"]
    shapes = dense_shapes if fam == "dense" else ssm_shapes
    teacher = make(shapes(cfg, False), seed, device)
    if not student:
        return teacher, teacher
    return teacher, make(shapes(cfg, True), seed + 1, device, base=teacher)
