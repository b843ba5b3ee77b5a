"""Frozen arithmetic: the card's data-sheet peaks, each hand-written
kernel's work from the arguments of one call, and the useful work of a
serve step and a distill step from a configuration's shapes.

The peaks and the kernel work are copied from
``src/repro_torch/launch/roofline.py`` at commit 1552549 (``PEAK_*``,
``HBM_BW``, ``KernelWork.seconds``, ``kernel_work`` and its ``_w2a8``,
``_w2a8_acc``, ``_bitlinear``, ``_paged_decode``, ``_paged_prefill``,
``_relation_kd``, ``_ssd_scan``, ``paged_*_attention_roofline``), changed
only to read a call's recorded arguments (:class:`Arg`: shape, dtype name
and, for the paged kernels' index tensors, values) instead of tensors.
The useful-work counts are the benchmark's own.  Nothing here imports the
program, so a later change to the program cannot move the yardstick.

Each input byte is read once and each output byte written once; a share of
a roofline is the least time (the larger of bytes over the HBM rate and
operations over their type's peak) over the time measured.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, List, Optional, Sequence, Tuple

# NVIDIA H100 SXM5 80GB data sheet, dense rates, at the 700 W power limit
PEAK_FLOPS_BF16 = 989e12
PEAK_FLOPS_INT8 = 1979e12
PEAK_FLOPS_TF32 = 494.7e12
PEAK_FLOPS_FP32 = 67e12
HBM_BW = 3.35e12
PEAK_OPS = {"int8": PEAK_FLOPS_INT8, "bfloat16": PEAK_FLOPS_BF16,
            "tf32": PEAK_FLOPS_TF32, "float32": PEAK_FLOPS_FP32}

_ITEMSIZE = {"float64": 8, "float32": 4, "bfloat16": 2, "float16": 2,
             "int64": 8, "int32": 4, "int16": 2, "int8": 1, "uint8": 1,
             "bool": 1}


@dataclasses.dataclass
class Arg:
    """One recorded argument of a kernel call: its shape, dtype name and,
    where the work depends on them, its values (a paged kernel's first
    block-table column, positions, chunk lengths)."""
    shape: Tuple[int, ...]
    dtype: str
    values: Optional[List] = None


def numel(shape) -> int:
    n = 1
    for d in shape:
        n *= int(d)
    return n


def size(a: Arg) -> int:
    return numel(a.shape) * _ITEMSIZE[a.dtype]


class Work(tuple):
    """(operations, bytes, operation type)."""

    def __new__(cls, ops: float, nbytes: float, op_type: str):
        return tuple.__new__(cls, (float(ops), float(nbytes), op_type))

    def seconds(self) -> Tuple[float, str]:
        ops, nbytes, op_type = self
        t_bytes = nbytes / HBM_BW
        t_ops = ops / PEAK_OPS[op_type]
        return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _decode_roof(batch, resident_tokens, block_size, n_q_heads, n_kv_heads,
                 head_dim, kv_bytes):
    """``paged_decode_attention_roofline`` (fused, one layer): (flops, bytes)."""
    per_token_kv = 2 * n_kv_heads * head_dim * kv_bytes
    q_io = 2 * batch * n_q_heads * head_dim * kv_bytes
    new_kv = 2 * batch * n_kv_heads * head_dim * kv_bytes
    new_kv += batch * block_size * per_token_kv
    nbytes = q_io + new_kv + resident_tokens * per_token_kv
    return 4.0 * n_q_heads * head_dim * resident_tokens, float(nbytes)


def _prefill_roof(chunk, resident_tokens, block_size, n_q_heads, n_kv_heads,
                  head_dim, kv_bytes):
    """``paged_prefill_attention_roofline`` (fused, one layer, one row)."""
    per_token_kv = 2 * n_kv_heads * head_dim * kv_bytes
    q_io = 2 * chunk * n_q_heads * head_dim * kv_bytes
    new_kv = chunk * per_token_kv + (chunk + block_size) * per_token_kv
    nbytes = q_io + new_kv + resident_tokens * per_token_kv
    attended = chunk * resident_tokens + chunk * (chunk + 1) // 2
    return 4.0 * n_q_heads * head_dim * attended, float(nbytes)


def _w2a8(x, wp, delta, *_):
    m, k = x.shape
    n = wp.shape[-1]
    return Work(2.0 * m * k * n, size(x) + size(wp) + size(delta)
                + m * n * _ITEMSIZE[x.dtype], "int8")


def _w2a8_acc(x, wp, gamma, *_):
    m, k = x.shape
    n = wp.shape[-1]
    return Work(2.0 * m * k * n, size(x) + size(wp) + size(gamma) + 4 * m * n,
                "int8")


def _bitlinear(x, w, *rest):
    m, k = x.shape
    n = w.shape[-1]
    out = m * n * _ITEMSIZE[x.dtype]
    ops = 2.0 * m * k * n
    if w.dtype.endswith("int8"):
        gamma, delta = rest[:2]
        return Work(ops, size(x) + size(w) + size(gamma) + size(delta) + out, "int8")
    delta = rest[0]
    if len(rest) > 1:
        return Work(ops, size(x) + size(w) + size(delta) + size(rest[1])
                    + 4 * m * n + m * k + k * n, "int8")
    return Work(ops, size(x) + size(w) + size(delta) + out + m * k + 4 * m + k * n,
                "int8")


def _paged_decode(q, k_new, v_new, k_pool, v_pool, block_tables, idx, *_):
    b, hkv, g, dh = q.shape
    bs = k_pool.shape[2]
    item = _ITEMSIZE[k_pool.dtype]
    live = [r for r, blk in enumerate(block_tables.values) if blk != 0]
    depths = [idx.values[r] for r in live]
    n = len(live)
    flops, nbytes = _decode_roof(n, sum(depths) + n, bs, hkv * g, hkv, dh, item)
    rewrite = n * bs * 2 * hkv * dh * item
    return Work(flops, nbytes - rewrite, "bfloat16")


def _paged_prefill(q, k_chunk, v_chunk, k_pool, v_pool, block_tables, start,
                   lens, *_):
    b, hkv, tg, dh = q.shape
    t = k_chunk.shape[2]
    g = tg // t
    bs = k_pool.shape[2]
    item = _ITEMSIZE[k_pool.dtype]
    live = [r for r, blk in enumerate(block_tables.values) if blk != 0]
    ops = nbytes = 0.0
    for r in live:
        f, by = _prefill_roof(lens.values[r], start.values[r], bs, hkv * g, hkv,
                              dh, item)
        ops += f
        nbytes += by - bs * 2 * hkv * dh * item
    return Work(ops, nbytes, "bfloat16")


def _relation_kd(s, t, *_):
    bh, l, d = s.shape
    ops = 2 * 2.0 * bh * l * l * d
    return Work(3 * ops, size(s) + size(t) + bh * l * 4, "tf32")


def chunk_len(s: int, chunk: int) -> int:
    q = min(chunk, s)
    while s % q:
        q -= 1
    return q


def _ssd_scan(x, a, dt, B, C, chunk=256, *_):
    b, s, h, p = x.shape
    n = B.shape[-1]
    q = chunk_len(s, int(chunk))
    nc = s // q
    ops = (b * h * nc * (q * (q + 1) * p + 4.0 * q * n * p)
           + b * nc * q * (q + 1) * n)
    nbytes = 4 * (2 * numel(x.shape) + 2 * numel(a.shape)
                  + 2 * numel(B.shape) + b * h * p * n)
    return Work(3 * ops, nbytes, "tf32")


KERNELS = {"w2a8_gemv": _w2a8, "w2a8_forward_acc": _w2a8_acc,
           "paged_attention_decode": _paged_decode,
           "paged_prefill_chunk": _paged_prefill, "bitlinear": _bitlinear,
           "relation_kd": _relation_kd, "ssd_scan": _ssd_scan}

# the arguments whose values a kernel's work needs, by position: the paged
# kernels' block tables (first column), positions and chunk lengths
VALUE_ARGS = {"paged_attention_decode": {5: "first_column", 6: "all"},
              "paged_prefill_chunk": {5: "first_column", 6: "all", 7: "all"}}


def kernel_work(name: str, args: Sequence) -> Work:
    return KERNELS[name](*args)


def least_seconds(works: Iterable[Work]) -> float:
    """The sum of each call's least time."""
    return sum(w.seconds()[0] for w in works)


# -- useful work of a step, from the configuration's shapes ------------------

@dataclasses.dataclass
class DenseShape:
    layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int

    @classmethod
    def of(cls, cfg: dict) -> "DenseShape":
        return cls(cfg["num_hidden_layers"], cfg["hidden_size"],
                   cfg["num_attention_heads"], cfg["num_key_value_heads"],
                   cfg["head_dim"], cfg["intermediate_size"], cfg["vocab_size"])

    @property
    def proj_params(self) -> int:
        """Ternary projection weights of the whole stack."""
        d, dh = self.d_model, self.head_dim
        attn = d * (self.n_heads + 2 * self.n_kv_heads) * dh + self.n_heads * dh * d
        return self.layers * (attn + 3 * d * self.d_ff)

    @property
    def kv_bytes_per_token(self) -> int:
        """bf16 K and V of one position over the stack."""
        return self.layers * 2 * self.n_kv_heads * self.head_dim * 2


@dataclasses.dataclass
class SSMShape:
    layers: int
    d_model: int
    d_state: int
    head_dim: int
    expand: int
    d_conv: int
    chunk: int
    vocab: int

    @classmethod
    def of(cls, cfg: dict) -> "SSMShape":
        return cls(cfg["n_layer"], cfg["d_model"], cfg["d_state"], cfg["headdim"],
                   cfg["expand"], cfg["d_conv"], cfg["chunk_size"], cfg["vocab_size"])

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def n_heads(self) -> int:
        return self.d_inner // self.head_dim

    @property
    def proj_params(self) -> int:
        in_dim = 2 * self.d_inner + 2 * self.d_state + self.n_heads
        return self.layers * (self.d_model * in_dim + self.d_inner * self.d_model)

    def ssd_flops(self, batch: int, seq: int) -> float:
        """The chunked SSD's products over the stack, counted once (fp32)."""
        q = chunk_len(seq, self.chunk)
        nc = seq // q
        h, p, n = self.n_heads, self.head_dim, self.d_state
        per_layer = (batch * h * nc * (q * (q + 1) * p + 4.0 * q * n * p)
                     + batch * nc * q * (q + 1) * n)
        return self.layers * per_layer


    @property
    def state_bytes(self) -> int:
        """One row's fp32 recurrent state over the stack: the SSD's
        (heads x head dim x state) and the causal conv's last d_conv - 1
        inputs."""
        conv_dim = self.d_inner + 2 * self.d_state
        per_layer = (self.n_heads * self.head_dim * self.d_state
                     + conv_dim * (self.d_conv - 1))
        return self.layers * per_layer * 4


def shape_of(cfg: dict):
    return DenseShape.of(cfg) if cfg["family"] == "dense" else SSMShape.of(cfg)


def serve_step_seconds(shape, rows: Sequence[Tuple[int, int, bool]]) -> float:
    """The least time of one serving step: ``rows`` holds, for each request
    the step advances, (tokens it runs, resident positions before them,
    whether its last token is sampled).  Useful operations: the ternary
    projections of every token (int8) and the tied head of each sampled row
    (bf16); a dense model's causal attention over each token's prefix
    (bf16), an SSM's recurrent update and readout of each token (fp32
    elementwise, 4 x heads x head dim x state a layer).  Compulsory bytes:
    the packed weights and the bf16 head table once; a dense row's resident
    K/V read and new K/V written, an SSM row's state read and written."""
    tokens = sum(n for n, _, _ in rows)
    if tokens == 0:
        return 0.0
    sampled = sum(1 for _, _, smp in rows if smp)
    d, layers = shape.d_model, shape.layers
    int8_ops = 2.0 * shape.proj_params * tokens
    bf16_ops = 2.0 * d * shape.vocab * sampled
    fp32_ops = 0.0
    nbytes = shape.proj_params / 4.0 + shape.vocab * d * 2
    if isinstance(shape, DenseShape):
        attended = sum(n * s + n * (n + 1) // 2 for n, s, _ in rows)
        bf16_ops += layers * 4.0 * shape.n_heads * shape.head_dim * attended
        nbytes += shape.kv_bytes_per_token * (sum(s for _, s, _ in rows) + tokens)
    else:
        fp32_ops += layers * 4.0 * shape.n_heads * shape.head_dim * shape.d_state * tokens
        nbytes += 2 * shape.state_bytes * len(rows)
    t_ops = (int8_ops / PEAK_FLOPS_INT8 + bf16_ops / PEAK_FLOPS_BF16
             + fp32_ops / PEAK_FLOPS_FP32)
    return max(t_ops, nbytes / HBM_BW)


def distill_step_seconds(cfg: dict, batch: int, seq: int,
                         relation: Optional[Tuple[int, int]] = None) -> float:
    """The least time of one distillation step: the teacher's forward, the
    student's forward and backward (twice the forward's products), no
    recomputation.  The ternary projections' forward products are int8, the
    rest bf16 (attention, the tied heads, every backward product), the SSD's
    and the relation loss's fp32 products at the TF32 rate.  ``relation`` is
    (split heads, their width) of the relation loss's three state kinds,
    whose two relation products (student, teacher) and the student's
    backward are counted.  Compulsory bytes: the teacher's bf16 weights
    read, the student's fp32 master, gradient, both moments read and
    written."""
    t = batch * seq
    fam = cfg["family"]
    shape = shape_of(cfg)
    d, v = shape.d_model, shape.vocab
    proj = 2.0 * shape.proj_params * t
    head = 2.0 * d * v * t
    int8_ops = proj                                   # the student's forward
    bf16_ops = proj + head                            # the teacher's forward
    bf16_ops += head + 2 * (proj + head)              # the student's head, backward
    tf32_ops = 0.0
    if fam == "dense":
        attn = shape.layers * 4.0 * shape.n_heads * shape.head_dim * batch * seq * (seq + 1) / 2
        bf16_ops += attn * 4                          # teacher, student, 2x backward
    else:
        ssd = shape.ssd_flops(batch, seq)
        tf32_ops += ssd * 4
    if relation is not None:
        heads, width = relation
        rel = 3 * 2.0 * batch * heads * seq * seq * width
        tf32_ops += rel * 2 + 2 * rel                 # both sides, the backward
    t_ops = (int8_ops / PEAK_FLOPS_INT8 + bf16_ops / PEAK_FLOPS_BF16
             + tf32_ops / PEAK_FLOPS_TF32)
    params = shape.proj_params + v * d
    nbytes = params * (2 + 4 + 4 + 4 + 16 + 4)
    return max(t_ops, nbytes / HBM_BW)
