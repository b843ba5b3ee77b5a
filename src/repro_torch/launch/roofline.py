"""Rooflines on one H100, and the work of each hand-written kernel — port of
``repro/launch/roofline.py``.

Three terms per (arch x shape x mesh), in seconds:

  compute    = FLOPs                 / (chips x peak FLOP/s)
  memory     = HBM bytes             / (chips x HBM B/s)
  collective = wire bytes (per chip) / link B/s

FLOPs and bytes come from counting the step's ATen ops
(``launch/op_analysis.py``; whole-program, all chips: per-chip counts times
the chip count).  The collective term comes from :func:`plan_collectives`,
which counts what the port's plan-placed step moves; JAX's
``parse_collectives`` parsed compiled HLO, which the port never produces.

Hardware constants: NVIDIA H100 SXM5 80GB data sheet (dense rates, no
sparsity; the card's maximum power limit of 700 W):

  * 989 TFLOP/s bf16 and 1,979 TOPS int8 on the tensor cores, 494.7 TFLOP/s
    TF32 on the tensor cores, 67 TFLOP/s fp32 outside them;
  * 3.35 TB/s of HBM3, 80 GB a card;
  * NVLink 4 at 900 GB/s a card, 450 GB/s each way, between the 8 cards of
    one HGX host (through NVSwitch);
  * one 400 Gb/s InfiniBand NDR adapter a card between hosts: 50 GB/s.

A collective over a group of at most 8 ranks runs at the NVLink rate; a
wider group crosses hosts and runs at the InfiniBand rate (:class:`Roofline`
``.group_size``).  No time here was measured: these are floors from the
data sheet.

:func:`kernel_work` gives each hand-written kernel's work as ``(operations,
bytes, operation type)`` from the arguments its wrapper receives: the
counterpart of how ``hlo_analysis`` sees a Pallas ``custom-call`` at its
boundary (a ``ctypes`` launch is invisible to any op counter).  The module
imports nothing of the package, so a script can load it by path.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Optional, Tuple

PEAK_FLOPS_BF16 = 989e12
PEAK_FLOPS_INT8 = 1979e12
PEAK_FLOPS_TF32 = 494.7e12
PEAK_FLOPS_FP32 = 67e12
HBM_BW = 3.35e12
NVLINK_BW = 450e9
IB_BW = 50e9
HBM_PER_CHIP = 80e9
RANKS_PER_HOST = 8

# the operation types a kernel's work is counted in, and their peaks
PEAK_OPS = {"int8": PEAK_FLOPS_INT8, "bfloat16": PEAK_FLOPS_BF16,
            "tf32": PEAK_FLOPS_TF32, "float32": PEAK_FLOPS_FP32}


def link_bw(group_size: int) -> float:
    """Per-rank link rate of a collective over ``group_size`` ranks."""
    return NVLINK_BW if group_size <= RANKS_PER_HOST else IB_BW


@dataclasses.dataclass
class CollectiveStats:
    counts: Dict[str, int]
    wire_bytes: float              # per participating chip, ring model
    raw_bytes: float               # sum of result-shape bytes
    group_size: int = 1            # the widest group of any collective

    def to_dict(self):
        return dataclasses.asdict(self)


def ring_wire_bytes(kind: str, result_bytes: float, g: int) -> float:
    """JAX's ring factors: wire bytes a chip sends for one collective whose
    result is ``result_bytes`` over ``g`` ranks."""
    if g <= 1:
        return 0.0
    if kind == "all-reduce":
        return 2.0 * result_bytes * (g - 1) / g
    if kind == "all-gather":
        return result_bytes * (g - 1) / g
    if kind == "reduce-scatter":
        return result_bytes * (g - 1)           # result is already scattered
    if kind == "all-to-all":
        return result_bytes * (g - 1) / g
    if kind == "collective-permute":
        return result_bytes
    raise ValueError(f"unknown collective {kind!r}")


def plan_collectives(plan, params, step_kind: str, axes=None,
                     opt_8bit: bool = False,
                     ranks: Optional[Dict[str, int]] = None,
                     accum: int = 1, rows: int = 1 << 20,
                     route: str = "gathered", recorded=None,
                     metric_parts: int = 2) -> CollectiveStats:
    """What one rank of the port's plan-placed train or distill step moves
    (``training/trainer.py::_sharded_step``).  On the ``"gathered"`` route:

    * each parameter gathered whole (``full_tensor``): one all-gather per
      mesh axis that shards it, innermost axis first;
    * each gradient reduced back to its placement (the ``full_tensor``'s
      backward from ``Partial``): a reduce-scatter per axis that shards it,
      an all-reduce per axis that does not.

    On the ``"split"`` route those are the collectives the step recorded as
    it ran (``recorded``: ``distributed/tensor_parallel.recording()``'s
    (kind, axis, group size, result bytes)), forward and backward: each
    block's parameters gathered along the axes but ``"model"`` at each use
    (again in the remat recompute) and their gradients reduce-scattered,
    *f* and *g* at each block's edges, SubLN's sums of squares, the scales'
    float64 sums and γ's maxima, the loss's maxima and sums over the
    vocabulary and the relation states' gather.  Then on both routes:

    * the gradient norm: one scalar all-reduce per axis that shards a
      parameter (``global_norm``'s ``full_tensor``);
    * the metrics: one all-reduce of the micro-batches' ``metric_parts``
      values (CE and MoE; a distill step's CE, KL, relation loss and
      total) per batch axis (``_all_sum``);
    * with ``opt_8bit``, each 8-bit moment (m and v of a tensor of JAX rank
      >= 2) whose last axis is split: one max all-reduce of its block scales
      per axis splitting it (``optimizer._q8_encode_split``).

    The batch axes are those the plan splits a batch of ``rows`` rows over.

    ``params`` maps names to anything with ``.shape`` and ``.dtype`` (meta
    tensors), ``axes`` names to their logical axes (``model.param_axes()``)
    and ``ranks`` to their JAX ranks (default: their own).  An inference
    step (prefill, decode) on the split route moves what it recorded alone
    (each block's parameters gathered along the axes but ``"model"``, the
    embedding's and the row-parallel projections' sums, γ's maxima,
    SubLN's sums of squares, a decode's merge over a cache split by
    positions and its logits' gather); on the gathered route nothing: the
    rank holds the whole model.  The ring factors are JAX's
    (:func:`ring_wire_bytes`)."""
    counts: Dict[str, int] = {}
    wire = raw = 0.0
    widest = 1

    def add(kind, result_bytes, g):
        nonlocal wire, raw, widest
        counts[kind] = counts.get(kind, 0) + 1
        raw += result_bytes
        wire += ring_wire_bytes(kind, result_bytes, g)
        widest = max(widest, g)

    if route == "split":
        for kind, _, g, result_bytes in recorded or ():
            add(kind, float(result_bytes), g)
    if step_kind not in ("train", "distill"):
        return CollectiveStats(counts, wire, raw, widest)
    shape = plan.shape
    axes_order = list(shape)
    for name, p in params.items():
        spec = plan.spec(axes[name], tuple(p.shape), record=False)
        nbytes = _numel(p.shape) * _itemsize(p.dtype)
        sharding = [a for a in axes_order if any(a in s for s in spec)]
        if route != "split":
            split = 1
            for a in sharding:
                split *= shape[a]
            # the gather: innermost sharding axis first, the result growing
            local = nbytes / split
            for a in reversed(sharding):
                local *= shape[a]
                add("all-gather", local, shape[a])
            # the gradient back to the placement: the whole gradient reduced
            # over each axis, scattered where the parameter is sharded
            g_bytes = nbytes
            for a in axes_order:
                if a in sharding:
                    g_bytes /= shape[a]
                    add("reduce-scatter", g_bytes, shape[a])
                else:
                    add("all-reduce", g_bytes, shape[a])
        for a in sharding:
            add("all-reduce", 4.0, shape[a])          # its share of |g|^2
        rank = (ranks or {}).get(name, len(p.shape))
        if opt_8bit and rank >= 2:
            last = len(p.shape) - 1
            lead = _numel(p.shape[:-1])
            for a in axes_order:
                if a in spec[last]:
                    lead_local = lead
                    for dim_axes in spec[:-1]:
                        for ax in dim_axes:
                            lead_local /= shape[ax]
                    blocks = -(-p.shape[-1] // 256)
                    for _ in ("m", "v"):
                        add("all-reduce", 4.0 * lead_local * blocks, shape[a])
    batch_axes = plan.spec(("batch", "seq"), (rows, 1), record=False)[0]
    for a in batch_axes:
        add("all-reduce", 4.0 * metric_parts * accum, shape[a])
    return CollectiveStats(counts, wire, raw, widest)


def _numel(shape) -> int:
    n = 1
    for d in shape:
        n *= int(d)
    return n


_ITEMSIZE = {"float64": 8, "float32": 4, "bfloat16": 2, "float16": 2,
             "int64": 8, "int32": 4, "int16": 2, "int8": 1, "uint8": 1,
             "bool": 1}


def _itemsize(dtype) -> int:
    if hasattr(dtype, "itemsize"):
        return int(dtype.itemsize)
    return _ITEMSIZE[str(dtype).replace("torch.", "")]


@dataclasses.dataclass
class Roofline:
    flops: float                   # whole-program
    bytes_accessed: float          # whole-program
    wire_bytes: float              # per chip
    n_devices: int
    peak_flops: float = PEAK_FLOPS_BF16
    group_size: int = 1            # widest collective group (picks the link)

    @property
    def t_compute(self) -> float:
        return self.flops / (self.n_devices * self.peak_flops)

    @property
    def t_memory(self) -> float:
        return self.bytes_accessed / (self.n_devices * HBM_BW)

    @property
    def t_collective(self) -> float:
        return self.wire_bytes / link_bw(self.group_size)

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def step_time(self) -> float:
        """Optimistic overlap model: max of the three terms."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    def to_dict(self):
        return {
            "flops": self.flops, "bytes_accessed": self.bytes_accessed,
            "wire_bytes_per_chip": self.wire_bytes, "n_devices": self.n_devices,
            "group_size": self.group_size,
            "t_compute_s": self.t_compute, "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective, "bottleneck": self.bottleneck,
            "step_time_s": self.step_time,
        }


def paged_decode_attention_roofline(
        *, batch: int, resident_tokens: int, table_width: int,
        block_size: int, n_layers: int, n_q_heads: int, n_kv_heads: int,
        head_dim: int, kv_bytes: int = 2, fused: bool = True,
        n_devices: int = 1) -> Roofline:
    """Analytic decode-step roofline for *paged-KV* attention (JAX's,
    verbatim).

      * fused kernel: Q in / ctx out, the step's new K/V written once (plus
        the in-place rewrite of each row's current block, the Pallas
        kernel's fused scatter), and the *resident* KV of the block table
        streamed once — ``resident_tokens`` covers exactly the positions
        the batch's rows hold (sum over rows of ``idx + 1``), not capacity;
      * gather fallback: one read of the dense
        ``batch * table_width * block_size`` window, worst-case over the
        bucketed table width (the materialized window's write and re-read
        are not counted: a lower bound).

    FLOPs cover the score and context matmuls over the attended tokens
    (2 * 2 * Hq * Dh each).  Weight/MLP traffic is out of scope."""
    kv_tokens = resident_tokens if fused else batch * table_width * block_size
    per_token_kv = 2 * n_kv_heads * head_dim * kv_bytes          # K and V
    q_io = 2 * batch * n_q_heads * head_dim * kv_bytes           # q + ctx
    new_kv = 2 * batch * n_kv_heads * head_dim * kv_bytes
    if fused:
        # the fused scatter rewrites each row's current block in place
        new_kv += batch * block_size * per_token_kv
    bytes_accessed = n_layers * (q_io + new_kv + kv_tokens * per_token_kv)
    flops = n_layers * 4.0 * n_q_heads * head_dim * kv_tokens
    return Roofline(flops=float(flops), bytes_accessed=float(bytes_accessed),
                    wire_bytes=0.0, n_devices=n_devices)


def paged_prefill_attention_roofline(
        *, batch: int, chunk: int, resident_tokens: int, table_width: int,
        block_size: int, n_layers: int, n_q_heads: int, n_kv_heads: int,
        head_dim: int, kv_bytes: int = 2, fused: bool = True,
        n_devices: int = 1) -> Roofline:
    """Analytic chunk-step roofline for *chunked paged prefill* (JAX's,
    verbatim): ``batch`` rows each advance ``chunk`` prompt tokens against
    ``resident_tokens`` already-written positions (summed over rows).

      * fused kernel: chunk Q in / ctx out, the chunk's K/V written once
        (plus the in-place rewrite of the blocks the chunk splices into —
        the Pallas kernel's fused scatter), and the resident KV streamed
        once per (row, kv-head) pass;
      * gather fallback: one read of the dense
        ``batch * table_width * block_size`` window (a lower bound, as for
        decode).

    FLOPs cover the score and context matmuls: each chunk token attends the
    resident prefix plus its causal chunk prefix."""
    kv_tokens = (resident_tokens if fused
                 else batch * table_width * block_size)
    per_token_kv = 2 * n_kv_heads * head_dim * kv_bytes          # K and V
    q_io = 2 * batch * chunk * n_q_heads * head_dim * kv_bytes   # q + ctx
    new_kv = batch * chunk * per_token_kv
    if fused:
        # the fused scatter rewrites each touched block in place; a chunk
        # touches at most chunk/bs + 1 blocks per row
        touched = batch * (chunk + block_size)
        new_kv += touched * per_token_kv
    bytes_accessed = n_layers * (q_io + new_kv + kv_tokens * per_token_kv)
    attended = (chunk * resident_tokens
                + batch * chunk * (chunk + 1) // 2) if fused else \
        chunk * batch * table_width * block_size
    flops = n_layers * 4.0 * n_q_heads * head_dim * attended
    return Roofline(flops=float(flops), bytes_accessed=float(bytes_accessed),
                    wire_bytes=0.0, n_devices=n_devices)


def model_flops(param_count: int, active_param_count: int, tokens: int,
                kind: str) -> float:
    """6·N·D for a train step (fwd+bwd), 2·N·D for inference, per step."""
    n = active_param_count
    if kind in ("train", "distill"):
        return 6.0 * n * tokens
    return 2.0 * n * tokens


def mfu(model_fl: float, roof: Roofline) -> float:
    return model_fl / (roof.step_time * roof.n_devices * roof.peak_flops)


# -- the hand-written kernels' work -----------------------------------------------

class KernelWork(tuple):
    """``(operations, bytes, operation type)``; ``note`` says what was
    assumed where the work depends on values the arguments do not hold."""

    def __new__(cls, ops: float, nbytes: float, op_type: str, note: str = ""):
        self = tuple.__new__(cls, (float(ops), float(nbytes), op_type))
        self.note = note
        return self

    @property
    def ops(self) -> float:
        return self[0]

    @property
    def nbytes(self) -> float:
        return self[1]

    @property
    def op_type(self) -> str:
        return self[2]

    def seconds(self) -> Tuple[float, str]:
        """(least time on one card, "bytes" or "operations"): the larger of
        the bytes over the HBM rate and the operations over their peak."""
        t_bytes = self.nbytes / HBM_BW
        t_ops = self.ops / PEAK_OPS[self.op_type]
        return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _size(t) -> int:
    return _numel(t.shape) * _itemsize(t.dtype)


def _values(t):
    """A tensor's values as a list, or None on the meta device."""
    return None if t.device.type == "meta" else t.tolist()


def _live_rows(block_tables):
    """Rows whose table is not all trash (``block_tables[b, 0] != 0``, the
    paged kernels' idle test); None on meta."""
    first = _values(block_tables[:, 0])
    return None if first is None else [r for r, b in enumerate(first) if b != 0]


def _w2a8(x, wp, delta, *_):
    m, k = x.shape
    n = wp.shape[-1]
    nbytes = _size(x) + _size(wp) + _size(delta) + m * n * _itemsize(x.dtype)
    return KernelWork(2.0 * m * k * n, nbytes, "int8")


def _w2a8_acc(x, wp, gamma, *_):
    """A row shard's accumulators: x, the packed rows and γ read, the fp32
    sums written."""
    m, k = x.shape
    n = wp.shape[-1]
    return KernelWork(2.0 * m * k * n, _size(x) + _size(wp) + _size(gamma)
                      + 4 * m * n, "int8")


def _bitlinear(x, w, *rest):
    """``bitlinear_kernel(x, wq, gamma, delta)`` (int8 codes in), the
    training op's ``bitlinear_forward(x, w, delta)`` (the master weight in;
    y, the activation codes, γ and the ternary codes out) or its
    row-parallel shard ``bitlinear_forward_acc(x, w, delta, gamma)`` (γ in;
    fp32 accumulators, the codes and the ternary codes out)."""
    m, k = x.shape
    n = w.shape[-1]
    out = m * n * _itemsize(x.dtype)
    ops = 2.0 * m * k * n
    if str(w.dtype).endswith("int8"):
        gamma, delta = rest[:2]
        return KernelWork(ops, _size(x) + _size(w) + _size(gamma)
                          + _size(delta) + out, "int8")
    delta = rest[0]
    if len(rest) > 1:               # the accumulators: γ read, fp32 out
        return KernelWork(ops, _size(x) + _size(w) + _size(delta)
                          + _size(rest[1]) + 4 * m * n + m * k + k * n, "int8")
    nbytes = (_size(x) + _size(w) + _size(delta) + out
              + m * k + 4 * m + k * n)
    return KernelWork(ops, nbytes, "int8")


def _paged_decode(q, k_new, v_new, k_pool, v_pool, block_tables, idx, *_):
    """The fused decode roofline's terms for the live rows, less the block
    rewrite: the CUDA kernel writes the new token's K/V row in place, where
    the Pallas kernel's scatter rewrote the whole current block.  Per live
    row: its resident positions ``< idx`` and the new K/V read, q in, ctx
    and the new K/V out; the scores and context over ``idx + 1`` keys."""
    b, hkv, g, dh = q.shape
    bs, width = k_pool.shape[2], block_tables.shape[1]
    item = _itemsize(k_pool.dtype)
    live = _live_rows(block_tables)
    note = ""
    if live is None:
        live, depths = list(range(b)), [width * bs - 1] * b
        note = "meta: every row live at the table's full width"
    else:
        pos = _values(idx)
        depths = [pos[r] for r in live]
    n = len(live)
    roof = paged_decode_attention_roofline(
        batch=n, resident_tokens=sum(depths) + n, table_width=width,
        block_size=bs, n_layers=1, n_q_heads=hkv * g, n_kv_heads=hkv,
        head_dim=dh, kv_bytes=item)
    rewrite = n * bs * 2 * hkv * dh * item
    return KernelWork(roof.flops, roof.bytes_accessed - rewrite, "bfloat16", note)


def _paged_prefill(q, k_chunk, v_chunk, k_pool, v_pool, block_tables, start,
                   lens, *_):
    """The fused chunk roofline's terms row by row for the live rows (each
    its own chunk of ``lens`` valid tokens against ``start`` resident
    positions), less the block rewrite, as for decode."""
    b, hkv, tg, dh = q.shape
    t = k_chunk.shape[2]
    g = tg // t
    bs, width = k_pool.shape[2], block_tables.shape[1]
    item = _itemsize(k_pool.dtype)
    live = _live_rows(block_tables)
    note = ""
    if live is None:
        rows = [(width * bs - t, t)] * b
        note = "meta: every row live, its chunk at the table's full width"
    else:
        st, ln = _values(start), _values(lens)
        rows = [(st[r], ln[r]) for r in live]
    ops = nbytes = 0.0
    for s0, n_tok in rows:
        roof = paged_prefill_attention_roofline(
            batch=1, chunk=n_tok, resident_tokens=s0, table_width=width,
            block_size=bs, n_layers=1, n_q_heads=hkv * g, n_kv_heads=hkv,
            head_dim=dh, kv_bytes=item)
        ops += roof.flops
        nbytes += roof.bytes_accessed - bs * 2 * hkv * dh * item
    return KernelWork(ops, nbytes, "bfloat16", note)


def _relation_kd(s, t, *_):
    """The two relation products (S·Sᵀ, T·Tᵀ) as 3xTF32: three TF32
    products for each fp32 one; s and t read once, the KL rows written."""
    bh, l, d = s.shape
    ops = 2 * 2.0 * bh * l * l * d
    return KernelWork(3 * ops, _size(s) + _size(t) + bh * l * 4, "tf32")


def chunk_len(s: int, chunk: int) -> int:
    """The largest divisor of ``s`` that is at most ``chunk`` (the SSD's
    chunk length, ``kernels/ssd_scan/ref.py::chunk_len``)."""
    q = min(chunk, s)
    while s % q:
        q -= 1
    return q


def _ssd_scan(x, a, dt, B, C, chunk=256, *_):
    """Per (bh, chunk) the causal half of M·x, Q(Q+1)·P, and C·h and the
    state update, 2·Q·N·P each; per (b, chunk) the causal half of C·Bᵀ,
    Q(Q+1)·N, which the heads share; as 3xTF32.  Bytes: x, a, dt, B, C read
    once, y and the final state written once."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    q = chunk_len(s, chunk)
    nc = s // q
    ops = (b * h * nc * (q * (q + 1) * p + 4.0 * q * n * p)
           + b * nc * q * (q + 1) * n)
    nbytes = 4 * (2 * _numel(x.shape) + 2 * _numel(a.shape)
                  + 2 * _numel(B.shape) + b * h * p * n)
    return KernelWork(3 * ops, nbytes, "tf32")


# wrapper name (its launch counter's) -> work of one call from its arguments
KERNELS = {
    "w2a8_gemv": _w2a8,
    "w2a8_forward_acc": _w2a8_acc,
    "paged_attention_decode": _paged_decode,
    "paged_prefill_chunk": _paged_prefill,
    "bitlinear": _bitlinear,
    "relation_kd": _relation_kd,
    "ssd_scan": _ssd_scan,
}


def kernel_work(name: str, *args) -> KernelWork:
    """(operations, bytes, operation type) of one call of kernel ``name``
    on the arguments its wrapper passes (``kernels/*/ops.py``):

    * ``w2a8_gemv``: (x [M, K], wp uint8 [K/4, N], delta);
    * ``bitlinear``: (x [M, K], wq int8 [K, N], γ [M, 1], delta) or
      (x [M, K], w [K, N] float, delta);
    * ``paged_attention_decode``: (q [B, Hkv, g, Dh], k_new, v_new, k_pool,
      v_pool, block_tables, idx, ...);
    * ``paged_prefill_chunk``: (q [B, Hkv, T·g, Dh], k_chunk [B, Hkv, T,
      Dh], v_chunk, k_pool, v_pool, block_tables, start, lens, ...);
    * ``relation_kd``: (s, t [BH, L, D], temp);
    * ``ssd_scan``: (x [b, S, H, P], a, dt [b, S, H], B, C [b, S, N], chunk).

    The paged pair's work depends on the rows' depths: read from ``idx`` /
    ``start`` and ``lens`` (a host read), or, on meta tensors, taken at the
    table's full width with every row live (``.note`` says so)."""
    if name not in KERNELS:
        raise KeyError(f"no work model for kernel {name!r}; known: {sorted(KERNELS)}")
    return KERNELS[name](*args)


def bound_ms(work: Iterable) -> Tuple[float, str]:
    """(least time in ms, "bytes" or "operations") of ``kernel_work``'s
    result (or any ``(ops, bytes, op type)``)."""
    ops, nbytes, op_type = work
    s, by = KernelWork(ops, nbytes, op_type).seconds()
    return s * 1e3, by


__all__ = ["PEAK_FLOPS_BF16", "PEAK_FLOPS_INT8", "PEAK_FLOPS_TF32",
           "PEAK_FLOPS_FP32", "HBM_BW", "NVLINK_BW", "IB_BW", "HBM_PER_CHIP",
           "PEAK_OPS", "CollectiveStats", "Roofline", "KernelWork",
           "bound_ms", "kernel_work", "link_bw", "mfu", "model_flops",
           "paged_decode_attention_roofline", "paged_prefill_attention_roofline",
           "plan_collectives", "ring_wire_bytes"]
