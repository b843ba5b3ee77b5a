"""Op-level cost of one call in eager PyTorch: the port's counterpart of
``repro/launch/hlo_analysis.py``.

XLA compiles a step into one HLO module, which JAX's analyzer walks
(fusions, while bodies times their trip counts).  Eager PyTorch runs the
step as a sequence of ATen ops, each its own kernel, so :func:`count` runs
``fn`` under a ``TorchDispatchMode`` and records, for one rank:

* ``flops`` — ``torch.utils.flop_counter``'s formulas (2·M·N·K for a
  matmul, as ``hlo_analysis._dot_flops``; convolutions and attention
  products likewise; elementwise ops count none, as in JAX's analyzer);
* ``hbm_bytes`` — operand and result bytes of every ATen op: each op is a
  kernel that reads its inputs from HBM and writes its outputs back, which
  is truer here than XLA's fusion model.  Views and aliasing ops cost
  nothing, an in-place or ``out=`` op counts its written operand once, an
  allocation without a write (``empty``) nothing, and an indexed read
  (``embedding``, ``index_select``, ``gather``, ``index``) its result twice
  and its indices, not the whole table;
* ``kernel_calls`` — per hand-written kernel (``kernels/boundary.py``):
  its calls, and their operations and bytes from
  ``roofline.kernel_work``.  ATen ops inside a kernel's boundary are not
  counted, so a kernel counts the same whether the CUDA route, the meta
  route or the plain version ran it;
* ``peak_live_bytes`` — the peak of live storage bytes, the arguments'
  included (``StorageWeakRef`` tracks each storage's lifetime; the
  arguments, which the caller holds, count throughout): the counterpart of
  ``memory_analysis()``.  Temporaries inside a kernel's
  boundary do not raise it; what the boundary returns does.

A Python loop is counted once per iteration, which is what JAX's analyzer
reaches with trip counts.  On meta tensors nothing is allocated or run, so
a full-size step counts in seconds on a CPU (``launch/dryrun.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch.kernels import boundary
from repro_torch.launch.roofline import kernel_work

aten = torch.ops.aten
_expired = torch.UntypedStorage._expired      # a storage's lifetime, by key

# allocations that write nothing
_NO_TRAFFIC = {aten.empty, aten.empty_like, aten.empty_strided, aten.new_empty,
               aten.new_empty_strided, aten.resize_, aten.set_}
# reads of a table's rows: (table argument index)
_INDEXED_READS = {aten.embedding: 0, aten.index_select: 0, aten.gather: 0,
                  aten.index: 0}


@dataclasses.dataclass
class OpCost:
    flops: float = 0.0
    hbm_bytes: float = 0.0
    kernel_calls: Dict[str, Dict[str, Any]] = dataclasses.field(default_factory=dict)
    peak_live_bytes: int = 0
    op_calls: Dict[str, int] = dataclasses.field(default_factory=dict)
    op_flops: Dict[str, float] = dataclasses.field(default_factory=dict)
    result: Any = dataclasses.field(default=None, repr=False, compare=False)

    @property
    def kernel_bytes(self) -> float:
        return sum(c["bytes"] for c in self.kernel_calls.values())

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(dataclasses.replace(self, result=None))
        d.pop("result")
        return d


def _tensors(tree) -> List[torch.Tensor]:
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _aliases(func) -> bool:
    """Any return that aliases an argument (a view, or an in-place / out=
    op's written operand)."""
    return any(r.alias_info is not None for r in func._schema.returns)


def _writes_alias(func) -> bool:
    return any(r.alias_info is not None and r.alias_info.is_write
               for r in func._schema.returns)


def op_bytes(func, args, kwargs, out) -> int:
    """HBM bytes of one ATen op (the rules in the module's docstring)."""
    packet = func.overloadpacket
    if packet in _NO_TRAFFIC:
        return 0
    if _aliases(func) and not _writes_alias(func):
        return 0                                   # a view
    if packet in _INDEXED_READS:
        table = _INDEXED_READS[packet]
        rest = [t for i, a in enumerate(args) if i != table
                for t in _tensors(a)] + _tensors(kwargs)
        return 2 * sum(_nbytes(t) for t in _tensors(out)) + \
            sum(_nbytes(t) for t in rest)
    ins = _tensors((args, kwargs))
    n = sum(_nbytes(t) for t in ins)
    if not _writes_alias(func):
        n += sum(_nbytes(t) for t in _tensors(out))
    return n


def _flop_formulas():
    from torch.utils.flop_counter import flop_registry
    return flop_registry


class _Counter(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.cost = OpCost()
        self.formulas = _flop_formulas()
        self.inside = 0
        self.live: Dict[int, Any] = {}         # storage key -> (weak ref, bytes)
        self.resident: Dict[int, Any] = {}     # the arguments' storages
        self.live_bytes = 0

    # -- storages --------------------------------------------------------------

    def track(self, tensors, resident: bool = False) -> bool:
        """Register the storages of ``tensors``; True if any was new.  The
        arguments' (``resident``) are held by the caller for the whole call
        and are not swept until its end."""
        from torch.multiprocessing.reductions import StorageWeakRef
        new = False
        for t in tensors:
            if not isinstance(t, torch.Tensor) or t.layout != torch.strided:
                continue
            st = t.untyped_storage()
            key = st._cdata
            if key in self.resident:
                continue
            held = self.live.get(key)
            if held is not None and not _expired(key):
                continue
            nb = st.nbytes()
            if held is not None:
                self.live_bytes -= held[1]
            (self.resident if resident else self.live)[key] = (StorageWeakRef(st), nb)
            self.live_bytes += nb
            new = True
        return new

    def sweep(self, everything: bool = False) -> None:
        for kept in ((self.live, self.resident) if everything else (self.live,)):
            dead = [k for k in kept if _expired(k)]
            for k in dead:
                self.live_bytes -= kept.pop(k)[1]
        self.cost.peak_live_bytes = max(self.cost.peak_live_bytes, self.live_bytes)

    # -- ops -------------------------------------------------------------------

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        new = self.track(_tensors(out))
        if self.inside:
            return out
        if new:
            self.sweep()
        name = str(func.overloadpacket)
        c = self.cost
        c.op_calls[name] = c.op_calls.get(name, 0) + 1
        f = self.formulas.get(func.overloadpacket)
        if f is not None:
            fl = float(f(*args, **kwargs, out_val=out))
            c.flops += fl
            c.op_flops[name] = c.op_flops.get(name, 0.0) + fl
        c.hbm_bytes += op_bytes(func, args, kwargs, out)
        return out

    def kernel_call(self, name: str, impl, args):
        work = kernel_work(name, *args)
        rec = self.cost.kernel_calls.setdefault(
            name, {"calls": 0, "flops": 0.0, "bytes": 0.0, "op_type": work.op_type})
        rec["calls"] += 1
        rec["flops"] += work.ops
        rec["bytes"] += work.nbytes
        if work.note:
            rec["note"] = work.note
        self.cost.flops += work.ops
        self.cost.hbm_bytes += work.nbytes
        self.inside += 1
        try:
            return impl(*args)
        finally:
            self.inside -= 1
            if not self.inside:
                self.sweep()


def resident_tensors(tree, _seen=None) -> List[torch.Tensor]:
    """Every tensor reachable from ``tree``: containers, NamedTuples,
    dataclasses, modules' parameters and buffers, and plain objects'
    attributes (one level of ``__dict__``)."""
    seen = set() if _seen is None else _seen
    out: List[torch.Tensor] = []

    def walk(x, depth):
        if id(x) in seen or depth > 8:
            return
        seen.add(id(x))
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, torch.nn.Module):
            out.extend(x.parameters())
            out.extend(x.buffers())
        elif isinstance(x, dict):
            for v in x.values():
                walk(v, depth + 1)
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v, depth + 1)
        elif dataclasses.is_dataclass(x) and not isinstance(x, type):
            for f in dataclasses.fields(x):
                walk(getattr(x, f.name), depth + 1)
        elif hasattr(x, "__dict__") and not callable(x):
            for v in vars(x).values():
                walk(v, depth + 1)

    walk(tree, 0)
    return out


def count(fn, *args, resident: Optional[Any] = None, **kwargs) -> OpCost:
    """Run ``fn(*args, **kwargs)`` once and count its ops (module
    docstring).  The storages of the arguments (and of ``resident``: what
    else the call keeps alive, e.g. the model) start the live set.  The
    call's result is kept in ``OpCost.result``."""
    if boundary.observer() is not None:
        raise RuntimeError("op_analysis.count does not nest")
    counter = _Counter()
    counter.track(resident_tensors((args, kwargs, resident)), resident=True)
    counter.sweep()
    boundary.set_observer(counter)
    try:
        with counter:
            out = fn(*args, **kwargs)
    finally:
        boundary.set_observer(None)
    counter.sweep(everything=True)
    counter.cost.result = out
    return counter.cost
