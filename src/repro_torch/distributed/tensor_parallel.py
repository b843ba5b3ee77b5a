"""Tensor parallelism over the plan's ``"model"`` axis: the collectives of
the split route (the CE and distill steps of every family,
``training/trainer.py``, and the prefill and decode steps,
``launch/specs.py``).

JAX has no module for this: GSPMD inserts the collectives from the
parameters' shardings.  Here a :class:`Split` holds, for one step, the plan,
each parameter's spec and this rank's coordinates, and the modules ask it
what to compute (``active()``).  Under a split a module computes on its
parameters' ``"model"`` shards (its heads, ``d_ff`` columns, vocabulary
slice, experts and SSM heads), with Megatron's pair at the edges of each
split region:

* ``copy_to`` (*f*): the identity forward, an all-reduce of ``dx`` backward,
  at the input of the column-parallel projections;
* ``reduce_from`` (*g*): an all-reduce forward, the identity backward, at a
  row-parallel output (downstream every rank computes the same values);

beside ``all_reduce_sum`` (both ways: SubLN's sum of squares, which each
rank then uses on its own columns), ``Split.all_max`` (no gradient: γ and
the loss's row maximum), ``Split.sum64`` (a scale's float64 sum of |W|),
``Split.acc_sum`` (*g* on a row-parallel kernel's accumulators) and
``gather_heads`` (an all-gather whose backward takes the rank's own slice:
the relation states, from which every rank computes the same loss; a
decode step's logits, joined whole over the vocabulary).
``using(module)`` swaps a module's parameters for their compute copies for
the duration of a block (``param_copy``): each gathered along the plan's
other axes (FSDP: an all-gather forward, a reduce-scatter of the gradient
backward) with its ``"model"`` shard kept, but those used whole: the kv
projections where their heads do not divide over the ranks, and what a
module names in its ``tp_whole(spec_of)`` (Mamba2's ``in_proj`` and conv,
whose flat shards cut through their z | x | B | C | dt groups; an
expert-split MoE's SubLN scale, which every expert uses whole).  A tensor
used whole is gathered over ``"model"`` too and its gradient, a partial sum
on each rank, reduce-scattered back to the shards (summed where the plan
replicates it).  A packed layer's buffers (``w_packed``, ``delta``) are
registered and swapped as parameters are, without a gradient.

Inference holds the rank's shards (``shard_model``: each tensor cut to its
share under the plan, its whole shape remembered) and a decode cache placed
by the plan from the model's ``cache_axes()`` (``Split.place_cache``): an
attention cache split by kv heads where they divide over ``"model"``, else
by positions (``"kv_seq"``), else whole; a Mamba2 state by heads and its
conv tail by channels.  The layers read each cache tensor's spec
(``Split.cache_spec``) to take their part of it.

Over more than one rank every reduction whose value depends on the order
of its terms takes its exact form (``exact()``): the QAT product
(``core/bitlinear.py``), SubLN's sum of squares and the MoE combine
(``nn/moe.py``), and a decode step's attention sums (``nn/attention.py``:
float64, the ranks' merge over a cache split by positions among them), so
that the ranks' shares sum to the unsharded value in any order.  A group
of one rank moves nothing: every collective is then the
identity, and each reduction the split route computes falls back to its
unsharded form, so a one-rank step is the plain step bit for bit.  Under a
shapes-only plan (``{axis: size}``, meta tensors) a collective returns a
tensor of its result's shape.  Every collective over more than one rank
appends itself to the active ``recording()`` (kind, axis, group size,
result bytes), which ``launch/roofline.py::plan_collectives`` counts; the
Megatron pair also counts its calls in ``counter`` (one rank too).
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.distributed.sharding import is_axes, linear_part, local_shape

MODEL = "model"
# the logical axes the split computes on a "model" shard of (ShardingPlan
# rules): each must be split over "model" where it appears, but that an
# expert weight takes "model" on its "expert" dim or, where the experts do
# not divide over the ranks, on its "mlp" dim; and the kv projections',
# computed whole when the kv heads do not divide over the ranks (the plan
# may still store them split, mid-head)
SPLIT_AXES = ("heads", "mlp", "vocab", "expert", "ssm_heads", "ssm_inner",
              "ssm_in", "ssm_conv")
EXPERT_AXES = ("expert", "mlp")
KV_AXES = ("kv_heads",)
# replicated parameters each "model" rank uses on its own share of the
# activations: their gradients are partial sums over the axis
PARTIAL_AXES = ("kv_heads", "head_dim")


@dataclasses.dataclass
class Counter:
    """Calls of the Megatron pair, one rank or more: *f* and *g*."""
    f: int = 0
    g: int = 0

    def reset(self) -> None:
        self.f = self.g = 0

    @property
    def count(self) -> int:
        return self.f + self.g


counter = Counter()
_record: List[Optional[list]] = [None]
_ACTIVE: List[Optional["Split"]] = [None]


@contextlib.contextmanager
def recording():
    """Collect every collective issued over more than one rank."""
    prev, _record[0] = _record[0], []
    try:
        yield _record[0]
    finally:
        _record[0] = prev


@dataclasses.dataclass(frozen=True)
class ParamSplit:
    spec: Tuple[Tuple[str, ...], ...]   # per dim, the mesh axes splitting it
    shape: Tuple[int, ...]              # the whole tensor's
    partial: bool                       # replicated; its gradient sums over "model"
    whole: bool                         # stored split over "model", used whole


class Split:
    """One step's split: ``plan`` (a ``ShardingPlan``), the ``"model"``
    axis' size and this rank's coordinate on it, each registered
    parameter's :class:`ParamSplit` and the batch axes of the current
    micro-batch (set by the step)."""

    def __init__(self, plan):
        self.plan = plan
        self.shape: Dict[str, int] = dict(plan.shape)
        self.mesh = None if isinstance(plan.mesh, Mapping) else plan.mesh
        coord = [0] * len(self.shape) if self.mesh is None else \
            self.mesh.get_coordinate()
        self.coord = dict(zip(self.shape, coord))
        self.size = self.shape.get(MODEL, 1)
        self.rank = self.coord.get(MODEL, 0)
        self.batch_axes: Tuple[str, ...] = ()
        self.params: Dict[int, Tuple[torch.Tensor, ParamSplit]] = {}
        self.kv_whole = False
        self.caches: Dict[int, Tuple[torch.Tensor, Tuple]] = {}
        self._parts: Dict[Tuple, Optional[str]] = {}

    # -- parameters --------------------------------------------------------------

    def register(self, model, local: bool = False) -> None:
        """Resolve the spec of each of ``model``'s parameters and packed
        buffers (placed by the plan, or with ``local`` already cut to the
        rank's shard: ``shard_model``) and check that the split takes it:
        heads, ``d_ff`` columns, the padded vocabulary, the SSM heads and
        widths, and the experts (or, failing them, their ``d_ff``) must
        divide over ``"model"``.  Where the kv heads do not (fewer kv heads
        than ranks), each rank projects all of them: the kv tensors are used
        whole, their gradients summed; so are the tensors a module's
        ``tp_whole`` names."""
        axes = model.param_axes()
        if any(getattr(m, "n_kv_heads", 0) % self.size for m in model.modules()):
            self.kv_whole = True
        shapes, specs = {}, {}
        tensors = dict(named_tensors(model))
        for name, p in tensors.items():
            shapes[name] = tuple(p.shape) if not local else tuple(p._tp_whole)
            specs[name] = self.plan.spec(axes[name], shapes[name], record=False)
        used_whole = set()
        for prefix, m in model.named_modules():
            if hasattr(m, "tp_whole"):
                pre = f"{prefix}." if prefix else ""
                used_whole.update(pre + n for n in m.tp_whole(
                    lambda n, pre=pre: specs[pre + n]))
        for name, p in tensors.items():
            logical, shape, spec = axes[name], shapes[name], specs[name]
            if self.size > 1 and name not in used_whole:
                _check_split(name, logical, shape, spec, self.size)
            on_model = any(MODEL in s for s in spec)
            kv = any(a in KV_AXES for a in logical)
            whole = (on_model and kv and self.kv_whole) or name in used_whole
            partial = (not on_model and not whole
                       and any(a in PARTIAL_AXES for a in logical))
            self.params[id(p)] = (p, ParamSplit(spec, shape, partial, whole))

    def linear_part(self, logical: Sequence[Optional[str]],
                    shape: Sequence[int]) -> Optional[str]:
        """``"col"`` or ``"row"`` for a linear layer whose weight of
        ``logical`` axes and whole ``shape`` the rank computes on a
        ``"model"`` shard of (``sharding.linear_part``), or None (used
        whole)."""
        key = (tuple(logical), tuple(shape))
        if key not in self._parts:
            part = linear_part(self.plan.spec(logical, shape, record=False))
            if self.kv_whole and any(a in KV_AXES for a in logical):
                part = None
            self._parts[key] = part
        return self._parts[key]

    def kv_range(self, n_heads: int, n_kv: int) -> Tuple[int, int]:
        """The kv heads the rank's query heads read when the kv projections
        are replicated: ``[lo, hi)`` of the ``n_kv``."""
        per = n_heads // self.size
        g = n_heads // n_kv
        if per % g and g % per:
            raise ValueError(f"{n_heads} query heads over {self.size} ranks give "
                             f"{per} a rank, which straddle the groups of {g} "
                             f"query heads of each of the {n_kv} kv heads")
        lo = self.rank * per // g
        return lo, max(lo + 1, (self.rank + 1) * per // g)

    # -- decode caches -----------------------------------------------------------

    def index(self, axes: Sequence[str]) -> int:
        """The rank's index among the shards of a dim split over ``axes``."""
        return _index(axes, self.shape, self.coord)

    def local_of(self, t: torch.Tensor, spec, whole: Sequence[int]) -> torch.Tensor:
        """The rank's share of ``t`` under ``spec``, cut along each dim
        that ``t`` holds whole (of ``whole`` size) and ``spec`` splits."""
        spec = tuple(a if t.shape[d] == whole[d] else () for d, a in enumerate(spec))
        return cut(t, spec, self.shape, self.coord)

    def place_cache(self, cache, axes, device=None):
        """The rank's decode cache: ``cache`` whole (its shapes; meta
        tensors do), each leaf placed by the plan from ``axes``
        (``model.cache_axes()``, the same tree): a zero tensor of the rank's
        shape on ``device`` (as ``torch.zeros`` takes it), registered for
        :meth:`cache_spec`."""
        if is_axes(axes):
            spec = self.plan.spec(axes, tuple(cache.shape), record=False)
            shape = local_shape(cache.shape, spec, self.shape)
            local = torch.zeros(shape, dtype=cache.dtype, device=device)
            local._tp_whole = tuple(cache.shape)
            self.caches[id(local)] = (local, spec)
            return local
        if isinstance(axes, Mapping):
            return {k: self.place_cache(cache[k], a, device) for k, a in axes.items()}
        return [self.place_cache(c, a, device) for c, a in zip(cache, axes)]

    def cache_spec(self, t: torch.Tensor):
        """The spec of a cache tensor :meth:`place_cache` made."""
        entry = self.caches.get(id(t))
        if entry is None or entry[0] is not t:
            raise ValueError("a decode under a split takes a cache placed by it "
                             "(init_cache under the split, Split.place_cache); "
                             f"this one ({tuple(t.shape)}) was not")
        return entry[1]

    # -- collectives (see the module's docstring) ------------------------------------

    def axis_size(self, axis: str) -> int:
        return self.shape.get(axis, 1)

    def group(self, axis: str):
        return self.mesh.get_group(axis)

    def _meta(self, t: torch.Tensor) -> bool:
        if self.mesh is None and t.device.type != "meta":
            raise ValueError("a shapes-only plan runs on meta tensors only")
        return self.mesh is None

    def _note(self, kind: str, axis: str, t: torch.Tensor) -> None:
        if _record[0] is not None:
            _record[0].append((kind, axis, self.axis_size(axis),
                               t.numel() * t.element_size()))

    def all_reduce(self, t: torch.Tensor, axis: str = MODEL,
                   op: str = "sum") -> torch.Tensor:
        """A new tensor: ``t`` reduced over ``axis`` (``sum``, ``avg`` or
        ``max``)."""
        n = self.axis_size(axis)
        if n == 1:
            return t
        self._note("all-reduce", axis, t)
        out = t.contiguous().clone()
        if self._meta(t):
            return out
        rop = dist.ReduceOp.MAX if op == "max" else dist.ReduceOp.SUM
        dist.all_reduce(out, op=rop, group=self.group(axis))
        return out / n if op == "avg" else out

    def all_gather(self, t: torch.Tensor, axis: str, dim: int) -> torch.Tensor:
        """The ranks' ``t`` along ``axis`` joined along ``dim``, in the
        order of their coordinates."""
        n = self.axis_size(axis)
        if n == 1:
            return t
        x = t.movedim(dim, 0).contiguous()
        out = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
        self._note("all-gather", axis, out)
        if not self._meta(t):
            dist.all_gather_into_tensor(out, x, group=self.group(axis))
        return out.movedim(0, dim)

    def reduce_scatter(self, t: torch.Tensor, axis: str, dim: int,
                       op: str = "sum") -> torch.Tensor:
        """``t`` summed (or averaged) over ``axis``; the rank's chunk along
        ``dim``."""
        n = self.axis_size(axis)
        if n == 1:
            return t
        x = t.movedim(dim, 0).contiguous()
        out = x.new_empty((x.shape[0] // n,) + tuple(x.shape[1:]))
        self._note("reduce-scatter", axis, out)
        if not self._meta(t):
            dist.reduce_scatter_tensor(out, x, group=self.group(axis))
            if op == "avg":
                out = out / n
        return out.movedim(0, dim)

    def own(self, t: torch.Tensor, axis: str, dim: int) -> torch.Tensor:
        n = self.axis_size(axis)
        return t if n == 1 else t.chunk(n, dim=dim)[self.coord[axis]]

    def all_max(self, t: torch.Tensor, axis: str = MODEL) -> torch.Tensor:
        """``t`` (no gradient) maximized over ``axis``."""
        return self.all_reduce(t.detach(), axis, "max")

    def sum64(self, t: torch.Tensor) -> torch.Tensor:
        """A float64 value (no gradient: a scale's) summed over
        ``"model"``."""
        return self.all_reduce(t.detach(), MODEL, "sum")

    def acc_sum(self, t: torch.Tensor) -> torch.Tensor:
        """*g* on a row-parallel kernel's integer accumulators (exact in
        fp32 in any order); the caller's autograd function passes the
        gradient through."""
        counter.g += 1
        return self.all_reduce(t, MODEL, "sum")


def _check_split(name, logical, shape, spec, size) -> None:
    """Raise unless every dim of a :data:`SPLIT_AXES` axis is split over
    ``"model"`` (an expert weight's experts or, else, its ``d_ff``)."""
    if "expert" in logical:
        if any(MODEL in spec[d] for d, a in enumerate(logical) if a in EXPERT_AXES):
            return
        raise ValueError(
            f"{name}: neither its experts ({shape[logical.index('expert')]}) nor "
            f"their d_ff ({shape[logical.index('mlp')]}) divide over the {size} "
            f"ranks of \"model\" (spec {spec}); the split route computes a "
            "rank's experts, or each expert's d_ff columns")
    for d, a in enumerate(logical):
        if a in SPLIT_AXES and MODEL not in spec[d]:
            if name.endswith("w_packed") and d == 0:
                raise ValueError(
                    f"{name}: a packed layer's row shard holds K/tp input rows, "
                    f"four to a byte: its {shape[0]} packed rows (K = "
                    f"{4 * shape[0]}) do not divide over the {size} ranks of "
                    f"\"model\" (K/tp must be divisible by 4)")
            raise ValueError(
                f"{name}: its {a!r} dim ({shape[d]}) is not split over the {size} "
                f"ranks of \"model\" (spec {spec}); the split route takes heads, "
                "d_ff, the padded vocabulary and the SSM heads and widths "
                "divisible by the \"model\" axis")


def active() -> Optional[Split]:
    return _ACTIVE[0]


def exact() -> bool:
    """Whether the active split spans more than one rank, where the
    order-dependent reductions take their exact forms (see the module's
    docstring)."""
    split = _ACTIVE[0]
    return split is not None and split.size > 1


@contextlib.contextmanager
def activated(split: Optional[Split]):
    prev, _ACTIVE[0] = _ACTIVE[0], split
    try:
        yield split
    finally:
        _ACTIVE[0] = prev


# -- differentiable collectives -------------------------------------------------------

class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, split, axis, op):
        ctx.split, ctx.axis, ctx.op = split, axis, op
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.split.all_reduce(g, ctx.axis, ctx.op), None, None, None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, split):
        return split.all_reduce(x, MODEL, "sum")

    @staticmethod
    def backward(ctx, g):
        return g, None


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, split):
        ctx.split = split
        return split.all_reduce(x, MODEL, "sum")

    @staticmethod
    def backward(ctx, g):
        return ctx.split.all_reduce(g, MODEL, "sum"), None


class _GatherOwn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, split, dim):
        ctx.split, ctx.dim = split, dim
        return split.all_gather(x, MODEL, dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.split.own(g, MODEL, ctx.dim), None, None


class _ParamGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, split, axis, dim, op):
        ctx.split, ctx.axis, ctx.dim, ctx.op = split, axis, dim, op
        return split.all_gather(x, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return (ctx.split.reduce_scatter(g, ctx.axis, ctx.dim, ctx.op),
                None, None, None, None)


def copy_to(x: torch.Tensor) -> torch.Tensor:
    """*f* over ``"model"``; the identity without an active split."""
    split = _ACTIVE[0]
    if split is None:
        return x
    counter.f += 1
    if split.size == 1:
        return x
    return _CopyTo.apply(x, split, MODEL, "sum")


def reduce_from(x: torch.Tensor) -> torch.Tensor:
    """*g* over ``"model"``; the identity without an active split."""
    split = _ACTIVE[0]
    if split is None:
        return x
    counter.g += 1
    if split.size == 1:
        return x
    return _ReduceFrom.apply(x, split)


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    split = _ACTIVE[0]
    if split is None or split.size == 1:
        return x
    return _AllReduceSum.apply(x, split)


def gather_heads(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The ranks' shards of ``x`` (heads, vocabulary columns) joined along
    ``dim``; the gradient of the rank's own slice comes back (each rank
    computes the same loss)."""
    split = _ACTIVE[0]
    if split is None or split.size == 1:
        return x
    return _GatherOwn.apply(x, split, dim)


# -- parameters at use ----------------------------------------------------------------

def param_copy(split: Split, p: torch.Tensor, info: ParamSplit) -> torch.Tensor:
    """The compute copy of a registered parameter: its local share (a
    DTensor's ``to_local``, whose gradient returns to the placements), all
    the plan's axes but ``"model"`` gathered (``"model"`` too where
    ``info.whole``), its gradient reduced over each of them (summed over the
    batch axes and ``"model"``, averaged over the others) and, when
    ``info.partial``, summed over ``"model"``."""
    x = p.to_local() if hasattr(p, "to_local") else p
    grad = torch.is_grad_enabled() and p.requires_grad
    for axis in split.shape:
        if split.axis_size(axis) == 1 or (axis == MODEL and not info.whole):
            continue
        op = "sum" if axis in split.batch_axes or axis == MODEL else "avg"
        dims = [d for d, s in enumerate(info.spec) if axis in s]
        if dims:
            x = (_ParamGather.apply(x, split, axis, dims[0], op) if grad
                 else split.all_gather(x, axis, dims[0]))
        elif grad:
            x = _CopyTo.apply(x, split, axis, op)
    if info.partial and grad and split.size > 1:
        x = _CopyTo.apply(x, split, MODEL, "sum")
    return x


_NULL = contextlib.nullcontext()


def using(module):
    """Within the block, ``module``'s registered parameters (its children's
    too) are their compute copies; without an active split, nothing."""
    split = _ACTIVE[0]
    if split is None:
        return _NULL
    return _using(split, module)


@contextlib.contextmanager
def _using(split: Split, module):
    swapped = []
    try:
        for m in module.modules():
            for store in (m._parameters, m._buffers):
                for name, p in list(store.items()):
                    entry = split.params.get(id(p)) if p is not None else None
                    if entry is None or entry[0] is not p:
                        continue
                    store[name] = param_copy(split, p, entry[1])
                    swapped.append((store, name, p))
        yield
    finally:
        for store, name, p in swapped:
            store[name] = p


def named_tensors(model):
    """``model``'s parameters and the buffers its ``param_axes()`` names (a
    packed layer's ``w_packed`` and ``delta``), by name."""
    axes = model.param_axes()
    yield from model.named_parameters()
    for name, b in model.named_buffers():
        if name in axes:
            yield name, b


def _index(axes: Sequence[str], shape: Mapping[str, int],
           coord: Mapping[str, int]) -> int:
    """A rank's index among the shards of a dim split over ``axes``
    (DTensor's chunk order: the mesh's axes outermost first)."""
    i = 0
    for a in shape:
        if a in axes:
            i = i * shape[a] + coord[a]
    return i


def cut(t: torch.Tensor, spec, shape: Mapping[str, int],
        coord: Mapping[str, int]) -> torch.Tensor:
    """The share of ``t`` under ``spec`` of the rank at ``coord`` on a mesh
    of ``shape`` (a view)."""
    for d, axes in enumerate(spec):
        n = 1
        for a in axes:
            n *= shape[a]
        if n > 1:
            size = t.shape[d] // n
            t = t.narrow(d, _index(axes, shape, coord) * size, size)
    return t


def shard_model(model, plan, coord: Optional[Mapping[str, int]] = None) -> None:
    """Cut each of ``model``'s parameters and packed buffers (alike on every
    rank) to the rank's share under ``plan`` (every axis of its spec), as
    plain tensors remembering their whole shape (``_tp_whole``), for
    ``Split.register(model, local=True)``: the share of the rank at
    ``coord`` (default: this rank's on the plan's mesh), or on a
    shapes-only plan without ``coord`` a meta tensor of the rank's shape."""
    from repro_torch.nn.layers import Embedding
    axes = model.param_axes()
    if coord is None and not isinstance(plan.mesh, Mapping):
        coord = dict(zip(plan.shape, plan.mesh.get_coordinate()))
    for name, t in list(named_tensors(model)):
        *path, attr = name.split(".")
        owner = model.get_submodule(".".join(path))
        spec = plan.spec(axes[name], tuple(t.shape), record=False)
        if coord is None:
            local = torch.empty(local_shape(t.shape, spec, plan.shape),
                                dtype=t.dtype, device="meta")
        else:
            local = cut(t.detach(), spec, plan.shape, coord).contiguous()
        if attr in owner._parameters:
            local = torch.nn.Parameter(local, requires_grad=t.requires_grad)
            owner._parameters[attr] = local
        else:
            owner._buffers[attr] = local
        local._tp_whole = tuple(t.shape)
    for m in model.modules():
        if isinstance(m, Embedding):     # the rank's rows as the compute copy
            m._refresh()
