"""Logical-axis sharding rules with divisibility fallback — port of
``repro/distributed/sharding.py``.

Every parameter / activation / cache tensor carries a tuple of *logical*
axis names (each module's ``param_axes()``).  A rule maps a logical name to
an ordered list of candidate mesh-axis tuples; the first candidate whose
axes (a) the mesh has, (b) are not already used by another dim of the same
tensor and (c) evenly divide the dim wins.  Dims are resolved in *priority*
order (batch first, TP dims next, sequence, then FSDP), and every fallback
from a rule's first candidate is recorded in ``ShardingPlan.fallbacks`` in
JAX's words.

Where JAX returns a ``PartitionSpec``, ``ShardingPlan.spec`` returns one
tuple of mesh-axis names per tensor dim (``()`` = replicated), and
``placements`` maps it to DTensor placements on the plan's
``torch.distributed.device_mesh.DeviceMesh``: ``Shard(d)`` on each mesh dim
that splits tensor dim ``d``, ``Replicate()`` on the others.  A plan over a
plain ``{axis: size}`` mapping resolves specs without devices (shapes only).

``local_shape`` and ``local_chunk`` give a rank's shape and share of a
tensor under a spec, and ``linear_part`` says which part of a linear layer
a spec makes it: column-parallel where ``"model"`` splits the weight's out
axis, row-parallel where it splits the in axis.  The port's sharded steps
(``training/trainer.py``) compute on plain local tensors, their rows of the
batch: each rank computes on its ``"model"`` shards
(``distributed/tensor_parallel.py``, every family), each block's
parameters gathered along the other axes at its use.

``constrain`` is JAX's activation hint.  The split has no layout to hint: a
plain tensor comes back as it is, a DTensor is redistributed to the logical
names' placements, and with no active plan every argument comes back
unchanged.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import torch

Axes = Tuple[str, ...]
Candidates = Tuple[Axes, ...]
Spec = Tuple[Axes, ...]          # per tensor dim: the mesh axes splitting it

# priority: lower = assigned earlier (grabs mesh axes first)
_PRIORITY: Dict[str, int] = {
    "batch": 0,
    "expert": 10, "heads": 10, "mlp": 11, "vocab": 12, "kv_heads": 13,
    "ssm_inner": 10, "ssm_heads": 10,
    "kv_seq": 30, "seq": 30,
    "embed": 40, "ssm_in": 41, "embed_out": 45,
}


def default_rules(multi_pod: bool) -> Dict[str, Candidates]:
    batch: Candidates = ((("pod", "data"), ("data",), ()) if multi_pod
                         else (("data",), ()))
    return {
        # activations / caches
        "batch": batch,
        "seq": ((), ),
        "seq_sp": ((), ),        # (("model",),) = Megatron-SP
        "kv_seq": (("model",), ("data",), ()),
        "act_embed": ((), ),
        # params: tensor-parallel dims
        "heads": (("model",), ()),
        "kv_heads": (("model",), ()),
        "mlp": (("model",), ()),
        "vocab": (("model",), ("data",), ()),
        "expert": (("model",), ()),
        "ssm_inner": (("model",), ()),
        "ssm_heads": (("model",), ()),
        "ssm_in": (("model",), ()),
        # params: FSDP dims
        "embed": (("data",), ()),
        "embed_out": ((), ),
        # never sharded
        "layers": ((), ),
        "head_dim": ((), ),
        "ssm_state": ((), ),
        "ssm_conv": (("model",), ()),
        "conv_k": ((), ),
        "expert_router": ((), ),
    }


def mesh_shape(mesh) -> Dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` or of a plain mapping."""
    if isinstance(mesh, Mapping):
        return {str(k): int(v) for k, v in mesh.items()}
    return {name: mesh.size(i) for i, name in enumerate(mesh.mesh_dim_names)}


def is_axes(t) -> bool:
    """A leaf of an axes tree: a plain tuple of names (``None`` allowed)."""
    return (isinstance(t, tuple) and not hasattr(t, "_fields")
            and all(isinstance(e, (str, type(None))) for e in t))


def is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


def local_shape(shape: Sequence[int], spec: Spec,
                mesh_shape: Mapping[str, int]) -> Tuple[int, ...]:
    """A rank's shape of a tensor of whole ``shape`` under ``spec``."""
    out = []
    for d, axes in zip(shape, spec):
        for a in axes:
            d //= mesh_shape[a]
        out.append(d)
    return tuple(out)


def linear_part(spec: Spec, axis: str = "model") -> Optional[str]:
    """The part of a linear layer whose ``[in, out]`` weight has ``spec``:
    ``"col"`` (column-parallel: ``axis`` splits the out axis), ``"row"``
    (row-parallel: it splits the in axis) or None."""
    if axis in spec[1]:
        return "col"
    if axis in spec[0]:
        return "row"
    return None


def local_chunk(t: torch.Tensor, mesh, placements) -> torch.Tensor:
    """This rank's share of the whole tensor ``t`` under ``placements``:
    DTensor's ``Shard`` semantics (``torch.chunk``, mesh dims in order)."""
    coord = mesh.get_coordinate()
    for i, p in enumerate(placements):
        if p.is_shard():
            t = t.chunk(mesh.size(i), dim=p.dim)[coord[i]]
    return t


@dataclasses.dataclass
class ShardingPlan:
    mesh: Any                      # DeviceMesh, or {axis: size} for shapes only
    rules: Dict[str, Candidates]
    fallbacks: List[str] = dataclasses.field(default_factory=list)
    shape: Dict[str, int] = dataclasses.field(init=False)

    def __post_init__(self):
        self.shape = mesh_shape(self.mesh)

    def _axis_size(self, axes: Axes) -> int:
        s = 1
        for a in axes:
            s *= self.shape[a]
        return s

    def spec(self, logical: Sequence[Optional[str]],
             shape: Sequence[int], record: bool = True) -> Spec:
        """Resolve one tensor's spec: per dim, the mesh axes splitting it.
        ``record=False`` keeps its fallbacks out of ``self.fallbacks`` (a
        step resolving its batch each time)."""
        if len(logical) != len(shape):
            raise ValueError(f"logical axes {tuple(logical)} do not match "
                             f"shape {tuple(shape)}")
        order = sorted(range(len(logical)),
                       key=lambda i: _PRIORITY.get(logical[i] or "", 50))
        used: set = set()
        assign: Dict[int, Axes] = {}
        for i in order:
            name = logical[i]
            if name is None:
                continue
            cands = self.rules.get(name, ((),))
            chosen: Axes = ()
            for cand in cands:
                if any(a not in self.shape for a in cand):
                    continue  # candidate names an axis this mesh lacks
                if any(a in used for a in cand):
                    continue
                if cand and shape[i] % self._axis_size(cand) != 0:
                    continue
                chosen = cand
                break
            if record and chosen != (cands[0] if cands else ()):
                self.fallbacks.append(
                    f"{name}[{shape[i]}] -> {chosen or 'replicated'}")
            assign[i] = chosen
            used.update(chosen)
        return tuple(assign.get(i, ()) for i in range(len(logical)))

    def placements(self, spec: Spec) -> list:
        """DTensor placements of ``spec``, one per mesh dim."""
        from torch.distributed.tensor import Replicate, Shard
        out = []
        for axis in self.shape:
            dims = [d for d, axes in enumerate(spec) if axis in axes]
            out.append(Shard(dims[0]) if dims else Replicate())
        return out

    def place(self, t: torch.Tensor, logical: Sequence[Optional[str]]):
        """The whole tensor ``t`` (alike on every rank) as a DTensor on the
        mesh: each rank keeps its share, without communication."""
        from torch.distributed.tensor import DTensor
        pl = self.placements(self.spec(logical, t.shape))
        return DTensor.from_local(local_chunk(t, self.mesh, pl).contiguous(),
                                  self.mesh, pl, run_check=False)

    # -- trees (dicts, ``Moment8``-like NamedTuples) -----------------------------

    def tree_specs(self, axes_tree: Any, shape_tree: Any) -> Any:
        """``axes_tree``'s leaves are tuples of logical names;
        ``shape_tree``'s, at the same places, anything with ``.shape``."""
        if is_axes(axes_tree):
            return self.spec(axes_tree, shape_tree.shape)
        if isinstance(axes_tree, Mapping):
            if set(axes_tree) != set(shape_tree):
                raise KeyError(f"axes and shapes name different leaves: "
                               f"{sorted(set(axes_tree) ^ set(shape_tree))[:8]}")
            return {k: self.tree_specs(a, shape_tree[k]) for k, a in axes_tree.items()}
        if hasattr(axes_tree, "_fields"):
            return type(axes_tree)(*[self.tree_specs(a, s)
                                     for a, s in zip(axes_tree, shape_tree)])
        raise TypeError(f"not an axes tree: {axes_tree!r}")

    def constrain(self, x: torch.Tensor, logical: Sequence[Optional[str]]):
        """A DTensor redistributed to ``logical``'s placements; a plain
        tensor as it is (see the module's docstring)."""
        from torch.distributed.tensor import DTensor
        if not isinstance(x, DTensor):
            return x
        return x.redistribute(self.mesh, self.placements(self.spec(logical, x.shape)))


# -- activation-constraint context (no-op when unset) -------------------------------

_ACTIVE_PLAN: List[Optional[ShardingPlan]] = [None]


def set_plan(plan: Optional[ShardingPlan]):
    _ACTIVE_PLAN[0] = plan


def get_plan() -> Optional[ShardingPlan]:
    return _ACTIVE_PLAN[0]


def constrain(x: torch.Tensor, logical: Sequence[Optional[str]]) -> torch.Tensor:
    plan = _ACTIVE_PLAN[0]
    if plan is None:
        return x
    return plan.constrain(x, logical)
