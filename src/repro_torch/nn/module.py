"""Module substrate: dtype policy, seeded initializers, device resolution.

Port of ``repro/nn/module.py``.  Parameters live in ``torch.nn.Module``s
instead of pytrees; initializers draw from an explicit ``torch.Generator`` so
a seeded init is reproducible on the card without JAX (the JAX and torch
streams differ — parity tests hand both packages the same numpy weights via
``repro_torch.bridge``).  ``flatten_with_paths`` names the leaves of a tree
of dicts, NamedTuples, tuples and lists as ``jax.tree_util`` does, which is
how checkpoints name them.  ``child_axes`` joins the logical axes of a
module's children (each module's ``param_axes()``: ``{tensor name: logical
axis names}``, the JAX modules' ``param_axes`` by the port's names).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn

Axes = Tuple[Optional[str], ...]


@dataclasses.dataclass(frozen=True)
class DTypePolicy:
    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.bfloat16
    # reductions / softmax / norms always accumulate in fp32.


DEFAULT_POLICY = DTypePolicy()

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def torch_dtype(name: Union[str, torch.dtype]) -> torch.dtype:
    """Config dtype name ("float32", "bfloat16", ...) -> torch dtype."""
    if isinstance(name, torch.dtype):
        return name
    if name not in _DTYPES:
        raise ValueError(f"unsupported dtype {name!r}; known: {sorted(_DTYPES)}")
    return _DTYPES[name]


def resolve_device(device: Union[str, torch.device, None] = None) -> torch.device:
    """``None`` means ``cuda``.  A CUDA device without a card raises: nothing
    quietly carries on on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch path")
    return dev


def truncated_normal_init(gen: torch.Generator, shape: Sequence[int], dtype,
                          stddev: float,
                          device: Optional[torch.device] = None) -> torch.Tensor:
    """Standard normal truncated to [-2, 2], times ``stddev`` (the JAX
    ``truncated_normal(-2, 2) * stddev`` contract, on a torch stream)."""
    w = torch.empty(tuple(shape), dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (w * stddev).to(dtype)


def fan_in_init(gen: torch.Generator, shape: Sequence[int], dtype,
                device: Optional[torch.device] = None) -> torch.Tensor:
    """LeCun-normal-ish: stddev = 1/sqrt(fan_in) with fan_in = shape[0..-2]."""
    fan_in = 1
    for d in shape[:-1]:
        fan_in *= d
    return truncated_normal_init(gen, shape, dtype, fan_in ** -0.5, device)


def child_axes(module: nn.Module) -> Dict[str, Axes]:
    """``param_axes()`` of ``module``'s children (a ``ModuleList``'s
    elements too), keyed by the tensors' names in ``module``."""
    out: Dict[str, Axes] = {}
    for name, child in module.named_children():
        sub = child_axes(child) if isinstance(child, nn.ModuleList) \
            else child.param_axes()
        out.update({f"{name}.{k}": v for k, v in sub.items()})
    return out


# ---------------------------------------------------------------------------
# trees: nested dicts, NamedTuples, tuples and lists of tensors (or arrays)
# ---------------------------------------------------------------------------

def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(node) -> Optional[Dict[str, Any]]:
    """``{path element: child}`` of an inner node in ``jax.tree_util``'s
    order (dict keys sorted, NamedTuple fields, sequence indices), or None
    for a leaf."""
    if isinstance(node, Mapping):
        return {str(k): node[k] for k in sorted(node)}
    if _is_namedtuple(node):
        return dict(zip(node._fields, node))
    if isinstance(node, (tuple, list)):
        return {str(i): v for i, v in enumerate(node)}
    return None


def flatten_with_paths(tree) -> Dict[str, Any]:
    """{'a/b/c': leaf} view used by checkpointing and debugging: dict keys,
    NamedTuple field names and sequence indices joined by ``/``, in the
    order ``jax.tree_util`` flattens the same tree."""
    flat: Dict[str, Any] = {}

    def walk(node, prefix):
        if node is None:               # an empty subtree, as in JAX
            return
        kids = _children(node)
        if kids is None:
            flat[prefix] = node
            return
        for k, v in kids.items():
            walk(v, f"{prefix}/{k}" if prefix else k)

    walk(tree, "")
    return flat


def tree_leaves(tree):
    return list(flatten_with_paths(tree).values())


def tree_unflatten(template, leaves):
    """A tree shaped like ``template`` holding ``leaves`` (in
    ``flatten_with_paths`` order): dicts stay dicts, NamedTuples their own
    type, tuples and lists theirs."""
    it = iter(leaves)

    def build(node):
        if node is None:
            return None
        if isinstance(node, Mapping):
            return {k: build(node[k]) for k in sorted(node)}
        if _is_namedtuple(node):
            return type(node)(*[build(v) for v in node])
        if isinstance(node, (tuple, list)):
            return type(node)(build(v) for v in node)
        return next(it)

    return build(template)


def count_params(params) -> int:
    return sum(int(np.prod(x.shape)) for x in tree_leaves(params))


def tree_bytes(params) -> int:
    return sum(int(np.prod(x.shape)) * (x.element_size() if torch.is_tensor(x)
                                        else x.dtype.itemsize)
               for x in tree_leaves(params))
