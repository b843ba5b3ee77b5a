"""Map a JAX parameter pytree (as numpy arrays) onto the port's modules, and
back; and the port's ``TrainState`` to and from the JAX ``TrainState``
layout that checkpoints hold.

The JAX ``CausalLM`` keeps each pattern position's block params stacked over
repeats (``stack/pos{i}/...`` leaves are ``[repeats, ...]``,
``repro/nn/transformer.py:285-293``); the port has one module per layer, so
leaf ``stack/pos{i}/<path>`` row ``r`` becomes ``stack.layers.{l}.<path>``
with ``l = r * len(pattern) + i``.  An ``EncDecLM`` has two such stacks,
each of pattern length 1: ``encoder/pos0/...`` ``[n_encoder_layers, ...]``
becomes ``encoder.layers.{l}.*`` and ``decoder/stack/pos0/...``
``[n_layers, ...]`` becomes ``decoder.stack.layers.{l}.*``.  Every other
leaf maps by path (``embed/table`` -> ``embed.table``, ``frontend/w`` ->
``frontend.w``).  FP, QAT (``w``, SubLN ``scale``)
and packed trees all map this way.  Both directions are checked: a JAX leaf
with no port tensor, or a port tensor with no JAX leaf, raises.
``jax_params_from_torch`` is the reverse map, so tests can compare trained
parameters leaf by leaf.

The train state maps the same way, onto ``repro/training/trainer.py::
TrainState``: ``params/...``, ``opt_state/step``, ``opt_state/m/...`` and
``opt_state/v/...`` (a blockwise int8 moment is a ``Moment8`` with leaves
``code`` and ``scale``, stacked like its parameter) and ``step``, both steps
int32 0-d.  ``train_state_to_jax`` builds that tree (``device="meta"``
gives a shape-only template for ``checkpoint.load_checkpoint``) and
``load_train_state`` copies such a tree into a live ``TrainState``, so a
checkpoint of either package resumes in the port, on one device or into a
state placed by any sharding plan (each rank copies its share of every
leaf).  ``torch_axes_from_jax`` maps JAX's logical-axes trees
(``param_axes``, ``state_axes``) to the port's names the same way.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Mapping, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from repro_torch.distributed.sharding import is_dtensor, local_chunk
from repro_torch.models import ModelConfig, build_model
from repro_torch.models.encdec import decoder_config
from repro_torch.nn.module import resolve_device
from repro_torch.training.optimizer import Moment8
from repro_torch.training.trainer import TrainState


class JaxAdamWState(NamedTuple):
    """``repro/training/optimizer.py::AdamWState``'s fields, in its order."""
    step: Any
    m: Any
    v: Any


class JaxTrainState(NamedTuple):
    """``repro/training/trainer.py::TrainState``'s fields, in its order."""
    params: Any
    opt_state: JaxAdamWState
    step: Any


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, Any]:
    """{'a/b': leaf} of a tree of dicts (a ``Moment8`` is a leaf here)."""
    flat: Dict[str, Any] = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            flat.update(_flatten(v, path))
        else:
            flat[path] = v
    return flat


def _rows(leaf, r: int):
    if isinstance(leaf, Moment8):
        return Moment8(leaf.code[r], leaf.scale[r])
    return leaf[r]


def _stacks(cfg: ModelConfig) -> List[Tuple[Tuple[str, ...], str, int, int]]:
    """(JAX path of the stack, the port's name of its layer list, pattern
    length, repeats) of each stack of ``cfg``'s model."""
    if cfg.n_encoder_layers > 0:
        dec = decoder_config(cfg)
        return [(("encoder",), "encoder.layers", 1, cfg.n_encoder_layers),
                (("decoder", "stack"), "decoder.stack.layers",
                 len(dec.resolved_pattern()), dec.repeats)]
    return [(("stack",), "stack.layers", len(cfg.resolved_pattern()), cfg.repeats)]


def _split_rows(path: str, leaf, repeats: int) -> list:
    lead = (leaf.code if isinstance(leaf, Moment8) else leaf).shape[0]
    if lead != repeats:
        raise ValueError(f"{path}: leading dim {lead} != repeats {repeats}")
    return [_rows(leaf, r) for r in range(repeats)]


def _drop_layers(path: str, axes) -> tuple:
    """A stacked leaf's logical axes without JAX's leading ``"layers"`` (a
    ``Moment8`` of axes, either package's, as the port's)."""
    if hasattr(axes, "_fields"):
        return Moment8(_drop_layers(path, axes.code), _drop_layers(path, axes.scale))
    if not axes or axes[0] != "layers":
        raise ValueError(f"{path}: stacked leaf's axes {axes} do not start "
                         "with 'layers'")
    return tuple(axes[1:])


def _port_leaves(cfg: ModelConfig, tree: Mapping,
                 split: Callable[[str, Any, int], list] = _split_rows
                 ) -> Dict[str, Any]:
    """JAX-layout tree -> {port state-dict key: leaf}; ``split`` gives a
    stacked leaf's rows (views, by default)."""
    stacks = _stacks(cfg)
    state: Dict[str, Any] = {}
    for path, leaf in _flatten(tree).items():
        parts = path.split("/")
        for jax_at, port_at, n_pat, repeats in stacks:
            if tuple(parts[:len(jax_at)]) == jax_at:
                break
        else:
            state[".".join(parts)] = leaf
            continue
        pos = int(parts[len(jax_at)][len("pos"):])
        rest = ".".join(parts[len(jax_at) + 1:])
        for r, row in enumerate(split(path, leaf, repeats)):
            state[f"{port_at}.{r * n_pat + pos}.{rest}"] = row
    return state


def torch_axes_from_jax(cfg: ModelConfig, axes_tree: Mapping) -> Dict[str, Any]:
    """JAX's ``param_axes()`` tree (or one moment tree of ``state_axes``)
    -> {port tensor name: logical axes}: a stacked leaf's axes lose their
    leading ``"layers"`` (never sharded) and go to each of its layers."""
    return _port_leaves(cfg, axes_tree,
                        lambda path, ax, repeats: [_drop_layers(path, ax)] * repeats)


def _jax_tree(cfg: ModelConfig, named: Mapping[str, Any],
              stack: Callable[[list], Any]) -> Dict:
    """{port key: leaf} -> the JAX-layout nested dict, block leaves joined
    over repeats by ``stack``."""
    stacks = _stacks(cfg)
    tree: Dict = {}

    def put(path, leaf):
        node = tree
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = leaf

    stacked: Dict[tuple, list] = {}
    for key, leaf in named.items():
        for jax_at, port_at, n_pat, repeats in stacks:
            if key.startswith(port_at + "."):
                layer, *rest = key[len(port_at) + 1:].split(".")
                rep, pos = divmod(int(layer), n_pat)
                path = (*jax_at, f"pos{pos}", *rest)
                stacked.setdefault(path, [None] * repeats)[rep] = leaf
                break
        else:
            put(tuple(key.split(".")), leaf)
    for path, rows in stacked.items():
        put(path, stack(rows))
    return tree


def _check_keys(what: str, port: Mapping, jax: Mapping) -> None:
    missing = sorted(set(port) - set(jax))
    extra = sorted(set(jax) - set(port))
    if missing or extra:
        raise KeyError(f"{what} trees differ: port-only {missing[:8]}, "
                       f"JAX-only {extra[:8]}")


def torch_state_from_jax(cfg: ModelConfig, params_np: Mapping) -> Dict[str, np.ndarray]:
    """JAX param tree -> {port state-dict key: numpy array}."""
    return {k: np.asarray(v) for k, v in _port_leaves(cfg, params_np).items()}


def jax_params_to_torch(cfg: ModelConfig, params_np: Mapping,
                        device: Union[str, torch.device, None] = None,
                        model: Optional[nn.Module] = None) -> nn.Module:
    """Build the port's model for ``cfg`` (``build_model``: a ``CausalLM``
    or an ``EncDecLM``) on ``device`` (default ``cuda``) holding the JAX
    params ``params_np`` (numpy leaves)."""
    dev = resolve_device(device)
    if model is None:
        model = build_model(cfg, device=dev)
    src = torch_state_from_jax(cfg, params_np)
    dst = model.state_dict()
    _check_keys("param", dst, src)
    with torch.no_grad():
        for key, t in dst.items():
            a = src[key]
            if tuple(a.shape) != tuple(t.shape):
                raise ValueError(f"{key}: JAX shape {a.shape} != port "
                                 f"{tuple(t.shape)}")
            t.copy_(_tensor(a).to(t.dtype))
    return model


def _tensor(a) -> torch.Tensor:
    """A numpy leaf as a CPU tensor; JAX's bfloat16 arrays (numpy has the
    dtype only through ml_dtypes) by their bits."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def jax_params_from_torch(cfg: ModelConfig, model: nn.Module) -> Dict:
    """The port model's tensors as the JAX param tree (nested dicts of numpy
    arrays, block leaves stacked ``[repeats, ...]``; a bf16 tensor comes
    back as its exact fp32 values, numpy having no bfloat16 of its own)."""
    state = {k: (v.float() if v.dtype == torch.bfloat16 else v).detach().cpu().numpy()
             for k, v in model.state_dict().items()}
    return _jax_tree(cfg, state, np.stack)


# ---------------------------------------------------------------------------
# the train state
# ---------------------------------------------------------------------------

def train_state_to_jax(cfg: ModelConfig, state: TrainState,
                       device: Union[str, torch.device, None] = None
                       ) -> JaxTrainState:
    """The port's ``TrainState`` as the JAX ``TrainState`` tree of tensors
    (on ``device``, default: where they are; block leaves stacked, so those
    are copies, the others the live tensors).  DTensor leaves (a state
    placed by a sharding plan) are gathered whole, so every rank of their
    mesh must call this; with ``device="meta"`` they only give shapes."""
    def leaf(t):
        t = t.detach()
        if is_dtensor(t):
            t = (torch.empty(t.shape, dtype=t.dtype, device="meta")
                 if torch.device(device or "cpu").type == "meta" else t.full_tensor())
        return t if device is None else t.to(device)

    def one(x):
        return Moment8(leaf(x.code), leaf(x.scale)) if isinstance(x, Moment8) \
            else leaf(x)

    def stack(rows):
        if isinstance(rows[0], Moment8):
            return Moment8(torch.stack([leaf(r.code) for r in rows]),
                           torch.stack([leaf(r.scale) for r in rows]))
        return torch.stack([leaf(r) for r in rows])

    def tree(named):
        return _jax_tree(cfg, {k: one(v) for k, v in named.items()}, stack)

    dev = device if device is not None else next(iter(state.params.values())).device
    step = lambda s: torch.tensor(s, dtype=torch.int32, device=dev)
    opt = state.opt_state
    return JaxTrainState(tree(state.params),
                         JaxAdamWState(step(opt.step), tree(opt.m), tree(opt.v)),
                         step(state.step))


def _copy_leaf(key: str, dst, src) -> None:
    if isinstance(dst, Moment8) != isinstance(src, Moment8):
        raise ValueError(f"{key}: one side holds an int8 Moment8, the other "
                         "a float moment (AdamWConfig.state_dtype differs)")
    pairs = (zip(("/code", "/scale"), dst, src) if isinstance(dst, Moment8)
             else [("", dst, src)])
    for part, d, s in pairs:
        if tuple(s.shape) != tuple(d.shape):
            raise ValueError(f"{key}{part}: JAX shape {tuple(s.shape)} != "
                             f"port {tuple(d.shape)}")
        if is_dtensor(d):      # a placed leaf takes its rank's share
            s = local_chunk(s, d.device_mesh, d.placements)
            d = d.to_local()
        d.copy_(s)


@torch.no_grad()
def load_train_state(cfg: ModelConfig, tree: JaxTrainState,
                     state: TrainState) -> TrainState:
    """Copy a JAX-layout train state (``train_state_to_jax``'s structure,
    e.g. from ``load_checkpoint``) into ``state`` in place: parameters and
    moments keep their tensors, the steps are set."""
    opt = state.opt_state
    for what, dst, src in (("param", state.params, tree.params),
                           ("opt_state/m", opt.m, tree.opt_state.m),
                           ("opt_state/v", opt.v, tree.opt_state.v)):
        src = _port_leaves(cfg, src)
        _check_keys(what, dst, src)
        for key, d in dst.items():
            _copy_leaf(key, d, src[key])
    state.opt_state = opt._replace(step=int(tree.opt_state.step))
    state.step = int(tree.step)
    return state
