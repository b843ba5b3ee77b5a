"""Map a JAX parameter pytree (as numpy arrays) onto the port's modules, and
back.

The JAX ``CausalLM`` keeps each pattern position's block params stacked over
repeats (``stack/pos{i}/...`` leaves are ``[repeats, ...]``,
``repro/nn/transformer.py:285-293``); the port has one module per layer, so
leaf ``stack/pos{i}/<path>`` row ``r`` becomes ``stack.layers.{l}.<path>``
with ``l = r * len(pattern) + i``.  Every other leaf maps by path
(``embed/table`` -> ``embed.table``).  FP, QAT (``w``, SubLN ``scale``)
and packed trees all map this way.  Both directions are checked: a JAX leaf
with no port tensor, or a port tensor with no JAX leaf, raises.
``jax_params_from_torch`` is the reverse map, so tests can compare trained
parameters leaf by leaf.  The checkpoint format of
``repro/checkpoint/ckpt.py`` is not read here yet.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Union

import numpy as np
import torch

from repro_torch.models import CausalLM, ModelConfig, build_model
from repro_torch.nn.module import resolve_device


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    flat: Dict[str, np.ndarray] = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            flat.update(_flatten(v, path))
        else:
            flat[path] = np.asarray(v)
    return flat


def torch_state_from_jax(cfg: ModelConfig, params_np: Mapping) -> Dict[str, np.ndarray]:
    """JAX param tree -> {port state-dict key: numpy array}."""
    n_pat = len(cfg.resolved_pattern())
    state: Dict[str, np.ndarray] = {}
    for path, leaf in _flatten(params_np).items():
        parts = path.split("/")
        if parts[0] == "stack":
            pos = int(parts[1][len("pos"):])
            rest = ".".join(parts[2:])
            if leaf.shape[0] != cfg.repeats:
                raise ValueError(f"{path}: leading dim {leaf.shape[0]} != "
                                 f"repeats {cfg.repeats}")
            for r in range(cfg.repeats):
                state[f"stack.layers.{r * n_pat + pos}.{rest}"] = leaf[r]
        else:
            state[".".join(parts)] = leaf
    return state


def jax_params_to_torch(cfg: ModelConfig, params_np: Mapping,
                        device: Union[str, torch.device, None] = None,
                        model: Optional[CausalLM] = None) -> CausalLM:
    """Build the port's ``CausalLM`` for ``cfg`` on ``device`` (default
    ``cuda``) holding the JAX params ``params_np`` (numpy leaves)."""
    dev = resolve_device(device)
    if model is None:
        model = build_model(cfg, device=dev)
    src = torch_state_from_jax(cfg, params_np)
    dst = model.state_dict()
    missing = sorted(set(dst) - set(src))
    extra = sorted(set(src) - set(dst))
    if missing or extra:
        raise KeyError(f"param trees differ: port-only {missing[:8]}, "
                       f"JAX-only {extra[:8]}")
    with torch.no_grad():
        for key, t in dst.items():
            a = src[key]
            if tuple(a.shape) != tuple(t.shape):
                raise ValueError(f"{key}: JAX shape {a.shape} != port "
                                 f"{tuple(t.shape)}")
            t.copy_(torch.from_numpy(np.array(a)).to(t.dtype))
    return model


def jax_params_from_torch(cfg: ModelConfig, model: CausalLM) -> Dict:
    """The port model's tensors as the JAX param tree (nested dicts of numpy
    arrays, block leaves stacked ``[repeats, ...]``)."""
    n_pat = len(cfg.resolved_pattern())
    state = {k: v.detach().cpu().numpy() for k, v in model.state_dict().items()}
    tree: Dict = {}

    def put(path, leaf):
        node = tree
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = leaf

    stacked: Dict[tuple, list] = {}
    for key, leaf in state.items():
        parts = key.split(".")
        if parts[:2] == ["stack", "layers"]:
            layer = int(parts[2])
            rep, pos = divmod(layer, n_pat)
            path = ("stack", f"pos{pos}", *parts[3:])
            stacked.setdefault(path, [None] * cfg.repeats)[rep] = leaf
        else:
            put(tuple(parts), leaf)
    for path, rows in stacked.items():
        put(path, np.stack(rows))
    return tree
