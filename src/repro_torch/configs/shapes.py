"""Assigned input shapes (LM-family: seq_len x global_batch).

``decode_*`` / ``long_*`` lower ``serve_step`` (one new token against a KV /
SSM-state cache of ``seq``), not ``train_step``.  ``long_500k`` requires
sub-quadratic sequence mixing and therefore only runs for SSM/hybrid archs
(DESIGN.md §4); the dry-run records an explicit skip for the others.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq: int
    global_batch: int
    kind: str                    # "train" | "prefill" | "decode"


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}

LONG_CONTEXT_FAMILIES = ("ssm", "hybrid")


def applicable(family: str, shape: str) -> bool:
    if shape == "long_500k":
        return family in LONG_CONTEXT_FAMILIES
    return True


def all_cells(configs, shapes=None) -> Tuple[Tuple[str, str, bool], ...]:
    """[(arch, shape, applicable)] — the 40-cell grid."""
    shapes = shapes or list(SHAPES)
    out = []
    for c in configs:
        for s in shapes:
            out.append((c.name, s, applicable(c.family, s)))
    return tuple(out)
