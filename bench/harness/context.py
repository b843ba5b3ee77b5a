"""What a driver (``harness/serve.py``, ``harness/distill.py``) is given and
hands back: the cell, the run's arguments, the device, and the checks that
decide ``correct``."""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from harness.record import Run
from harness.spec import Cell


@dataclasses.dataclass
class Check:
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value == self.value and self.value <= self.limit


@dataclasses.dataclass
class Context:
    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: str
    t_start: float
    checks: List[Check] = dataclasses.field(default_factory=list)
    attempted: int = 0
    failed: int = 0
    memory_peak_bytes: int = 0
    run: Optional[Run] = None
    readings: Dict[str, object] = dataclasses.field(default_factory=dict)

    @property
    def config(self) -> dict:
        return self.cell.config

    @property
    def traffic(self) -> dict:
        return self.cell.traffic

    def limit(self, name: str) -> float:
        """A check's limit, from the traffic mix's ``limits``."""
        return float(self.traffic["limits"][name])

    def check(self, name: str, value: float) -> None:
        """Compare ``value`` with its limit; a number the mix gives no limit
        (it has no upper reading: see PERF.md) is kept as a reading."""
        if name in self.traffic["limits"]:
            self.checks.append(Check(name, float(value), self.limit(name)))
        else:
            self.readings[name + " (not compared)"] = float(value)

    def sync(self) -> None:
        if self.device == "cuda":
            import torch
            torch.cuda.synchronize()


def port_config(cfg: dict):
    """The program's ``ModelConfig`` for a configuration file: the port's
    architecture, its widths and depth as the file states them."""
    from repro_torch.models import get_config
    from harness.weights import vocab_rows
    port = cfg["port"]
    base = get_config(port["arch"])
    if cfg["family"] == "dense":
        kw = dict(n_layers=cfg["num_hidden_layers"], d_model=cfg["hidden_size"],
                  n_heads=cfg["num_attention_heads"],
                  n_kv_heads=cfg["num_key_value_heads"], head_dim=cfg["head_dim"],
                  d_ff=cfg["intermediate_size"], vocab=vocab_rows(cfg))
        assert base.qk_norm and base.tie_embeddings and base.activation == "silu"
        assert base.rope_theta == float(cfg["rope_theta"])
    else:
        kw = dict(n_layers=cfg["n_layer"], d_model=cfg["d_model"],
                  ssm_state=cfg["d_state"], ssm_head_dim=cfg["headdim"],
                  ssm_chunk=cfg["chunk_size"], vocab=vocab_rows(cfg))
        assert base.tie_embeddings and cfg["expand"] == 2 and cfg["d_conv"] == 4
    return base.replace(compute_dtype=port["compute_dtype"],
                        param_dtype=port["param_dtype"], **kw)
