"""What one run leaves for the metric readers (``bench/metrics/*.py``)."""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from harness import work
from harness.trace import DeviceTrace, KernelCalls, Spans


def percentile(values: List[float], q: float) -> Optional[float]:
    """The ``q``-th percentile, linear between closest ranks (numpy's
    default); None without values."""
    if not values:
        return None
    v = sorted(values)
    pos = (len(v) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


@dataclasses.dataclass
class Request:
    """A served request on the benchmark's clock: when it was submitted,
    the time of each token it received, the tokens, how it ended."""
    uid: int
    prompt: List[int]
    max_tokens: int
    submit: float = 0.0
    times: List[float] = dataclasses.field(default_factory=list)
    tokens: List[int] = dataclasses.field(default_factory=list)
    reason: Optional[str] = None


@dataclasses.dataclass
class Run:
    cell: str
    config: dict
    traffic: dict
    seconds: float
    t_open: float = 0.0
    t_close: float = 0.0
    setup_s: float = 0.0
    trace: bool = False
    requests: List[Request] = dataclasses.field(default_factory=list)
    steps: List[dict] = dataclasses.field(default_factory=list)
    spans: Spans = dataclasses.field(default_factory=Spans)
    kernels: KernelCalls = dataclasses.field(default_factory=KernelCalls)
    device: DeviceTrace = dataclasses.field(default_factory=DeviceTrace)
    tracer: object = None                 # the program's serving Tracer
    extra: Dict[str, object] = dataclasses.field(default_factory=dict)

    @property
    def window_s(self) -> float:
        return self.t_close - self.t_open

    def inside(self, t: float) -> bool:
        return self.t_open <= t <= self.t_close

    def kernel_roofline_pct(self, kernel: str, names,
                            work_of=work.kernel_work) -> Optional[float]:
        """100 x the least time of the window's calls of ``kernel`` (their
        work by ``work_of``: the frozen arithmetic, or a reader's own for a
        kernel it does not know) over the device time of the CUDA kernels
        whose names hold one of ``names``; None when either is missing."""
        works = self.kernels.works(kernel, work_of) if self.trace else None
        measured = self.device.seconds_of(names) if self.trace else None
        if not works or not measured:
            return None
        return 100.0 * work.least_seconds(works) / measured
