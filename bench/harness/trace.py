"""What the traced run (``--trace 1``) records around the window.

* :class:`Spans`: the benchmark's own host spans (``client``,
  ``engine.plan``, ``engine.commit``, ``trainer.step``, ...), on the host
  clock, recorded from the benchmark's files around its calls into the
  program.
* :class:`KernelCalls`: an observer installed through the program's
  ``kernels/boundary.py::set_observer``; it records each kernel call's
  argument shapes and, for the paged kernels, device copies of the small
  index tensors, and never synchronises.  After the window the benchmark
  reads them and counts each call's work with ``harness/work.py``.
* :class:`DeviceTrace`: the profiler's device events over the window, and
  the CUDA runtime calls (kept in memory and reduced to sums,
  never written out).
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

from harness import work


class Spans:
    """Host spans (name, start, end) on ``time.perf_counter``."""

    def __init__(self):
        self.items: List[Tuple[str, float, float]] = []

    def add(self, name: str, t0: float, t1: float) -> None:
        self.items.append((name, t0, t1))

    def wrap(self, obj, attr: str, name: str) -> None:
        """Record every call of ``obj.attr`` as a span ``name``."""
        fn = getattr(obj, attr)
        items = self.items

        def wrapped(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                items.append((name, t0, time.perf_counter()))
        setattr(obj, attr, wrapped)

    def active_at(self, t: float) -> str:
        """The innermost span holding ``t`` (the latest to start), or
        ``other`` when none does."""
        best, start = "other", -1.0
        for name, t0, t1 in self.items:
            if t0 <= t <= t1 and t0 > start:
                best, start = name, t0
        return best


class KernelCalls:
    """``set_observer``'s observer: each call of a hand-written kernel
    recorded as (name, args), args as :class:`work.Arg` (values copied on
    the device, read after the window)."""

    def __init__(self):
        self.calls: List[Tuple[str, list]] = []
        self.recording = False

    def kernel_call(self, name, impl, args):
        if self.recording:
            self.calls.append((name, self._summary(name, args)))
        return impl(*args)

    @staticmethod
    def _summary(name, args):
        import torch
        want = work.VALUE_ARGS.get(name, {})
        out = []
        for i, a in enumerate(args):
            if torch.is_tensor(a):
                vals = None
                if i in want:
                    vals = (a[:, 0] if want[i] == "first_column" else a).clone()
                out.append(work.Arg(tuple(a.shape), str(a.dtype).replace("torch.", ""),
                                    vals))
            else:
                out.append(a)
        return out

    def works(self, kernel: str, work_of=work.kernel_work) -> List[work.Work]:
        """The work of each recorded call of ``kernel`` (the program's
        kernel name) by ``work_of(name, args)``: the frozen arithmetic, or
        a metric reader's own for a kernel it does not know.  Other
        kernels' calls are not counted."""
        out = []
        for name, args in self.calls:
            if name != kernel:
                continue
            for a in args:
                if isinstance(a, work.Arg) and a.values is not None \
                        and not isinstance(a.values, list):
                    a.values = a.values.tolist()
            out.append(work_of(name, args))
        return out


class DeviceTrace:
    """The device's kernels and copies over the window, from the profiler
    (CUDA activity), kept in memory and reduced to sums.  ``events`` are
    (name, start, end) in seconds on ``time.perf_counter``'s scale;
    ``runtime`` are the CUDA runtime and driver calls (``cudaLaunchKernel``,
    ``cudaMemcpyAsync``, ...) on the same scale: a call that waits for the
    device's queue to drain lasts as long as it waits.  The profiler gives
    them no thread of the process, so the one call that another thread
    makes, the serving loop's ``cudaEventSynchronize`` on its executor, is
    left out by name; the loop's own thread waits on no event."""

    def __init__(self):
        self._prof = None
        self.device = "cuda"
        self.events: List[Tuple[str, float, float]] = []
        self.runtime: List[Tuple[str, float, float]] = []
        self.window: Tuple[float, float] = (0.0, 0.0)

    def start(self, device: str = "cuda") -> None:
        """Start recording the device's activity (on a CPU-only run, the
        tests', the CPU's: nothing of it is a device metric)."""
        import torch
        act = torch.profiler.ProfilerActivity
        self._prof = torch.profiler.profile(
            activities=[act.CUDA if device == "cuda" else act.CPU])
        self._prof.__enter__()

    def stop(self, t_open: float, t_close: float, device: str = "cuda") -> None:
        """Stop, and keep the device events and the runtime calls, mapped from the profiler's clock (nanoseconds of
        ``time.time_ns``) onto ``perf_counter``.  The raw events are read
        as the profiler left them, without building its per-operator
        tables."""
        self._prof.__exit__(None, None, None)
        offset = time.perf_counter() - time.time_ns() * 1e-9
        raw, runtime = [], []
        for e in self._prof.profiler.kineto_results.events():
            s = e.start_ns() * 1e-9 + offset
            item = (e.name(), s, s + e.duration_ns() * 1e-9)
            if ("CUDA" in str(e.device_type())) == (device == "cuda"):
                raw.append(item)
            elif e.name().startswith("cu") and e.name() != "cudaEventSynchronize":
                runtime.append(item)
        self._prof = None
        self.device = device
        self.window = (t_open, t_close)
        self.events = sorted(raw, key=lambda e: e[1])
        self.runtime = sorted(runtime, key=lambda e: e[1])

    @staticmethod
    def overlap(items, spans) -> float:
        """Seconds of ``items`` (name, start, end) inside ``spans`` ((start,
        end), none overlapping another)."""
        spans = sorted(spans)
        total, i = 0.0, 0
        for _, s, e in sorted(items, key=lambda x: x[1]):
            while i < len(spans) and spans[i][1] <= s:
                i += 1
            j = i
            while j < len(spans) and spans[j][0] < e:
                total += max(0.0, min(e, spans[j][1]) - max(s, spans[j][0]))
                j += 1
        return total

    def clipped(self) -> List[Tuple[str, float, float]]:
        t0, t1 = self.window
        return [(n, max(s, t0), min(e, t1)) for n, s, e in self.events
                if e > t0 and s < t1]

    def busy_s(self) -> float:
        """The union of the device events' intervals inside the window."""
        busy, end = 0.0, None
        for _, s, e in self.clipped():
            if end is None or s > end:
                busy += e - s
                end = e
            elif e > end:
                busy += e - end
                end = e
        return busy

    def gaps(self) -> List[Tuple[float, float]]:
        """The idle intervals inside the window."""
        t0, t1 = self.window
        out, end = [], t0
        for _, s, e in self.clipped():
            if s > end:
                out.append((end, s))
            end = max(end, e)
        if t1 > end:
            out.append((end, t1))
        return out

    def by_name(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for n, s, e in self.clipped():
            out[n] = out.get(n, 0.0) + (e - s)
        return out

    def seconds_of(self, names) -> Optional[float]:
        """Device seconds of the events whose name holds one of ``names``,
        or None when none ran."""
        hit = [e - s for n, s, e in self.clipped() if any(k in n for k in names)]
        return sum(hit) if hit else None

    def breakdown(self, spans: Spans) -> dict:
        top = sorted(self.by_name().items(), key=lambda kv: -kv[1])[:10]
        gaps = sorted(self.gaps(), key=lambda g: g[0] - g[1])[:10]
        return {"device_ops": [[n, s] for n, s in top],
                "idle_gaps": [[spans.active_at((a + b) / 2), b - a] for a, b in gaps]}
