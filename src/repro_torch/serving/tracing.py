"""Per-request and per-step span tracing with Chrome trace-event export.

A :class:`Tracer` attached to the engine (``engine.tracer``; ``None`` by
default, so the hot path pays one attribute check when tracing is off)
records two families of spans from timestamps the engine already takes
through its :class:`~repro_torch.serving.telemetry.Clock`:

* **engine track** (pid 1) — one span per ``plan_step`` /
  ``launch_step`` / device-busy window / ``commit_step`` call, on
  separate threads so the async double-buffer overlap is visible: a
  speculative ``device`` span of step N+1 starts *before* step N's
  ``commit`` span ends.  The off-thread host sync in
  ``AsyncEngine._loop`` gets its own ``sync`` track.
* **request track** (pid 2, one thread per request uid) — the request's
  lifecycle: a ``queued`` span (submit → admission), ``prefill_chunk``
  spans (one per chunk the scheduler advanced in a committed step), a
  ``first_token`` instant, and a root ``request`` span (submit →
  finish) whose args carry the finish reason and token count.

``export()`` produces Chrome trace-event JSON (the
``{"traceEvents": [...]}`` flavor) loadable in Perfetto / chrome://
tracing; ``repro_torch.analysis.tracecheck`` validates the schema in CI.

Span accounting reconciles exactly with
:class:`~repro_torch.serving.api.EngineStats`: ``counts["request"]`` ==
``requests_submitted``, ``counts["step"]`` == ``steps_committed``,
``counts["prefill_chunk"]`` == ``prefill_chunks`` (the benchmark
``--trace`` mode gates on this).  :meth:`open_requests` must be empty
after a drained run — an unclosed request span is a lifecycle bug.

Pure stdlib; no numpy/torch (this module is reachable from the lint's hot
step path and must stay host-sync-free).  Event storage grows with the
traced run — tracing is an opt-in debugging tool, not an always-on
metric (those live in :mod:`repro_torch.serving.telemetry`).

Port of ``repro/serving/tracing.py``, copied with the package renamed.
"""
from __future__ import annotations

import json
from typing import Dict, List, Optional

from repro_torch.serving.telemetry import Clock

__all__ = ["Tracer", "PID_ENGINE", "PID_REQUESTS"]

PID_ENGINE = 1
PID_REQUESTS = 2

# engine-track thread ids, ordered the way Perfetto should stack them
TID_PLAN = 1
TID_LAUNCH = 2
TID_DEVICE = 3
TID_SYNC = 4
TID_COMMIT = 5

_ENGINE_THREADS = {
    TID_PLAN: "plan",
    TID_LAUNCH: "launch",
    TID_DEVICE: "device",
    TID_SYNC: "sync",
    TID_COMMIT: "commit",
}


class Tracer:
    """Records spans as Chrome trace events.  All ``t*`` arguments are
    engine-clock seconds; the tracer rebases them to microseconds from
    the first event so traces start at t=0."""

    def __init__(self, clock: Optional[Clock] = None):
        self.clock = clock or Clock()
        self._events: List[dict] = []
        self._epoch: Optional[float] = None
        # span accounting, reconciled against EngineStats by the bench
        self.counts: Dict[str, int] = {
            "request": 0, "step": 0, "prefill_chunk": 0,
        }
        # uid -> {"tid", "submit", "admitted"} for requests still in flight
        self._open: Dict[int, dict] = {}
        self._req_tid: Dict[int, int] = {}
        self._next_req_tid = 1

    # -- time ---------------------------------------------------------------

    def _us(self, t: float) -> float:
        if self._epoch is None:
            self._epoch = t
        return (t - self._epoch) * 1e6

    def _complete(self, name: str, pid: int, tid: int,
                  t0: float, t1: float, cat: str, args: Optional[dict]) -> None:
        ts = self._us(t0)
        ev = {"name": name, "cat": cat, "ph": "X", "ts": ts,
              "dur": max(0.0, self._us(t1) - ts), "pid": pid, "tid": tid}
        if args:
            ev["args"] = args
        self._events.append(ev)

    def _instant(self, name: str, pid: int, tid: int, t: float,
                 cat: str, args: Optional[dict]) -> None:
        ev = {"name": name, "cat": cat, "ph": "i", "ts": self._us(t),
              "pid": pid, "tid": tid, "s": "t"}
        if args:
            ev["args"] = args
        self._events.append(ev)

    # -- engine track -------------------------------------------------------

    def plan_span(self, t0, t1, step, active, chunks, spec=False):
        self._complete("plan", PID_ENGINE, TID_PLAN, t0, t1, "step",
                       {"step": step, "active": active, "chunks": chunks,
                        "spec": spec})

    def launch_span(self, t0, t1, step, spec=False):
        self._complete("launch", PID_ENGINE, TID_LAUNCH, t0, t1, "step",
                       {"step": step, "spec": spec})

    def device_span(self, t0, t1, step, spec=False):
        """Device-busy window: launch dispatch to host-visible sync.  With
        speculative launch this overlaps the previous step's commit."""
        self._complete("device", PID_ENGINE, TID_DEVICE, t0, t1, "step",
                       {"step": step, "spec": spec})

    def sync_span(self, t0, t1, step):
        """The off-thread ``np.asarray`` host sync in ``AsyncEngine._loop``."""
        self._complete("sync", PID_ENGINE, TID_SYNC, t0, t1, "step",
                       {"step": step})

    def commit_span(self, t0, t1, step, tokens=0, chunks=0):
        """One committed engine step (the decode-token batch): counted and
        reconciled against ``EngineStats.steps_committed``."""
        self.counts["step"] += 1
        self._complete("commit", PID_ENGINE, TID_COMMIT, t0, t1, "step",
                       {"step": step, "tokens": tokens, "chunks": chunks})

    # -- request track ------------------------------------------------------

    def _tid_for(self, uid: int) -> int:
        tid = self._req_tid.get(uid)
        if tid is None:
            tid = self._next_req_tid
            self._next_req_tid += 1
            self._req_tid[uid] = tid
        return tid

    def request_submit(self, uid: int, t: float) -> None:
        """Open the request's root span.  Idempotent per uid: a supervisor
        restart re-submits salvaged requests into the fresh engine, and
        those must not open (or count) a second span."""
        if uid in self._open:
            return
        self.counts["request"] += 1
        self._open[uid] = {"tid": self._tid_for(uid), "submit": t,
                           "admitted": None}

    def request_admitted(self, uid: int, t: float) -> None:
        st = self._open.get(uid)
        if st is None or st["admitted"] is not None:
            return
        st["admitted"] = t
        self._complete("queued", PID_REQUESTS, st["tid"], st["submit"], t,
                       "request", {"uid": uid})

    def prefill_chunk(self, uid: int, t0: float, t1: float, n: int) -> None:
        """One prefill chunk advanced for ``uid`` in a committed step;
        reconciled against ``EngineStats.prefill_chunks``."""
        self.counts["prefill_chunk"] += 1
        st = self._open.get(uid)
        tid = st["tid"] if st is not None else self._tid_for(uid)
        self._complete("prefill_chunk", PID_REQUESTS, tid, t0, t1,
                       "request", {"uid": uid, "positions": n})

    def request_first_token(self, uid: int, t: float) -> None:
        st = self._open.get(uid)
        if st is None:
            return
        self._instant("first_token", PID_REQUESTS, st["tid"], t,
                      "request", {"uid": uid})

    def request_finish(self, uid: int, t: float, reason: str,
                       tokens: int = 0) -> None:
        """Close the root span (finish, cancel, deadline, error, abort all
        land here).  Unknown uids are ignored — a cancel can race a
        finish."""
        st = self._open.pop(uid, None)
        if st is None:
            return
        self._complete("request", PID_REQUESTS, st["tid"], st["submit"], t,
                       "request",
                       {"uid": uid, "reason": reason, "tokens": tokens})

    def open_requests(self) -> List[int]:
        """Uids with an unclosed root span — must be empty after a drained
        run (the well-formedness gate in the telemetry chaos test)."""
        return sorted(self._open)

    # -- export -------------------------------------------------------------

    def _metadata(self) -> List[dict]:
        meta = [
            {"name": "process_name", "ph": "M", "pid": PID_ENGINE,
             "args": {"name": "engine"}},
            {"name": "process_name", "ph": "M", "pid": PID_REQUESTS,
             "args": {"name": "requests"}},
        ]
        for tid, name in _ENGINE_THREADS.items():
            meta.append({"name": "thread_name", "ph": "M", "pid": PID_ENGINE,
                         "tid": tid, "args": {"name": name}})
        for uid, tid in sorted(self._req_tid.items()):
            meta.append({"name": "thread_name", "ph": "M",
                         "pid": PID_REQUESTS, "tid": tid,
                         "args": {"name": f"req {uid}"}})
        return meta

    def num_events(self) -> int:
        return len(self._events)

    def export(self, path: Optional[str] = None) -> dict:
        """Chrome trace-event JSON; written to ``path`` when given.  Safe
        to call mid-run (exports the events recorded so far)."""
        doc = {
            "traceEvents": self._metadata() + list(self._events),
            "displayTimeUnit": "ms",
            "otherData": {"counts": dict(self.counts),
                          "open_requests": self.open_requests()},
        }
        if path:
            with open(path, "w") as f:
                json.dump(doc, f)
        return doc
