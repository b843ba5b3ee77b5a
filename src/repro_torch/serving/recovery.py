"""Cross-process crash recovery: replay the request journal into a cold
engine.

The supervisor restores from *live* request objects — useless once
the process itself dies.  This module closes that gap: a fresh process
points a cold :class:`~repro_torch.serving.engine.Engine` at the journal
directory its predecessor was writing (``ServeConfig.journal_dir``) and
calls :func:`replay_journal`:

* every unfinished request is re-submitted with its journal-committed
  tokens **forced as prefix** — ``Scheduler.admit`` prefills
  ``prompt + output_tokens``, the exact mechanism recompute-preemption
  already uses, so the chunked-prefill machinery rebuilds the KV
  bit-identically and greedy continuations match the uncrashed run
  token-for-token;
* delivery cursors are restored: the report's ``committed`` map is the
  per-uid durable token backlog at recovery time, and the front-end's
  ``resume`` protocol line (``{"resume": uid, "offset": n}``) replays
  exactly the suffix a reconnecting client is missing — the journal is
  written *before* callbacks deliver (write-ahead), so it is always a
  superset of what any client saw and the offset always lands inside it;
* the uid counter advances past every journaled uid, so post-recovery
  submissions never collide with resurrected requests.

:func:`reconcile` cross-checks the replay against ``EngineStats`` and any
flight-recorder dumps the crashed process left behind
(``--flight-dir``) — recovery must account for every accepted request,
not just the ones that happened to be live.

Port of ``repro/serving/recovery.py``, copied with the package renamed.
"""
from __future__ import annotations

import dataclasses
import pathlib
import time
from typing import Dict, List, Optional

from .api import make_request
from .journal import JournalState, load_state, params_from_journal

__all__ = ["RecoveryReport", "replay_journal", "reconcile"]


@dataclasses.dataclass
class RecoveryReport:
    """What a journal replay re-hydrated.

    ``resumed`` — uids re-submitted into the cold engine (journal order =
    original submit order, preserving FIFO admission).  ``finished`` —
    uid -> finish-reason string for requests the journal already saw
    terminate (a reconnecting client gets its missing suffix plus the
    terminal event, no engine work).  ``committed`` — uid -> durable
    token list at recovery time, the resume protocol's delivery-cursor
    base for *every* journaled uid, live or finished.  ``forced_tokens``
    — committed tokens re-scored as prefix across resumed requests
    (the replay's recompute bill).  ``replay_ms`` — wall time of the
    replay itself (journal read + re-submission)."""
    resumed: List[int]
    finished: Dict[int, Optional[str]]
    committed: Dict[int, List[int]]
    forced_tokens: int
    replay_ms: float
    torn_tail: bool
    clean_shutdown: bool

    def cursor(self, uid: int, offset: int) -> List[int]:
        """The durable tokens a client at ``offset`` has not seen."""
        return self.committed.get(uid, [])[offset:]


def replay_journal(engine, state: Optional[JournalState] = None
                   ) -> RecoveryReport:
    """Replay the engine's journal directory into it (must be cold: no
    in-flight requests).  Re-submits every unfinished request with its
    committed tokens forced as prefix and re-arms remaining wall-clock
    deadline time.  Appends a ``recover`` marker so the journal itself
    records the replay.  Idempotent at the journal level: re-submission
    writes ``submit`` records that replay first-wins."""
    t0 = time.perf_counter()
    if engine._requests:
        raise ValueError(
            "replay_journal needs a cold engine; "
            f"{len(engine._requests)} request(s) already in flight")
    if state is None:
        if engine.journal is not None:
            # the writer already folded existing segments at open
            state = engine.journal.state
        else:
            if not engine.scfg.journal_dir:
                raise ValueError(
                    "engine has no journal: set ServeConfig.journal_dir")
            state = load_state(engine.scfg.journal_dir)
    resumed: List[int] = []
    finished: Dict[int, Optional[str]] = {}
    committed: Dict[int, List[int]] = {}
    forced = 0
    now_wall = time.time()
    for e in state.reqs.values():
        committed[e["uid"]] = list(e["toks"])
        if e["done"]:
            finished[e["uid"]] = e["reason"]
    engine._uid_counter = max(engine._uid_counter, state.max_uid() + 1)
    for e in state.live():
        deadline = None
        if e["deadline_wall"] is not None:
            # remaining wall-clock time re-based onto this process's
            # monotonic clock; an already-expired deadline finishes the
            # request at the first plan boundary (DEADLINE, tokens kept)
            deadline = engine.clock.now() + max(
                0.0, e["deadline_wall"] - now_wall)
        req = make_request(e["prompt"], e["uid"],
                           params_from_journal(e["params"]),
                           deadline=deadline)
        req.output_tokens.extend(e["toks"])
        forced += len(e["toks"])
        engine.submit_request(req)
        resumed.append(e["uid"])
    if engine.journal is not None:
        engine.journal.log_recover(len(resumed), forced)
    return RecoveryReport(
        resumed=resumed, finished=finished, committed=committed,
        forced_tokens=forced,
        replay_ms=(time.perf_counter() - t0) * 1e3,
        torn_tail=state.torn is not None,
        clean_shutdown=state.clean_shutdown)


def reconcile(report: RecoveryReport, engine,
              flight_dir=None) -> Dict:
    """Cross-check a replay against the recovered engine's stats and the
    crashed process's flight dumps.  Raises ``ValueError`` on any
    accounting hole; returns the reconciliation summary."""
    stats = engine.stats()
    problems: List[str] = []
    if stats.requests_submitted < len(report.resumed):
        problems.append(
            f"engine accepted {stats.requests_submitted} submissions but "
            f"the replay resubmitted {len(report.resumed)}")
    live = set(engine._requests)
    missing = [u for u in report.resumed
               if u not in live and u not in report.finished]
    # a resumed request may legitimately have finished *since* recovery —
    # only uids the engine has never heard of are holes
    missing = [u for u in missing if u not in engine._submit_ts
               and engine.sched._arrival.get(u) is None]
    if missing:
        problems.append(
            "replayed uid(s) the engine has never heard of: "
            + ", ".join(str(u) for u in missing))
    dumps: List[str] = []
    if flight_dir is not None:
        d = pathlib.Path(flight_dir)
        if d.is_dir():
            dumps = sorted(p.name for p in d.glob("flight-*.json"))
    if problems:
        raise ValueError("recovery reconciliation failed: "
                         + "; ".join(problems))
    return {
        "resumed": len(report.resumed),
        "already_finished": len(report.finished),
        "forced_tokens": report.forced_tokens,
        "replay_ms": round(report.replay_ms, 3),
        "torn_tail": report.torn_tail,
        "clean_shutdown": report.clean_shutdown,
        "unaccounted_uids": missing,
        "flight_dumps": dumps,
    }
