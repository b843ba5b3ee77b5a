"""Serving-side fault tolerance: step retry, quarantine, snapshot-restore,
and graceful degradation (training already had this in distributed/elastic.py;
this is the user-facing analogue for the serving engine).

The :class:`ServingSupervisor` wraps a live :class:`~repro_torch.serving.engine.
Engine` plus a *factory* that can build a fresh, identically-configured one.
Recovery is layered, cheapest first:

  1. **Step retry with bounded backoff.**  ``commit_step`` validates tokens
     and raises :class:`~repro_torch.serving.api.StepFailure` *before* any
     scheduler mutation (the plan/launch/commit split makes a failed step
     side-effect-free), so the same :class:`StepPlan` is re-launched verbatim
     — KV writes are (token, position)-determined and replay bit-identically.
     Injected :class:`~repro_torch.serving.faults.DeviceStepError`\\ s at the plan /
     launch / commit seams take the same path.
  2. **Request quarantine.**  A failure attributed to the same request
     ``quarantine_after`` consecutive times (e.g. NaN logits pinned to its
     row) finishes that request with ``FinishReason.ERROR`` and frees its
     blocks — one poisoned request never takes the engine down.
  3. **Engine snapshot-restore.**  Anything else — retry budget exhausted, a
     host-loop crash — triggers :meth:`restart`: every active slot is
     released through the *recompute-preemption* path (publishing written
     blocks to the prefix cache first), the live request objects (tokens
     generated so far, callbacks and hence streams intact) are re-submitted
     to a fresh Engine in arrival order, and — when the new engine's config
     matches — the old block pool, prefix cache, shadow sanitizer, and device
     KV cache are *salvaged* wholesale, so re-admission re-matches the
     published prefixes and skips most of the recompute (warm restore).
  4. **Graceful degradation tiers** under sustained pressure (deep queues,
     retry storms, hung steps): tier 1 halves the chunked-prefill token
     budget, tier 2 additionally disables speculative launches, tier 3 sheds
     load — queued requests beyond the slot count finish with ``ABORTED``
     markers and new submissions are rejected with
     :class:`~repro_torch.serving.async_engine.EngineSaturated` — and clean steps
     walk the tier back down.

A hung-step detector rides along: inter-commit wall times feed the
median + k·MAD :class:`~repro_torch.distributed.elastic.StepWatchdog` rule, so a
step that stalls anywhere (device, host, injected sleep) is flagged and
counted as pressure.  All of it is observable through ``Engine.stats()``
(step_failures / step_retries / quarantines / engine_restarts / load_sheds /
hung_steps / degrade_tier / recovery_ms).

Port of ``repro/serving/supervisor.py``, copied with the package renamed;
the warm restore adopts the old engine's per-slot ``torch.Generator``s
where the JAX supervisor adopts its PRNG keys.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional

from repro_torch.distributed.elastic import StepWatchdog
from repro_torch.serving.api import ServingError, StepFailure, StepOutput
from repro_torch.serving.faults import DeviceStepError
from repro_torch.serving.telemetry import FlightRecorder


class EngineCrash(ServingError):
    """The engine cannot make progress: step retries exhausted, or the
    restart budget is spent.  ``cause`` carries the original failure."""

    def __init__(self, message: str, cause: Optional[BaseException] = None):
        super().__init__(message)
        self.cause = cause


@dataclasses.dataclass
class SupervisorConfig:
    max_step_retries: int = 3        # relaunches of one failed plan
    retry_backoff_s: float = 0.005   # base; doubles per attempt
    quarantine_after: int = 2        # consecutive attributed failures
    max_restarts: int = 3            # snapshot-restore budget
    warm_restore: bool = True        # salvage pool/cache/prefix on restart
    # degradation controller
    pressure_queue_depth: int = 8    # waiting-queue depth counted as pressure
    degrade_after: int = 3           # consecutive pressured notes to escalate
    recover_after: int = 8           # consecutive clean notes to de-escalate
    # hung-step watchdog (median + k*1.4826*MAD over inter-commit gaps)
    watchdog_k: float = 6.0
    watchdog_window: int = 40
    watchdog_min_steps: int = 8
    # flight recorder (serving/telemetry.py): ring capacity in events, and
    # an optional directory where every recovery-action dump is written as
    # flight-<seq>-<reason>.json (None = in-memory dumps only)
    flight_capacity: int = 256
    flight_dir: Optional[str] = None


class DegradationController:
    """Tiered load response: 0 = normal, 1 = halved prefill budget,
    2 = + no speculative launches, 3 = + shed queued load / reject submits.
    Escalates after ``degrade_after`` consecutive pressured observations,
    de-escalates one tier per ``recover_after`` consecutive clean ones."""

    MAX_TIER = 3

    def __init__(self, cfg: SupervisorConfig):
        self.cfg = cfg
        self.tier = 0
        self.escalations = 0
        self._bad = 0
        self._good = 0

    def note(self, queue_depth: int, pressured: bool = False) -> bool:
        """Record one observation; returns True when the tier changed."""
        if pressured or queue_depth >= self.cfg.pressure_queue_depth:
            self._bad += 1
            self._good = 0
            if self._bad >= self.cfg.degrade_after and self.tier < self.MAX_TIER:
                self.tier += 1
                self.escalations += 1
                self._bad = 0
                return True
        else:
            self._good += 1
            self._bad = 0
            if self._good >= self.cfg.recover_after and self.tier > 0:
                self.tier -= 1
                self._good = 0
                return True
        return False

    @property
    def allows_spec(self) -> bool:
        return self.tier < 2

    @property
    def shedding(self) -> bool:
        return self.tier >= self.MAX_TIER

    def apply(self, eng, base_budget: Optional[int]) -> None:
        """Push the tier onto the engine: tier 0 restores the configured
        chunked-prefill token budget, tiers >= 1 halve it (prefill work per
        step drops, decode latency is protected)."""
        if self.tier == 0:
            eng.sched.prefill_budget = base_budget
        else:
            full = base_budget if base_budget is not None else (
                eng.scfg.max_batch * max(eng.scfg.prefill_chunk, 1))
            eng.sched.prefill_budget = max(1, full // 2)
        eng._degrade_tier = self.tier


class ServingSupervisor:
    """Owns the engine lifecycle: drives retries, quarantine, degradation,
    and snapshot-restore.  The async loop (serving/async_engine.py) calls
    ``on_step_failure`` / ``note_commit`` / ``restart``; the synchronous
    ``run_step`` / ``drive`` wrappers give tests and offline callers the
    same semantics without an event loop."""

    RETRYABLE = (StepFailure, DeviceStepError)

    def __init__(self, factory: Callable[[], "Engine"],
                 cfg: Optional[SupervisorConfig] = None):
        self.factory = factory
        self.cfg = cfg if cfg is not None else SupervisorConfig()
        self.engine = None
        self.controller = DegradationController(self.cfg)
        self.restarts = 0
        self.last_restart_warm: Optional[bool] = None
        self._base_budget: Optional[int] = None
        self._fail_counts: dict = {}     # uid -> consecutive failures
        self._watch = StepWatchdog(k=self.cfg.watchdog_k,
                                   window=self.cfg.watchdog_window,
                                   min_steps=self.cfg.watchdog_min_steps)
        self._last_commit: Optional[float] = None
        self._n_commits = 0
        self._recovery_t0: Optional[float] = None
        # the flight recorder outlives engine incarnations: attach() wires
        # it (and the engine's clock) into each engine + scheduler, and
        # every recovery action below dumps it — retry, retry exhaustion,
        # quarantine, hung step, restart — so each leaves a post-mortem
        self.recorder = FlightRecorder(capacity=self.cfg.flight_capacity,
                                       dump_dir=self.cfg.flight_dir)

    # -- lifecycle -----------------------------------------------------------

    def attach(self, engine) -> "ServingSupervisor":
        self.engine = engine
        self._base_budget = engine.sched.prefill_budget
        self._last_commit = None
        self.recorder.clock = engine.clock
        engine.recorder = self.recorder
        engine.sched.recorder = self.recorder
        return self

    def _now(self) -> float:
        """Supervisor timing shares the engine's clock (FakeClock-able)."""
        eng = self.engine
        return eng.clock.now() if eng is not None else time.perf_counter()

    @property
    def allows_spec(self) -> bool:
        return self.controller.allows_spec

    @property
    def shedding(self) -> bool:
        return self.controller.shedding

    def can_restart(self) -> bool:
        return self.restarts < self.cfg.max_restarts

    # -- step failure handling ----------------------------------------------

    def on_step_failure(self, plan, exc: BaseException, attempt: int):
        """Classify one failed plan/launch/commit.  Returns ``(plan,
        backoff_s)`` for the relaunch — the *same* plan when it is still
        valid, a fresh one after a quarantine changed the slot map (or when
        planning itself failed, ``plan is None``).  Raises
        :class:`EngineCrash` once the retry budget is spent (the caller
        escalates to :meth:`restart`)."""
        eng = self.engine
        eng._step_failures += 1
        self.recorder.record("step_failure", attempt=attempt,
                             error=type(exc).__name__, detail=str(exc)[:200])
        replan = plan is None
        if isinstance(exc, StepFailure) and exc.uids:
            for uid in exc.uids:
                c = self._fail_counts.get(uid, 0) + 1
                self._fail_counts[uid] = c
                if c >= self.cfg.quarantine_after:
                    # repeatedly traced to this row: finish it with
                    # FinishReason.ERROR, keep serving everyone else
                    eng.quarantine(uid)
                    self._fail_counts.pop(uid, None)
                    replan = True
                    self.recorder.dump("quarantine", uid=uid, failures=c)
        if attempt + 1 > self.cfg.max_step_retries:
            self.recorder.dump("retry-exhausted", attempts=attempt + 1,
                               error=type(exc).__name__)
            raise EngineCrash(
                f"step retries exhausted after {attempt + 1} attempts: "
                f"{exc!r}", cause=exc)
        if plan is not None and eng.plan_stale(plan):
            # a cancel / deadline expiry / preemption raced the failed step:
            # its plan references dead rows and cannot relaunch verbatim
            replan = True
        eng._step_retries += 1
        self.recorder.dump("step-retry", attempt=attempt + 1,
                           replanned=replan)
        if self.controller.note(len(eng.sched.waiting), pressured=True):
            self._apply_tier()
        if replan:
            plan = eng.plan_step()
        return plan, self.cfg.retry_backoff_s * (2 ** attempt)

    def note_commit(self, ok: bool = True) -> None:
        """Observe one successfully committed step: feed the hung-step
        watchdog with the inter-commit gap, close a pending recovery-latency
        measurement, clear consecutive-failure attributions, and let the
        degradation controller walk tiers."""
        eng = self.engine
        now = self._now()
        hung = False
        if self._last_commit is not None:
            gap = now - self._last_commit
            rep = self._watch.observe(self._n_commits, gap)
            if rep is not None:
                hung = True
                eng._hung_steps += 1
                self.recorder.dump("hung-step", gap_s=gap,
                                   commits=self._n_commits)
        self._last_commit = now
        self._n_commits += 1
        if self._recovery_t0 is not None:
            eng._recovery_ms.observe((now - self._recovery_t0) * 1e3)
            self._recovery_t0 = None
        if ok:
            self._fail_counts.clear()
        if self.controller.note(len(eng.sched.waiting), pressured=hung):
            self._apply_tier()

    def _apply_tier(self) -> None:
        eng = self.engine
        self.recorder.record("degrade_tier", tier=self.controller.tier)
        self.controller.apply(eng, self._base_budget)
        if self.controller.shedding:
            # drop the waiting-queue tail beyond the slot count; the oldest
            # waiters (and preemption re-queues) keep their place
            eng.shed_queued(keep=eng.scfg.max_batch)

    # -- snapshot / restore --------------------------------------------------

    def restart(self, cause: Optional[BaseException] = None):
        """Rebuild the engine from a fresh ``factory()`` instance and
        re-admit every live request through the recompute-preemption path:
        active slots are preempted on the dying engine (publishing their
        written blocks into the prefix cache), then the live request objects
        — generated tokens, sampling params, callbacks, deadlines intact —
        are re-submitted in arrival order.  When the new engine's config
        matches, the block pool, prefix cache, shadow sanitizer, and device
        KV cache are adopted wholesale (*warm* restore): re-admission
        re-matches the published prefixes and skips the recompute.  Returns
        the new engine (also installed as ``self.engine``)."""
        if not self.can_restart():
            raise EngineCrash(
                f"restart budget exhausted ({self.cfg.max_restarts})",
                cause=cause)
        t0 = self._now()
        old = self.engine
        self.recorder.record("restart", restarts=self.restarts + 1,
                             cause=type(cause).__name__ if cause else None)
        for slot in list(old.sched.active_slots()):
            old.sched._preempt(slot)
        ordered = list(old.sched.waiting)      # arrival order (FIFO queue)
        submit_ts = dict(old._submit_ts)
        new = self.factory()
        # telemetry outlives the incarnation: the fresh engine adopts the
        # old clock (one timeline), tracer (request_submit is idempotent,
        # so salvaged re-submissions don't double-count spans), and this
        # supervisor's recorder — wired *before* re-submission
        new.clock = old.clock
        new.tracer = old.tracer
        new.recorder = self.recorder
        new.sched.recorder = self.recorder
        self.last_restart_warm = (self.cfg.warm_restore
                                  and self._salvage(old, new))
        for req in ordered:
            new.submit_request(req)
            if req.uid in submit_ts:           # keep e2e latency honest
                new._submit_ts[req.uid] = submit_ts[req.uid]
        new._uid_counter = max(new._uid_counter, old._uid_counter)
        self._carry_stats(old, new)
        new._engine_restarts = old._engine_restarts + 1
        if old.journal is not None:
            # flush the dying incarnation's buffered records and release its
            # segment; the fresh engine already opened its own (re-submission
            # above wrote new submit records there — first-wins on replay)
            old.journal.close()
        self.engine = new
        self.restarts += 1
        self._last_commit = None               # gap across restart: not hung
        self._fail_counts.clear()
        self._recovery_t0 = t0                 # closed at next note_commit
        self._apply_tier()
        self.recorder.dump("engine-restart", restarts=self.restarts,
                           warm=bool(self.last_restart_warm),
                           resubmitted=len(ordered))
        return new

    def _salvage(self, old, new) -> bool:
        """Adopt the old engine's block pool, prefix cache, shadow, and
        device KV cache into the fresh engine (the warm restore).  Safe
        because every slot was released through ``_preempt`` first — the
        allocator holds only published / trash blocks, the shadow census
        agrees, and any uncommitted in-flight writes sit in freed blocks
        that recycle before anything attends them."""
        if not (old.paged and new.paged and old._cache is not None
                and old.scfg == new.scfg and old.cfg == new.cfg):
            return False
        new.allocator = old.allocator
        new.prefix_cache = old.prefix_cache
        new.shadow = old.shadow
        new.sched.allocator = old.allocator
        new.sched.prefix_cache = old.prefix_cache
        new.sched.shadow = old.shadow
        new._cache = old._cache
        new._gens = old._gens
        return True

    def _carry_stats(self, old, new) -> None:
        """Counters are cumulative across restarts: a supervised service
        reports one continuous stats stream, not per-incarnation resets."""
        for attr in ("_prefill_positions", "_prefill_skipped",
                     "_prefill_chunks", "_ttft_ms", "_queue_wait_ms",
                     "_e2e_ms", "_step_gap_ms", "_steps_committed",
                     "_steps_overlapped", "_tokens_generated",
                     "_cancellations", "_deadline_expirations",
                     "_requests_submitted",
                     "_step_failures", "_step_retries", "_quarantines",
                     "_load_sheds", "_hung_steps", "_recovery_ms"):
            setattr(new, attr, getattr(old, attr))
        new.sched.admissions += old.sched.admissions
        new.sched.preemptions += old.sched.preemptions
        new.fault_hook = old.fault_hook
        # the latency Histogram objects just moved over; rebind the metrics
        # registry so its histogram entries (and counter callbacks) point at
        # the new engine's state instead of the dead incarnation's
        new._build_metrics()

    # -- synchronous loops ---------------------------------------------------

    def run_step(self) -> List[StepOutput]:
        """One supervised engine step: plan, launch, commit, with retries and
        quarantine applied on failure.  Raises :class:`EngineCrash` when the
        retry budget is spent (callers escalate to :meth:`restart`)."""
        try:
            plan = self.engine.plan_step()
        except self.RETRYABLE as e:
            return self.run_planned(None, e)
        return self.run_planned(plan)

    def run_planned(self, plan,
                    exc: Optional[BaseException] = None) -> List[StepOutput]:
        """Launch + commit ``plan`` with the retry loop around it (``exc``
        seeds the loop when the caller already holds a failure)."""
        attempt = 0
        while True:
            if exc is not None:
                plan, delay = self.on_step_failure(plan, exc, attempt)
                attempt += 1
                exc = None
                if delay > 0:
                    time.sleep(delay)
            eng = self.engine
            try:
                outs = eng.commit_step(eng.launch_step(plan))
                self.note_commit(ok=True)
                return outs
            except self.RETRYABLE as e:
                exc = e

    def drive(self) -> List[StepOutput]:
        """Run the engine to drain under full supervision (the synchronous
        mirror of the async loop's recovery ladder): retryable failures
        retry, exhausted retries and organic crashes restart, and the
        restart budget is the last line."""
        outs: List[StepOutput] = []
        while self.engine.has_pending():
            try:
                outs.extend(self.run_step())
            except (KeyboardInterrupt, SystemExit):
                raise
            except BaseException as e:
                # anything past the retry ladder: snapshot-restore (restart
                # itself raises EngineCrash once the budget is spent)
                self.restart(cause=e)
        return outs
