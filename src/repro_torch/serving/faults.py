"""Deterministic fault injection for the serving stack (the chaos harness).

A :class:`FaultPlan` is a seeded schedule of :class:`Fault`\\ s, each pinned
to a *site* (an injection seam) and an occurrence index at that site.  Sites
are counted per call, so the same plan against the same workload injects the
same faults — the chaos soak (benchmarks/serving_loadgen.py ``--chaos``) and
the supervisor tests rely on that determinism.

Sites and the hooks that consume them:

  * ``plan`` / ``launch`` / ``commit`` — ``Engine.fault_hook``, wired to
    :meth:`FaultPlan.engine_hook`.  ``plan`` and ``launch`` faults fire
    *before* any side effect (scheduler mutation / device dispatch), and
    ``commit`` faults fire after the device sync but before validation —
    every injected failure lands where the real failure would, and the plan
    stays side-effect-free to replay.  Kinds: ``raise`` (a
    :class:`DeviceStepError`), ``slow`` / ``hang`` (``time.sleep(arg)``
    seconds — a hung step is simulated as a finite stall so the in-process
    watchdog can flag it), and ``nan`` (commit only: overwrite a consumable
    row's synced token with the non-finite sentinel, exactly what the fused
    ``guard_nonfinite`` emits when that row's logits carry NaN/Inf).
  * ``alloc`` — ``BlockAllocator.fault_hook``: report pool starvation even
    though blocks are free (an exhaustion spike); ``run`` consecutive calls
    starve starting at the scheduled occurrence.
  * ``loop`` — the ``AsyncEngine._loop`` iteration hook: ``crash`` raises a
    :class:`HostLoopError`, the supervisor's snapshot-restore trigger.
  * ``client`` — consulted by the load generator per request *index* (not a
    call counter): ``malformed`` / ``oversized`` send a poisoned frontend
    line before the real request, ``disconnect`` drops the connection
    mid-stream.
  * ``proc`` — consulted by the crash harness's *parent* process per
    kill-relaunch cycle (looked up by cycle index, like ``client``):
    ``sigkill`` orders a ``SIGKILL`` of the forked serve process once its
    journal has grown by ``arg`` committed tokens that cycle — a real
    process death mid-step, recovered by journal replay in a fresh process
    (benchmarks/serving_loadgen.py ``--crash``).
  * ``device_mem`` — consulted once per step boundary when the engine runs
    with ``ServeConfig.kv_checksums``: ``bitflip`` / ``garbage`` corrupt one
    resident KV pool block in device memory (``Engine.corrupt_kv_block``),
    caught by the shadow pool's per-block checksum sweep and recovered by
    recompute-preempting the rows that read the block.  Occurrences only
    count boundaries with a checksummed block resident, so the scheduled
    corruption always lands on real data.

``fired`` records every injection actually delivered; the chaos soak gates
on the schedule being fully consumed (:meth:`unfired`), so "every fault
class injected at least once" is checked, not assumed.

Port of ``repro/serving/faults.py``, copied with the package renamed; the
``device_mem`` site calls the port's ``Engine.corrupt_kv_block``, which
writes the pool tensors in place.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.serving.api import ServingError
from repro_torch.serving.sampling import NONFINITE_TOKEN

ENGINE_SITES = ("plan", "launch", "commit")
SITES = ENGINE_SITES + ("alloc", "loop", "client", "proc", "device_mem")


class InjectedFault(ServingError):
    """Base class for failures raised by the fault harness (so tests and the
    supervisor can tell injected faults from organic ones when needed)."""


class DeviceStepError(InjectedFault):
    """Simulated device-step failure at a plan/launch/commit seam."""


class HostLoopError(InjectedFault):
    """Simulated crash of the async host loop (snapshot-restore trigger)."""


@dataclasses.dataclass(frozen=True)
class Fault:
    """One scheduled injection: at occurrences ``[at, at + run)`` of ``site``
    calls, deliver ``kind``.  ``arg`` is the kind's parameter (sleep seconds
    for ``slow``/``hang``; unused otherwise)."""
    site: str
    kind: str
    at: int
    run: int = 1
    arg: float = 0.0

    def __post_init__(self):
        if self.site not in SITES:
            raise ValueError(f"unknown fault site {self.site!r}")


class FaultPlan:
    """A deterministic schedule of injections, shared across engine restarts
    (site counters are plan-global, so a restored engine continues the same
    schedule instead of replaying it)."""

    def __init__(self, faults: Sequence[Fault], seed: int = 0):
        self.seed = seed
        self.faults = list(faults)
        self._by_site: Dict[str, List[Fault]] = {}
        for f in self.faults:
            self._by_site.setdefault(f.site, []).append(f)
        self.counts: Dict[str, int] = {s: 0 for s in SITES}
        # (site, kind, occurrence) per delivered injection
        self.fired: List[Tuple[str, str, int]] = []
        self._delivered: Dict[int, int] = {}   # id(fault) -> deliveries

    # -- bookkeeping ---------------------------------------------------------

    def _record(self, f: Fault, occurrence: int) -> None:
        self.fired.append((f.site, f.kind, occurrence))
        self._delivered[id(f)] = self._delivered.get(id(f), 0) + 1

    def poll(self, site: str) -> Optional[Fault]:
        """Advance ``site``'s occurrence counter; return the scheduled fault
        covering this occurrence, if any (recorded as fired)."""
        c = self.counts[site]
        self.counts[site] = c + 1
        for f in self._by_site.get(site, ()):
            if f.at <= c < f.at + f.run:
                self._record(f, c)
                return f
        return None

    def fired_kinds(self) -> set:
        return {(site, kind) for site, kind, _ in self.fired}

    def unfired(self) -> List[Fault]:
        """Scheduled faults not (fully) delivered — the chaos soak's
        coverage gate: an empty list means every scheduled injection of
        every class actually landed."""
        return [f for f in self.faults
                if self._delivered.get(id(f), 0) < f.run]

    # -- hooks ---------------------------------------------------------------

    def engine_hook(self, site: str, ctx: dict) -> None:
        """``Engine.fault_hook`` adapter (sites plan/launch/commit)."""
        f = self.poll(site)
        if f is None:
            return
        if f.kind == "raise":
            raise DeviceStepError(
                f"injected {site} fault (occurrence {self.counts[site] - 1})")
        if f.kind in ("slow", "hang"):
            time.sleep(f.arg)
            return
        if f.kind == "nan":
            self._poison_row(ctx)
            return
        raise ValueError(f"unknown engine fault kind {f.kind!r}")

    def _poison_row(self, ctx: dict) -> None:
        """Overwrite one consumable row's token with the non-finite sentinel
        (what ``guard_nonfinite`` yields when the row's logits hold NaN/Inf).
        Prefers a pure-decode row — their sample is always consumed — and
        picks the lowest such slot, so a run of ``nan`` faults across a
        retried plan keeps hitting the *same* request (the quarantine
        trigger)."""
        plan, tok = ctx.get("plan"), ctx.get("tok")
        if plan is None or tok is None or not plan.active:
            return
        decode_rows = [s for s in plan.active
                       if s not in plan.chunks and s not in plan.stalled]
        slot = min(decode_rows) if decode_rows else min(plan.active)
        tok = tok.copy()                      # the synced buffer may be
        tok[slot] = NONFINITE_TOKEN           # read-only (device export)
        ctx["tok"] = tok

    def alloc_hook(self, n: int) -> bool:
        """``BlockAllocator.fault_hook`` adapter: True = starve this call."""
        return self.poll("alloc") is not None

    def loop_hook(self) -> None:
        """Async host-loop iteration hook: raises on a scheduled crash."""
        f = self.poll("loop")
        if f is not None and f.kind == "crash":
            raise HostLoopError(
                f"injected host-loop crash "
                f"(iteration {self.counts['loop'] - 1})")

    def client_fault(self, index: int) -> Optional[str]:
        """Client-behavior fault for request ``index`` (looked up directly,
        not counted): the load generator consults this per request."""
        for f in self._by_site.get("client", ()):
            if f.at <= index < f.at + f.run:
                self._record(f, index)
                return f.kind
        return None

    def proc_fault(self, cycle: int) -> Optional[Fault]:
        """Process-kill fault for relaunch cycle ``cycle`` (looked up by
        index, like ``client``): the crash harness's parent consults this
        once per serve-process launch.  ``kind == "sigkill"`` means SIGKILL
        the child after its journal gains ``arg`` committed tokens."""
        for f in self._by_site.get("proc", ()):
            if f.at <= cycle < f.at + f.run:
                self._record(f, cycle)
                return f
        return None

    def device_mem_hook(self, engine) -> Optional[int]:
        """Step-boundary hook: at a scheduled occurrence, corrupt one
        resident checksummed KV block in device memory (seeded victim, so
        the same schedule hits the same block against the same workload).
        Returns the corrupted physical block id, or None.  Boundaries with
        no checksummed block resident do not advance the occurrence counter
        — the scheduled corruption always lands on real data."""
        shadow = getattr(engine, "shadow", None)
        if shadow is None or not getattr(shadow, "checksums_enabled", False):
            return None
        blocks = shadow.checksummed()
        if not blocks:
            return None
        f = self.poll("device_mem")
        if f is None:
            return None
        if f.kind not in ("bitflip", "garbage"):
            raise ValueError(f"unknown device_mem fault kind {f.kind!r}")
        victim = blocks[(self.seed + self.counts["device_mem"])
                        % len(blocks)]
        engine.corrupt_kv_block(victim, seed=self.seed + f.at, mode=f.kind)
        return victim

    # -- canned schedules ----------------------------------------------------

    @staticmethod
    def chaos(seed: int = 0, n_requests: int = 10,
              quarantine_after: int = 2, restarts: int = 1) -> "FaultPlan":
        """The chaos-soak schedule: at least one injection of every fault
        class, placed deterministically from ``seed``.  Occurrence indices
        are kept small enough to fire within a smoke-sized workload; the
        ``nan`` faults run ``quarantine_after`` consecutive commits so the
        retried plan keeps failing on the same row and quarantine engages."""
        # a tiny seeded LCG (stdlib-only, stable across platforms) jitters
        # the schedule without letting two faults collide
        state = (seed * 6364136223846793005 + 1442695040888963407) % (1 << 63)

        def jitter(lo: int, hi: int) -> int:
            nonlocal state
            state = (state * 6364136223846793005 + 1442695040888963407) \
                % (1 << 63)
            return lo + (state >> 33) % max(1, hi - lo)

        faults = [
            # device-step raises: one at a launch seam, one at a commit seam
            Fault("launch", "raise", at=jitter(2, 5)),
            Fault("commit", "raise", at=jitter(6, 9)),
            # a planning fault (replanned, zero side effects)
            Fault("plan", "raise", at=jitter(3, 6)),
            # NaN logits traced to one row, persisting across the retry ->
            # quarantine (FinishReason.ERROR)
            Fault("commit", "nan", at=jitter(12, 16), run=quarantine_after),
            # slow then "hung" steps (finite stalls the watchdog must flag)
            Fault("launch", "slow", at=jitter(18, 21), arg=0.12),
            Fault("launch", "hang", at=jitter(23, 26), arg=0.35),
            # allocator exhaustion spike: a run of starved allocs
            Fault("alloc", "starve", at=jitter(4, 8), run=3),
            # frontend/client misbehavior, one request each
            Fault("client", "malformed", at=0),
            Fault("client", "oversized", at=1),
            Fault("client", "disconnect", at=min(2, n_requests - 1)),
        ]
        for i in range(restarts):
            # host-loop crashes -> snapshot/restore; spaced well apart
            faults.append(Fault("loop", "crash",
                                at=jitter(28 + 40 * i, 34 + 40 * i)))
        return FaultPlan(faults, seed=seed)

    @staticmethod
    def crash(seed: int = 0, kills: int = 3,
              corruptions: int = 1) -> "FaultPlan":
        """The crash-soak schedule (``serving_loadgen --crash``): ``kills``
        SIGKILLs of the serve process — one per relaunch cycle, each armed
        to fire after a seeded number of journal-committed tokens that
        cycle — plus ``corruptions`` device-memory corruptions (alternating
        bit-flip / garbage) injected at seeded step boundaries of the final,
        unkilled cycle."""
        state = (seed * 6364136223846793005 + 1442695040888963407) % (1 << 63)

        def jitter(lo: int, hi: int) -> int:
            nonlocal state
            state = (state * 6364136223846793005 + 1442695040888963407) \
                % (1 << 63)
            return lo + (state >> 33) % max(1, hi - lo)

        faults = [Fault("proc", "sigkill", at=i,
                        arg=float(jitter(6, 18)))
                  for i in range(kills)]
        for i in range(corruptions):
            faults.append(Fault("device_mem",
                                "bitflip" if i % 2 == 0 else "garbage",
                                at=jitter(1 + 4 * i, 4 + 4 * i)))
        return FaultPlan(faults, seed=seed)
