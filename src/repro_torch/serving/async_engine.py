"""Asynchronous host loop: overlap scheduling with device execution.

The synchronous ``Engine.step()`` serializes host and device — plan, dispatch,
*block* on the sync, apply, repeat — so the device sits idle for the whole
host-side planning pass every step (``EngineStats.step_gap_ms``).
:class:`AsyncEngine` drives the engine's plan / launch / commit phases from an
asyncio event loop instead, double-buffering the host against the device:

* **Speculative decode launch** (``Engine.plan_spec``): in steady-state decode
  the next step's inputs are fully determined before the current step's tokens
  ever reach the host — positions advance by one, and the sampled-token array
  can be fed *as a device array* straight into the next dispatch.  The loop
  therefore launches step N+1 before committing step N whenever it is provably
  safe (same slots survive commit; an unpredicted EOS merely discards that
  row's speculative token at commit via the plan's owner snapshot).  Such
  steps dispatch with zero host gap (``EngineStats.steps_overlapped``).
* **Off-thread sync**: the one unavoidable device sync per step
  (materializing the token array) runs in a thread-pool executor, so the
  event loop keeps serving request submissions, cancellations, and the TCP
  front-end (serving/frontend.py) while the device crunches.
* **Bounded admission queue**: ``max_queue`` caps the scheduler's waiting
  queue; ``submit`` past the cap raises :class:`EngineOverloaded`
  (backpressure — the front-end maps it to an ``aborted`` response).
* **Streaming**: each request gets a per-uid ``asyncio.Queue`` fed by the
  engine's ``on_token`` callback; :meth:`stream` is the async generator a
  handler iterates.  Terminal marker events (rejection, cancel, deadline)
  flow through the same path, so a consumer always sees exactly one
  ``finished`` event last.
* **Deadlines & cancellation**: the loop sweeps ``Engine.expire_deadlines``
  every iteration (including between speculative launches) and
  :meth:`cancel` ends a request immediately — both free the slot and release
  its blocks mid-step; the in-flight step's row is discarded at commit.
* **Graceful drain**: :meth:`shutdown` stops admission and (by default) runs
  the loop until every in-flight request finishes; ``drain=False`` cancels
  them instead.

Token parity: the async loop commits exactly the same scheduler transitions
in exactly the same order as the sync loop, and speculative launches feed
bit-identical inputs (the same device array the sync path would round-trip
through the host), so greedy outputs are token-for-token identical with the
synchronous ``Engine`` under any arrival schedule
(tests/test_async_serving.py fuzzes this).

Port of ``repro/serving/async_engine.py``.  The off-thread sync is
``Engine.sync_tokens``: it waits on the CUDA event recorded after the
step's token copy into pinned memory, so a speculative step N+1 queued
behind step N does not lengthen the wait for N's tokens.  The rest is
copied with the package renamed.
"""
from __future__ import annotations

import asyncio
from typing import AsyncIterator, Dict, List, Optional, Sequence

from repro_torch.serving.api import (FinishReason, GenerationRequest,
                               SamplingParams, ServingError, StepOutput)
from repro_torch.serving.engine import Engine, InflightStep
from repro_torch.serving.supervisor import ServingSupervisor


class EngineOverloaded(RuntimeError):
    """Raised by ``AsyncEngine.submit`` when the bounded waiting queue is
    full (backpressure) or the engine is draining/shut down."""


class EngineSaturated(EngineOverloaded):
    """Raised by ``AsyncEngine.submit`` while the supervisor's graceful
    degradation is at the shedding tier: the engine is alive but refusing
    new work until pressure clears.  Subclasses :class:`EngineOverloaded`
    so existing backpressure handling (the front-end's typed rejection
    line) covers it."""


class AsyncEngine:
    """Asyncio front half of the serving engine (see module docstring).

    Typical use::

        aeng = AsyncEngine(engine, max_queue=64)
        async with aeng:                      # starts the host loop
            req = aeng.submit(prompt, deadline_s=1.0)
            async for out in aeng.stream(req.uid):
                ...                           # out.finished on the last event
    """

    def __init__(self, engine: Engine, max_queue: Optional[int] = None,
                 supervisor: Optional[ServingSupervisor] = None):
        if max_queue is not None and max_queue < 1:
            raise ValueError(f"max_queue={max_queue} must be >= 1 or None")
        self.engine = engine
        self.max_queue = max_queue
        # fault-tolerance layer (serving/supervisor.py): when present, the
        # host loop retries failed steps, quarantines poisoned requests,
        # obeys degradation tiers (speculation gating, load shedding), and
        # snapshot-restores the engine on a crash instead of dying
        self.supervisor = supervisor
        if supervisor is not None:
            supervisor.attach(engine)
        # chaos-harness hook (repro_torch.serving.faults.FaultPlan.loop_hook):
        # called once per loop iteration; may raise a HostLoopError
        self.loop_fault_hook = None
        self._streams: Dict[int, asyncio.Queue] = {}
        self._wake: Optional[asyncio.Event] = None
        self._task: Optional[asyncio.Task] = None
        self._draining = False
        self._closed = False
        self.rejected_overload = 0     # submits bounced by backpressure

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> None:
        """Start the host loop task (requires a running event loop)."""
        if self._task is not None:
            raise ServingError("AsyncEngine already started")
        self._wake = asyncio.Event()
        self._task = asyncio.get_running_loop().create_task(self._loop())

    async def __aenter__(self) -> "AsyncEngine":
        self.start()
        return self

    async def __aexit__(self, exc_type, exc, tb) -> None:
        await self.shutdown(drain=exc_type is None)

    async def shutdown(self, drain: bool = True) -> None:
        """Stop the loop.  ``drain=True`` (graceful) refuses new submissions
        but runs every in-flight request to completion first; ``drain=False``
        cancels everything still live and stops as soon as the current step
        commits."""
        if self._closed:
            return
        if not drain:
            for uid in list(self.engine._requests.keys()):
                self.cancel(uid)
        self._draining = True
        if self._wake is not None:
            self._wake.set()
        if self._task is not None:
            await self._task
            self._task = None
        if drain and self.engine.shadow is not None and \
                not self.engine.sched.has_work():
            # graceful shutdown ran everything to completion: the shadow
            # pool must agree no request still holds blocks
            self.engine.shadow.assert_drained()
        if self.engine.journal is not None:
            if drain and not self.engine.sched.has_work():
                # clean-drain marker: recovery knows this journal needs no
                # replay (every accepted request reached a terminal record)
                self.engine.journal.log_shutdown()
            self.engine.journal.close()
        self._closed = True

    # -- request surface -----------------------------------------------------

    def submit(self, prompt: Sequence[int],
               params: Optional[SamplingParams] = None,
               uid: Optional[int] = None,
               deadline_s: Optional[float] = None) -> GenerationRequest:
        """Enqueue a prompt (non-blocking; call from the event loop thread).
        Raises :class:`EngineOverloaded` when the bounded waiting queue is
        full or the engine is draining — the caller answers the client
        immediately instead of queueing unboundedly."""
        if self._draining or self._closed:
            raise EngineOverloaded("engine is draining; not accepting work")
        if self.supervisor is not None and self.supervisor.shedding:
            # graceful degradation tier 3: typed rejection, counted as shed
            self.engine._load_sheds += 1
            self.rejected_overload += 1
            raise EngineSaturated(
                "engine is shedding load (degradation tier "
                f"{self.supervisor.controller.tier})")
        if (self.max_queue is not None
                and len(self.engine.sched.waiting) >= self.max_queue):
            self.rejected_overload += 1
            raise EngineOverloaded(
                f"waiting queue full ({self.max_queue} requests)")
        q: asyncio.Queue = asyncio.Queue()
        req = self.engine.submit(prompt, params, uid=uid,
                                 on_token=q.put_nowait,
                                 deadline_s=deadline_s)
        self._streams[req.uid] = q
        if self._wake is not None:
            self._wake.set()
        return req

    async def stream(self, uid: int) -> AsyncIterator[StepOutput]:
        """Yield the request's StepOutputs as the engine produces them; the
        last yielded event has ``finished=True`` (a real token or a terminal
        marker with ``token == -1``)."""
        q = self._streams.get(uid)
        if q is None:
            raise KeyError(f"uid {uid} has no open stream")
        while True:
            out = await q.get()
            yield out
            if out.finished:
                self._streams.pop(uid, None)
                return

    def adopt_stream(self, uid: int) -> None:
        """Open a stream queue for a request that was submitted *outside*
        :meth:`submit` — journal recovery re-submits crashed-process requests
        directly on the engine (serving/recovery.py), and this wires their
        ``on_token`` into a queue so :meth:`stream` / the front-end ``resume``
        line can consume post-recovery tokens.  Call before :meth:`start` (or
        before the loop's next commit) so no event slips past the queue."""
        req = self.engine._requests.get(uid)
        if req is None:
            raise KeyError(f"uid {uid} is not live in the engine")
        if uid in self._streams:
            return
        q: asyncio.Queue = asyncio.Queue()
        req.on_token = q.put_nowait
        self._streams[uid] = q

    def cancel(self, uid: int,
               reason: FinishReason = FinishReason.CANCELLED
               ) -> Optional[StepOutput]:
        """Cancel a request wherever it is (queued, mid-prefill, mid-decode).
        The terminal marker is delivered through the request's stream; any
        in-flight step's token for it is discarded at commit."""
        return self.engine.cancel(uid, reason)

    def release_stream(self, uid: int) -> None:
        """Drop a request's stream queue without consuming it — used when the
        consumer is gone (client disconnected) after a ``cancel``; undelivered
        events are discarded."""
        self._streams.pop(uid, None)

    # -- host loop -----------------------------------------------------------

    async def _loop(self) -> None:
        loop = asyncio.get_running_loop()
        sup = self.supervisor
        inflight: Optional[InflightStep] = None
        while True:
            # rebound every iteration: a supervisor restart swaps the engine
            eng = self.engine
            try:
                if self.loop_fault_hook is not None:
                    self.loop_fault_hook()
                if inflight is None:
                    if not eng.has_pending():
                        if self._draining:
                            return
                        self._wake.clear()
                        # recheck under the cleared flag: a submit between
                        # has_pending() and clear() also set the event
                        if not eng.has_pending() and not self._draining:
                            await self._wake.wait()
                        continue
                    inflight = eng.launch_step(eng.plan_step())
                    # yield once so submissions/cancels landing during the
                    # dispatch are visible before this step commits
                    await asyncio.sleep(0)
                    continue
                # a step is on the device: sweep deadlines, then try to
                # launch its successor *before* syncing (double-buffering)
                eng.expire_deadlines()
                nxt = None
                try:
                    # degradation tier >= 2 disables speculative launches
                    spec = (eng.plan_spec(inflight)
                            if sup is None or sup.allows_spec else None)
                    nxt = (eng.launch_step(spec, feed=inflight)
                           if spec is not None else None)
                except BaseException as e:
                    if sup is None or not isinstance(e, sup.RETRYABLE):
                        raise
                    # a fault on the *speculative* launch: the in-flight
                    # step is healthy — drop the speculation and commit it
                    eng._step_failures += 1
                    if eng.recorder is not None:
                        eng.recorder.record("spec_launch_failure",
                                            error=type(e).__name__)
                    nxt = None
                tok_np = None
                if inflight.tok is not None:
                    # the only device sync per step, moved off-thread so the
                    # event loop keeps serving clients while the device runs
                    t_sync = eng.clock.now()
                    tok_np = await loop.run_in_executor(
                        None, eng.sync_tokens, inflight)
                    if eng.tracer is not None:
                        eng.tracer.sync_span(t_sync, eng.clock.now(),
                                             eng._steps_committed)
                else:
                    await asyncio.sleep(0)
                eng.commit_step(inflight, tok_np)
                if sup is not None:
                    sup.note_commit(ok=True)
                inflight = nxt
            except (KeyboardInterrupt, SystemExit, asyncio.CancelledError):
                self._abort_streams()
                raise
            except BaseException as e:
                if sup is None:
                    # unsupervised: surface the error (legacy behavior)
                    self._abort_streams()
                    raise
                failed_plan = inflight.plan if inflight is not None else None
                inflight = None
                if isinstance(e, sup.RETRYABLE):
                    try:
                        await self._retry_step(loop, sup, failed_plan, e)
                        continue
                    except (KeyboardInterrupt, SystemExit,
                            asyncio.CancelledError):
                        self._abort_streams()
                        raise
                    except BaseException as exhausted:
                        e = exhausted
                # escalation: snapshot-restore onto a fresh engine (restart
                # raises EngineCrash once the budget is spent)
                try:
                    self.engine = sup.restart(cause=e)
                except BaseException:
                    self._abort_streams()
                    raise

    async def _retry_step(self, loop, sup: ServingSupervisor,
                          plan, exc: BaseException) -> None:
        """Relaunch a failed plan with the supervisor's bounded backoff (no
        speculation during the storm).  Raises once the retry budget is
        spent, or if the supervisor replans after a quarantine (``plan is
        None`` seeds a fresh plan)."""
        attempt = 0
        while True:
            plan, delay = sup.on_step_failure(plan, exc, attempt)
            attempt += 1
            if delay > 0:
                await asyncio.sleep(delay)
            eng = self.engine
            if eng.plan_stale(plan):
                # a cancel/deadline landed during the backoff sleep: the
                # plan's rows died under it — replan from live state
                plan = eng.plan_step()
            try:
                inflight = eng.launch_step(plan)
                tok_np = None
                if inflight.tok is not None:
                    t_sync = eng.clock.now()
                    tok_np = await loop.run_in_executor(
                        None, eng.sync_tokens, inflight)
                    if eng.tracer is not None:
                        eng.tracer.sync_span(t_sync, eng.clock.now(),
                                             eng._steps_committed)
                eng.commit_step(inflight, tok_np)
                sup.note_commit(ok=True)
                return
            except sup.RETRYABLE as e:
                exc = e

    def _abort_streams(self) -> None:
        """The loop dying must not strand consumers mid-stream: deliver a
        terminal marker to every open stream before surfacing the error."""
        for uid, q in list(self._streams.items()):
            q.put_nowait(StepOutput(
                uid=uid, token=-1, index=-1, finished=True,
                finish_reason=FinishReason.ABORTED))


async def drive_requests(aeng: AsyncEngine,
                         schedule: Sequence,
                         ) -> Dict[int, List[StepOutput]]:
    """Test/benchmark helper: submit requests on a relative-time arrival
    schedule and collect every stream in full.  ``schedule`` is a sequence of
    ``(delay_s, prompt, params, deadline_s)`` tuples (``delay_s`` relative to
    the previous arrival, open-loop style).  Returns {uid: [StepOutput...]};
    requests bounced by backpressure appear with a single synthetic ABORTED
    marker."""
    results: Dict[int, List[StepOutput]] = {}
    consumers: List[asyncio.Task] = []

    async def consume(uid: int):
        async for out in aeng.stream(uid):
            results[uid].append(out)

    for delay_s, prompt, params, deadline_s in schedule:
        if delay_s:
            await asyncio.sleep(delay_s)
        try:
            req = aeng.submit(prompt, params, deadline_s=deadline_s)
        except EngineOverloaded:
            uid = aeng.engine._uid_counter   # matches what submit would use
            aeng.engine._uid_counter += 1
            results[uid] = [StepOutput(uid=uid, token=-1, index=-1,
                                       finished=True,
                                       finish_reason=FinishReason.ABORTED)]
            continue
        results[req.uid] = []
        consumers.append(asyncio.ensure_future(consume(req.uid)))
    if consumers:
        await asyncio.gather(*consumers)
    return results
