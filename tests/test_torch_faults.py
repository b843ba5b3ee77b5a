"""The port's fault tolerance for serving (``repro_torch.serving.faults`` /
``supervisor``, ``distributed.elastic.StepWatchdog``), held to the contract
of tests/test_faults.py, whose cases are repeated here on the port's engine
at the same sizes: transient faults invisible, retry and restart budgets,
NaN-row quarantine, warm and cold restore with parity, degradation tiers,
shedding, the watchdog and the front end's bad lines.  The chaos schedule
of a seed must equal the JAX package's."""
import asyncio

import torch
import numpy as np
import pytest

from repro_torch.distributed.elastic import StepWatchdog
from repro_torch.models import build_model, get_config
from repro_torch.serving.api import FinishReason, SamplingParams, StepFailure
from repro_torch.serving.async_engine import AsyncEngine, EngineSaturated
from repro_torch.serving.engine import Engine, ServeConfig
from repro_torch.serving.faults import DeviceStepError, Fault, FaultPlan
from repro_torch.serving.frontend import FrontendServer, ServeClient
from repro_torch.serving.supervisor import (DegradationController, EngineCrash,
                                      ServingSupervisor, SupervisorConfig)


@pytest.fixture(scope="module")
def lm():
    cfg = get_config("qwen1.5-0.5b").reduced(layers=2).replace(
        compute_dtype="float32", param_dtype="float32")
    return cfg, build_model(cfg, gen=torch.Generator().manual_seed(0),
                            device="cpu")


SCFG = dict(max_batch=3, max_len=48, kv_block_size=4, prefill_chunk=4)


def _prompts(seed: int, n: int, lo: int = 5, hi: int = 14):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 64, int(rng.integers(lo, hi))).tolist()
            for _ in range(n)]


def _baseline(cfg, model, prompts, max_tokens=6):
    """Fault-free greedy reference run: prompt index -> tokens."""
    eng = Engine(cfg, model, ServeConfig(**SCFG))
    sp = SamplingParams(max_tokens=max_tokens, ignore_eos=True)
    reqs = [eng.submit(p, sp) for p in prompts]
    for _ in eng.stream():
        pass
    return [list(r.output_tokens) for r in reqs]


def _supervised(cfg, model, faults, prompts, max_tokens=6, sup_cfg=None,
                scfg_kw=None):
    """Run the workload under a ServingSupervisor with ``faults`` injected;
    returns (engine, supervisor, events-per-prompt-index)."""
    plan = FaultPlan(faults)
    scfg = ServeConfig(**{**SCFG, **(scfg_kw or {})})

    def factory():
        e = Engine(cfg, model, scfg)
        e.fault_hook = plan.engine_hook
        if e.allocator is not None:
            e.allocator.fault_hook = plan.alloc_hook
        return e

    sup = ServingSupervisor(factory, sup_cfg)
    eng = factory()
    sup.attach(eng)
    sp = SamplingParams(max_tokens=max_tokens, ignore_eos=True)
    events = [[] for _ in prompts]
    for i, p in enumerate(prompts):
        eng.submit(p, sp, on_token=events[i].append)
    sup.drive()
    return sup.engine, sup, events


def _tokens(evs):
    return [o.token for o in evs if o.token >= 0]


class TestFaultPlan:
    def test_occurrence_counting_and_coverage(self):
        plan = FaultPlan([Fault("launch", "raise", at=1),
                          Fault("alloc", "starve", at=0, run=2)])
        assert plan.poll("launch") is None          # occurrence 0
        assert plan.poll("launch").kind == "raise"  # occurrence 1
        assert plan.poll("launch") is None
        assert plan.alloc_hook(1) and plan.alloc_hook(2)
        assert not plan.alloc_hook(3)
        assert plan.unfired() == []
        assert plan.fired_kinds() == {("launch", "raise"),
                                      ("alloc", "starve")}

    def test_unfired_reports_undelivered_schedule(self):
        plan = FaultPlan([Fault("commit", "nan", at=5, run=2)])
        plan.poll("commit")                         # occurrence 0 only
        assert len(plan.unfired()) == 1

    def test_chaos_schedule_is_deterministic(self):
        a, b = FaultPlan.chaos(seed=3), FaultPlan.chaos(seed=3)
        assert [(f.site, f.kind, f.at, f.run) for f in a.faults] == \
            [(f.site, f.kind, f.at, f.run) for f in b.faults]
        sites = {f.site for f in a.faults}
        assert sites == {"plan", "launch", "commit", "alloc", "loop",
                         "client"}

    def test_rejects_unknown_site(self):
        with pytest.raises(ValueError):
            Fault("gpu", "raise", at=0)


class TestStepRetry:
    def test_transient_faults_are_invisible(self, lm):
        """One raise at each engine seam: the supervisor retries and the
        outputs are token-identical to a fault-free run."""
        cfg, model = lm
        prompts = _prompts(0, 3)
        want = _baseline(cfg, model, prompts)
        eng, sup, events = _supervised(
            cfg, model,
            [Fault("plan", "raise", at=1),
             Fault("launch", "raise", at=3),
             Fault("commit", "raise", at=5)],
            prompts)
        assert [_tokens(e) for e in events] == want
        st = eng.stats()
        assert st.step_failures == 3 and st.step_retries == 3
        assert st.quarantines == 0 and st.engine_restarts == 0
        assert eng.allocator.blocks_in_use() == 0
        # every request finished exactly once
        assert all(sum(o.finished for o in e) == 1 for e in events)

    def test_retry_budget_exhaustion_raises_enginecrash(self, lm):
        cfg, model = lm
        prompts = _prompts(1, 1)
        with pytest.raises(EngineCrash):
            _supervised(
                cfg, model,
                # longer than the retry budget and unattributable to a
                # request -> escalation; restart budget 0 -> crash surfaces
                [Fault("commit", "raise", at=0, run=10)],
                prompts,
                sup_cfg=SupervisorConfig(max_step_retries=2, max_restarts=0))


class TestQuarantine:
    def test_nan_row_quarantined_others_unaffected(self, lm):
        """NaN logits pinned to one row across the retry: that request ends
        with FinishReason.ERROR, everyone else streams baseline tokens."""
        cfg, model = lm
        prompts = _prompts(2, 3)
        want = _baseline(cfg, model, prompts)
        eng, sup, events = _supervised(
            cfg, model, [Fault("commit", "nan", at=6, run=2)], prompts,
            sup_cfg=SupervisorConfig(quarantine_after=2))
        st = eng.stats()
        assert st.quarantines == 1 and st.step_failures == 2
        errored = [i for i, e in enumerate(events)
                   if e[-1].finish_reason == FinishReason.ERROR]
        assert len(errored) == 1
        for i, e in enumerate(events):
            assert sum(o.finished for o in e) == 1
            if i not in errored:
                assert _tokens(e) == want[i]
        assert eng.allocator.blocks_in_use() == 0

    def test_validate_tokens_raises_pre_mutation(self, lm):
        """A poisoned token must fail the commit *before* any scheduler
        mutation, so the identical plan replays cleanly."""
        cfg, model = lm
        prompts = _prompts(3, 2)
        plan = FaultPlan([Fault("commit", "nan", at=2)])
        eng = Engine(cfg, model, ServeConfig(**SCFG))
        eng.fault_hook = plan.engine_hook
        sp = SamplingParams(max_tokens=4, ignore_eos=True)
        reqs = [eng.submit(p, sp) for p in prompts]
        outs = []
        while eng.has_pending():
            step = eng.launch_step(eng.plan_step())
            try:
                outs.extend(eng.commit_step(step))
            except StepFailure as e:
                assert e.uids                      # attributed to a request
                ngen = {r.uid: r.num_generated for r in reqs}
                outs.extend(eng.commit_step(eng.launch_step(step.plan)))
                # the failed commit mutated nothing: the retry advanced
                # every live request by at most its normal amount
                for r in reqs:
                    assert r.num_generated <= ngen[r.uid] + 1
        assert eng.allocator.blocks_in_use() == 0


class TestRaceFailedStepVsCancel:
    """Satellite 4: cancellation / deadline expiry racing a failed+retried
    mid-chunk prefill step — the request finishes exactly once, its blocks
    come back, and the retried commit emits no duplicate StepOutputs."""

    def _race(self, lm, resolve):
        cfg, model = lm
        long_prompt = list(range(1, 13))          # 3 prefill chunks of 4
        short = [7, 8, 9]
        plan = FaultPlan([Fault("commit", "raise", at=0)])
        eng = Engine(cfg, model, ServeConfig(**SCFG))
        eng.fault_hook = plan.engine_hook
        sp = SamplingParams(max_tokens=5, ignore_eos=True)
        ev_a, ev_b = [], []
        ra = eng.submit(long_prompt, sp, on_token=ev_a.append,
                        deadline_s=resolve == "deadline" and 1e-4 or None)
        rb = eng.submit(short, sp, on_token=ev_b.append)
        step = eng.launch_step(eng.plan_step())   # chunk 1 of ra's prefill
        with pytest.raises(DeviceStepError) as ei:
            eng.commit_step(step)                 # injected failure
        # the race: resolve ra between the failure and the retry
        if resolve == "cancel":
            eng.cancel(ra.uid)
            want_reason = FinishReason.CANCELLED
        else:
            import time
            time.sleep(2e-4)
            eng.expire_deadlines()
            want_reason = FinishReason.DEADLINE
        # the failed plan now references a dead row: it must be detected as
        # stale and replanned, never relaunched verbatim
        assert eng.plan_stale(step.plan)
        sup = ServingSupervisor(lambda: eng)
        sup.attach(eng)
        outs = sup.run_planned(step.plan, ei.value)
        assert all(o.uid != ra.uid for o in outs)  # no duplicate StepOutputs
        sup.drive()
        assert [o.finished for o in ev_a] == [True]
        assert ev_a[0].finish_reason == want_reason
        assert sum(o.finished for o in ev_b) == 1
        assert ev_b[-1].finish_reason in (FinishReason.STOP,
                                          FinishReason.LENGTH)
        assert _tokens(ev_b) == _baseline(cfg, model, [short],
                                          max_tokens=5)[0]
        assert eng.sched.active_slots() == []
        assert eng.allocator.blocks_in_use() == 0

    def test_cancel_races_failed_prefill_step(self, lm):
        self._race(lm, "cancel")

    def test_deadline_races_failed_prefill_step(self, lm):
        self._race(lm, "deadline")


class TestSnapshotRestore:
    def test_restart_resumes_in_flight_with_parity(self, lm):
        cfg, model = lm
        prompts = _prompts(4, 3)
        want = _baseline(cfg, model, prompts, max_tokens=8)
        plan = FaultPlan([])
        scfg = ServeConfig(**SCFG)

        def factory():
            e = Engine(cfg, model, scfg)
            e.fault_hook = plan.engine_hook
            return e

        sup = ServingSupervisor(factory)
        eng = factory()
        sup.attach(eng)
        sp = SamplingParams(max_tokens=8, ignore_eos=True)
        events = [[] for _ in prompts]
        for i, p in enumerate(prompts):
            eng.submit(p, sp, on_token=events[i].append)
        for _ in range(4):                        # partial progress
            sup.run_step()
        new = sup.restart()
        assert new is not eng and sup.engine is new
        assert sup.last_restart_warm is True      # identical config: salvage
        sup.drive()
        assert [_tokens(e) for e in events] == want
        assert all(sum(o.finished for o in e) == 1 for e in events)
        st = new.stats()
        assert st.engine_restarts == 1
        assert st.recovery_ms is not None         # restart latency measured
        assert new.allocator.blocks_in_use() == (
            0 if new.prefix_cache is None
            else new.prefix_cache.stats()["cached_unreferenced_blocks"])

    def test_cold_restore_on_config_mismatch(self, lm):
        """A factory producing a different ServeConfig cannot salvage the
        pool — restore must fall back to cold (recompute) and still agree."""
        cfg, model = lm
        prompts = _prompts(5, 2)
        want = _baseline(cfg, model, prompts)
        built = []

        def factory():
            # first build: kv_block_size 4; rebuilds: 8 (incompatible pool)
            kw = dict(SCFG, kv_block_size=8 if built else 4)
            built.append(1)
            return Engine(cfg, model, ServeConfig(**kw))

        sup = ServingSupervisor(factory)
        sup.attach(factory())
        sp = SamplingParams(max_tokens=6, ignore_eos=True)
        events = [[] for _ in prompts]
        for i, p in enumerate(prompts):
            sup.engine.submit(p, sp, on_token=events[i].append)
        for _ in range(3):
            sup.run_step()
        sup.restart()
        assert sup.last_restart_warm is False
        sup.drive()
        assert [_tokens(e) for e in events] == want

    def test_restart_budget_exhausted(self, lm):
        cfg, model = lm
        sup = ServingSupervisor(
            lambda: Engine(cfg, model, ServeConfig(**SCFG)),
            SupervisorConfig(max_restarts=1))
        sup.attach(sup.factory())
        sup.restart()
        with pytest.raises(EngineCrash):
            sup.restart()


class TestDegradation:
    def test_tier_ladder_and_gates(self):
        c = DegradationController(SupervisorConfig(degrade_after=2,
                                                   recover_after=3))
        assert c.allows_spec and not c.shedding
        for _ in range(2):
            c.note(0, pressured=True)
        assert c.tier == 1
        for _ in range(4):
            c.note(0, pressured=True)
        assert c.tier == 3 and c.shedding and not c.allows_spec
        for _ in range(9):
            c.note(0)
        assert c.tier == 0 and c.allows_spec and not c.shedding

    def test_apply_halves_and_restores_prefill_budget(self, lm):
        cfg, model = lm
        eng = Engine(cfg, model, ServeConfig(**SCFG, prefill_budget=8))
        c = DegradationController(SupervisorConfig())
        c.tier = 1
        c.apply(eng, 8)
        assert eng.sched.prefill_budget == 4 and eng._degrade_tier == 1
        c.tier = 0
        c.apply(eng, 8)
        assert eng.sched.prefill_budget == 8 and eng._degrade_tier == 0

    def test_shedding_drops_queue_tail_and_rejects_submits(self, lm):
        cfg, model = lm
        eng = Engine(cfg, model, ServeConfig(max_batch=1, max_len=32))
        sup = ServingSupervisor(lambda: eng,
                                SupervisorConfig(degrade_after=1))
        sup.attach(eng)
        aeng = AsyncEngine(eng, supervisor=sup)   # loop not started
        events = [[] for _ in range(4)]
        for i in range(4):
            eng.submit([1, 2, 3], on_token=events[i].append)
        for _ in range(3):                        # escalate straight to 3
            sup.controller.note(0, pressured=True)
        sup._apply_tier()
        st = eng.stats()
        assert st.degrade_tier == 3
        assert st.load_sheds == 3                 # all queued; keep 1
        shed = [e for e in events
                if e and e[-1].finish_reason == FinishReason.ABORTED]
        assert len(shed) == 3
        assert all(sum(o.finished for o in e) == 1 for e in shed)
        with pytest.raises(EngineSaturated):
            aeng.submit([4, 5, 6])
        assert eng.stats().load_sheds == 4


class TestHungStepWatchdog:
    def test_injected_stall_is_flagged(self):
        w = StepWatchdog(k=6.0, window=40, min_steps=8)
        for n in range(12):
            assert w.observe(n, 0.010 + 1e-4 * (n % 3)) is None
        rep = w.observe(12, 0.5)                  # the injected hang
        assert rep is not None and rep.duration == 0.5

    def test_stop_before_start_is_typed(self):
        with pytest.raises(ValueError):
            StepWatchdog().stop()


class TestFrontendHardening:
    """Satellite 1: malformed / unknown / oversized lines get typed error
    lines and the connection survives until the error budget is spent."""

    def _serve(self, lm, coro, **srv_kw):
        cfg, model = lm
        eng = Engine(cfg, model, ServeConfig(**SCFG))

        async def main():
            async with AsyncEngine(eng) as aeng:
                async with FrontendServer(aeng, **srv_kw) as srv:
                    return await coro(srv)

        return asyncio.run(main())

    def test_bad_lines_get_typed_errors_connection_survives(self, lm):
        async def client(srv):
            async with ServeClient(port=srv.port) as c:
                await c.send_raw(b"}{ not json\n")
                assert (await c._recv())["error"] == "bad json"
                await c.send_raw(b"[1, 2, 3]\n")
                assert (await c._recv())["error"] == "unknown message type"
                await c._send({"no": "prompt"})
                assert (await c._recv())["error"] == "unknown message type"
                await c._send({"cancel": "not-an-int"})
                assert (await c._recv())["error"] == "bad cancel"
                # the connection still serves a real request afterwards
                evs = await c.request([1, 2, 3], max_tokens=3,
                                      temperature=0.0, ignore_eos=True)
                assert evs[-1]["finished"]
                assert len([e for e in evs
                            if e.get("token", -1) >= 0]) == 3
            return True

        assert self._serve(lm, client)

    def test_oversized_line_typed_error(self, lm):
        async def client(srv):
            async with ServeClient(port=srv.port) as c:
                await c.send_raw(b"x" * 4096 + b"\n")
                err = await c._recv()
                assert err["error"] == "oversized line"
            return True

        assert self._serve(lm, client, max_line_bytes=512)

    def test_error_budget_disconnects(self, lm):
        async def client(srv):
            async with ServeClient(port=srv.port) as c:
                for _ in range(2):
                    await c.send_raw(b"nope\n")
                    assert "error" in await c._recv()
                await c.send_raw(b"nope\n")       # budget spent
                last = await c._recv()
                assert last["finished"] and "error" in last
                with pytest.raises(ConnectionError):
                    await c._recv()               # server hung up
            return True

        assert self._serve(lm, client, max_protocol_errors=2)


class TestAsyncSupervised:
    def test_async_loop_retries_and_restarts(self, lm):
        """The async host loop under faults: a retryable commit raise, then
        a host-loop crash -> snapshot-restore; all requests finish with
        baseline tokens and the loop keeps serving."""
        cfg, model = lm
        prompts = _prompts(6, 3)
        want = _baseline(cfg, model, prompts, max_tokens=8)
        from repro_torch.serving.faults import FaultPlan as FP
        plan = FP([Fault("commit", "raise", at=2),
                   Fault("loop", "crash", at=6)])
        scfg = ServeConfig(**SCFG)

        def factory():
            e = Engine(cfg, model, scfg)
            e.fault_hook = plan.engine_hook
            return e

        sup = ServingSupervisor(factory)
        eng = factory()

        async def main():
            async with AsyncEngine(eng, supervisor=sup) as aeng:
                aeng.loop_fault_hook = plan.loop_hook
                sp = SamplingParams(max_tokens=8, ignore_eos=True)
                uids, tasks = [], []

                async def consume(uid, into):
                    async for out in aeng.stream(uid):
                        into.append(out)

                events = [[] for _ in prompts]
                for i, p in enumerate(prompts):
                    req = aeng.submit(p, sp)
                    uids.append(req.uid)
                    tasks.append(asyncio.ensure_future(
                        consume(req.uid, events[i])))
                await asyncio.gather(*tasks)
                return events, aeng.engine

        events, final = asyncio.run(main())
        assert plan.unfired() == []
        assert [_tokens(e) for e in events] == want
        st = final.stats()
        assert st.step_retries >= 1 and st.engine_restarts == 1
        assert final.allocator.blocks_in_use() == 0


class TestAgainstJaxFaultPlan:
    @pytest.mark.parametrize("seed", [0, 3, 11])
    def test_canned_schedules_equal_jax(self, seed):
        """A seed's chaos and crash schedules are the JAX package's, fault
        for fault, and the device_mem victim follows the same rule."""
        from repro.serving.faults import FaultPlan as JFaultPlan

        def spec(plan):
            return [(f.site, f.kind, f.at, f.run, f.arg) for f in plan.faults]

        assert spec(FaultPlan.chaos(seed=seed)) == spec(JFaultPlan.chaos(seed=seed))
        assert spec(FaultPlan.crash(seed=seed, kills=3, corruptions=2)) == \
            spec(JFaultPlan.crash(seed=seed, kills=3, corruptions=2))


class TestKVChecksums:
    def test_corrupt_block_found_and_recovered_with_parity(self, lm):
        """The sanitizer with KV checksums: one resident block bit-flipped
        through the device_mem site is found by ``check_kv_integrity``, its
        readers are recompute-preempted, and every request still streams
        the fault-free greedy tokens."""
        cfg, model = lm
        prompts = _prompts(7, 3, lo=9, hi=14)
        want = _baseline(cfg, model, prompts, max_tokens=8)
        plan = FaultPlan([Fault("device_mem", "bitflip", at=2)], seed=5)
        eng = Engine(cfg, model, ServeConfig(**SCFG, sanitize=True,
                                             kv_checksums=True,
                                             prefix_cache=True))
        sp = SamplingParams(max_tokens=8, ignore_eos=True)
        reqs = [eng.submit(p, sp) for p in prompts]
        victims, found, preempted = [], [], []
        while eng.has_pending():
            eng.step()
            v = plan.device_mem_hook(eng)
            if v is not None:
                victims.append(v)
                bad = eng.check_kv_integrity()
                found.extend(bad)
                preempted.extend(eng.recover_corrupt_blocks(bad))
            assert eng.check_kv_integrity() == []
        assert plan.unfired() == []
        assert found == victims and len(victims) == 1
        assert preempted, "no reader of the corrupt block was preempted"
        assert [list(r.output_tokens) for r in reqs] == want
        st = eng.stats()
        assert st.kv_corruptions == 1 and st.preemptions >= len(preempted)
        eng.shadow.assert_drained()

    @pytest.mark.parametrize("mode", ["bitflip", "garbage"])
    def test_corrupt_kv_block_touches_that_block_only(self, lm, mode):
        cfg, model = lm
        eng = Engine(cfg, model, ServeConfig(**SCFG))
        eng.submit([1, 2, 3, 4, 5], SamplingParams(max_tokens=2))
        eng.step()
        before = eng._kv_block_digests(range(eng.allocator.num_blocks))
        eng.corrupt_kv_block(2, seed=1, mode=mode)
        after = eng._kv_block_digests(range(eng.allocator.num_blocks))
        assert [b for b in before if before[b] != after[b]] == [2]
