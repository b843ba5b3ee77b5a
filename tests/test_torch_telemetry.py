"""The port's serving telemetry (``repro_torch.serving.telemetry`` /
``tracing``, ``analysis.tracecheck``), held to the contract of
tests/test_telemetry.py, whose cases are repeated here on the port's
engine at the same sizes.  Across packages: the same observations give
Prometheus text equal to the JAX ``MetricsRegistry``'s, and the port's
trace passes both the JAX ``validate_trace`` and the port's."""
import asyncio
import collections
import json
import math
import os

import torch
import numpy as np
import pytest

from repro_torch.analysis import check_trace, validate_trace
from repro_torch.models import build_model, get_config
from repro_torch.serving.api import FinishReason, SamplingParams
from repro_torch.serving.async_engine import AsyncEngine
from repro_torch.serving.engine import Engine, ServeConfig
from repro_torch.serving.faults import Fault, FaultPlan
from repro_torch.serving.frontend import FrontendServer, ServeClient
from repro_torch.serving.supervisor import ServingSupervisor, SupervisorConfig
from repro_torch.serving.telemetry import (EMPTY_PERCENTILES, Clock, FakeClock,
                                     FlightRecorder, Histogram,
                                     MetricsRegistry)
from repro_torch.serving.tracing import Tracer


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
    eng = Engine(cfg, model, ServeConfig(**SCFG))
    sp = SamplingParams(max_tokens=max_tokens, ignore_eos=True)
    reqs = [eng.submit(p, sp) for p in prompts]
    for _ in eng.stream():
        pass
    return [list(r.output_tokens) for r in reqs]


def _tokens(evs):
    return [o.token for o in evs if o.token >= 0]


# ---------------------------------------------------------------------------
# unit: clocks


class TestClocks:
    def test_fake_clock_advances_deterministically(self):
        fc = FakeClock(start=2.0)
        assert fc.now() == 2.0
        assert fc.advance(0.5) == 2.5
        assert fc.now() == fc.now() == 2.5     # time moves only via advance

    def test_fake_clock_rejects_negative(self):
        with pytest.raises(ValueError):
            FakeClock().advance(-0.1)

    def test_real_clock_is_monotonic(self):
        c = Clock()
        assert c.now() <= c.now()


# ---------------------------------------------------------------------------
# unit: histogram


class TestHistogram:
    def test_empty_renders_uniform_zero_shape(self):
        h = Histogram()
        assert len(h) == 0 and h.mean == 0.0
        assert h.percentiles() == EMPTY_PERCENTILES
        assert h.snapshot().percentiles() == EMPTY_PERCENTILES

    def test_single_sample_is_exact(self):
        h = Histogram()
        h.observe(7.25)
        assert h.percentiles() == {"mean": 7.25, "p50": 7.25,
                                   "p95": 7.25, "p99": 7.25}

    def test_degenerate_all_equal_is_exact(self):
        """vmin/vmax clamping makes all-equal series exact despite the
        ~21% geometric bucket width."""
        h = Histogram()
        for _ in range(100):
            h.observe(3.3)
        assert h.percentiles() == {"mean": pytest.approx(3.3),
                                   "p50": 3.3, "p95": 3.3, "p99": 3.3}

    def test_quantile_accuracy_vs_numpy(self):
        rng = np.random.default_rng(0)
        xs = rng.lognormal(mean=3.0, sigma=1.0, size=5000)
        h = Histogram()
        for v in xs:
            h.observe(v)
        p = h.percentiles()
        assert p["mean"] == pytest.approx(float(np.mean(xs)), rel=1e-9)
        assert h.vmin == float(np.min(xs)) and h.vmax == float(np.max(xs))
        for key, q in (("p50", 50), ("p95", 95), ("p99", 99)):
            want = float(np.percentile(xs, q))
            assert abs(p[key] - want) / want < 0.12    # bucket midpoint error

    def test_out_of_range_values_clamp_not_crash(self):
        h = Histogram()
        h.observe(1e-9)                       # below the 1e-3 bucket floor
        h.observe(1e9)                        # above the 1e5 bucket ceiling
        assert h.count == 2
        assert h.vmin == 1e-9 and h.vmax == 1e9
        p = h.percentiles()
        assert all(1e-9 <= p[k] <= 1e9 for k in ("p50", "p95", "p99"))

    def test_exact_zero_observations_render_zero(self):
        # overlapped dispatch gaps are 0.0 by construction; a majority of
        # zeros must render p50 == 0.0 exactly, not the 1e-3 bucket floor
        h = Histogram()
        for _ in range(10):
            h.observe(0.0)
        for v in (5.0, 7.0, 9.0):
            h.observe(v)
        p = h.percentiles()
        assert p["p50"] == 0.0
        assert p["p99"] > 0.0
        allz = Histogram()
        for _ in range(4):
            allz.observe(0.0)
        assert allz.percentiles() == EMPTY_PERCENTILES
        # an all-zero epoch diff stays exact too
        snap = h.snapshot()
        for _ in range(5):
            h.observe(0.0)
        d = h.since(snap)
        assert d.count == 5
        assert d.percentiles() == EMPTY_PERCENTILES

    def test_snapshot_since_diffs_two_epochs(self):
        h = Histogram()
        for _ in range(100):
            h.observe(1.0)
        snap = h.snapshot()
        assert h.since(snap).count == 0       # nothing new yet
        assert h.since(snap).percentiles() == EMPTY_PERCENTILES
        for _ in range(50):
            h.observe(1000.0)
        d = h.since(snap)
        assert d.count == 50 and len(d) == 50
        assert d.total == pytest.approx(50_000.0)
        # the delta sees only the second epoch: p50 must land near 1000,
        # nowhere near the 1.0 samples the snapshot already held
        assert 800.0 <= d.percentiles()["p50"] <= 1000.0


# ---------------------------------------------------------------------------
# unit: registry


class TestMetricsRegistry:
    def _reg(self):
        reg = MetricsRegistry()
        reg.counter("c", "a counter").inc(3)
        reg.gauge("g").set(2.5)
        h = reg.histogram("h", "a histogram")
        h.observe(5.0)
        h.observe(7.0)
        return reg

    def test_snapshot_shape(self):
        snap = self._reg().snapshot()
        assert snap["c"] == 3 and snap["g"] == 2.5
        assert snap["h"] == {"count": 2, "sum": 12.0, "min": 5.0,
                             "max": 7.0, "mean": 6.0,
                             "p50": snap["h"]["p50"],
                             "p95": snap["h"]["p95"],
                             "p99": snap["h"]["p99"]}
        assert 5.0 <= snap["h"]["p50"] <= 7.0

    def test_duplicate_name_raises(self):
        reg = self._reg()
        with pytest.raises(ValueError):
            reg.counter("c")
        with pytest.raises(ValueError):
            reg.gauge("h")                     # collision across kinds too

    def test_register_adopts_existing_and_rejects_junk(self):
        reg = MetricsRegistry()
        h = Histogram()
        h.observe(1.0)
        reg.register("carried", h)             # restart carry path
        assert reg.snapshot()["carried"]["count"] == 1
        with pytest.raises(TypeError):
            reg.register("junk", object())

    def test_callbacks_sample_at_render_time(self):
        reg = MetricsRegistry()
        box = {"v": 1}
        reg.register_callback("live", "gauge", lambda: box["v"])
        assert reg.snapshot()["live"] == 1
        box["v"] = 5
        assert reg.snapshot()["live"] == 5
        with pytest.raises(ValueError):
            reg.register_callback("bad", "histogram", lambda: 0)

    def test_prometheus_text_exposition(self):
        text = self._reg().render_prometheus()
        assert text.endswith("\n")
        assert "# HELP c a counter" in text
        assert "# TYPE c counter" in text and "\nc 3" in text
        assert "# TYPE h summary" in text
        for q in ("0.5", "0.95", "0.99"):
            assert f'h{{quantile="{q}"}}' in text
        assert "h_sum 12" in text and "h_count 2" in text


# ---------------------------------------------------------------------------
# unit: flight recorder


class TestFlightRecorder:
    def test_capacity_must_be_positive(self):
        with pytest.raises(ValueError):
            FlightRecorder(capacity=0)

    def test_ring_is_bounded_and_ordered(self):
        rec = FlightRecorder(capacity=4, clock=FakeClock())
        for i in range(10):
            rec.record("tick", i=i)
        assert len(rec) == 4
        assert [e["seq"] for e in rec.events()] == [7, 8, 9, 10]
        assert [e["i"] for e in rec.events()] == [6, 7, 8, 9]

    def test_dump_keeps_ring_and_writes_disk(self, tmp_path):
        fc = FakeClock()
        rec = FlightRecorder(capacity=8, dump_dir=str(tmp_path), clock=fc)
        for i in range(3):
            rec.record("commit", step=i)
        d1 = rec.dump("step-retry", attempt=1)
        assert len(rec) == 3                   # dump does not clear the ring
        rec.record("commit", step=3)
        d2 = rec.dump("quarantine", uid=7)
        assert rec.dump_reasons() == ["step-retry", "quarantine"]
        assert len(d2["events"]) == 4          # consecutive dumps share ring
        names = sorted(p.name for p in tmp_path.iterdir())
        assert names == ["flight-0001-step-retry.json",
                         "flight-0002-quarantine.json"]
        with open(d1["path"]) as f:
            loaded = json.load(f)
        assert loaded["reason"] == "step-retry"
        assert loaded["context"] == {"attempt": 1}
        assert [e["kind"] for e in loaded["events"]] == ["commit"] * 3


# ---------------------------------------------------------------------------
# unit: tracer


class TestTracerUnit:
    def test_request_lifecycle_counts_and_schema(self):
        tr = Tracer(clock=FakeClock())
        tr.request_submit(1, 0.0)
        tr.request_admitted(1, 0.001)
        tr.prefill_chunk(1, 0.001, 0.002, 4)
        tr.request_first_token(1, 0.003)
        tr.request_finish(1, 0.004, "length", tokens=4)
        tr.plan_span(0.0, 0.001, step=0, active=1, chunks=1)
        tr.launch_span(0.001, 0.002, step=0)
        tr.device_span(0.002, 0.003, step=0)
        tr.sync_span(0.003, 0.0035, step=0)
        tr.commit_span(0.0035, 0.004, step=0, tokens=1, chunks=1)
        assert tr.counts["request"] == 1
        assert tr.counts["step"] == 1
        assert tr.counts["prefill_chunk"] == 1
        assert tr.open_requests() == []
        doc = tr.export()
        assert check_trace(doc) == []          # Perfetto-loadable schema
        assert doc["otherData"]["counts"]["request"] == 1
        assert doc["otherData"]["open_requests"] == []

    def test_submit_is_idempotent_for_restart_resubmission(self):
        tr = Tracer(clock=FakeClock())
        tr.request_submit(1, 0.0)
        tr.request_submit(1, 0.5)              # salvage re-submission
        assert tr.counts["request"] == 1
        tr.request_finish(99, 1.0, "error")    # unknown uid: ignored
        assert tr.open_requests() == [1]

    def test_export_to_path_validates(self, tmp_path):
        tr = Tracer(clock=FakeClock())
        tr.request_submit(3, 0.0)
        tr.request_finish(3, 0.01, "stop", tokens=2)
        out = tmp_path / "trace.json"
        tr.export(str(out))
        validate_trace(str(out))               # raises on malformed JSON
        with open(out) as f:
            evs = json.load(f)["traceEvents"]
        # exported = process/thread metadata + the recorded events
        assert len([e for e in evs if e["ph"] != "M"]) == tr.num_events()


# ---------------------------------------------------------------------------
# integration: engine


class TestEngineTelemetry:
    def test_trace_reconciles_with_stats(self, lm):
        cfg, model = lm
        eng = Engine(cfg, model, ServeConfig(**SCFG))
        tr = Tracer(clock=eng.clock)
        eng.tracer = tr
        prompts = _prompts(0, 3)
        sp = SamplingParams(max_tokens=4, ignore_eos=True)
        for p in prompts:
            eng.submit(p, sp)
        for _ in eng.stream():
            pass
        st = eng.stats()
        assert tr.counts["request"] == st.requests_submitted == 3
        assert tr.counts["step"] == st.steps_committed
        assert tr.counts["prefill_chunk"] == st.prefill_chunks
        assert tr.open_requests() == []        # every span tree closed
        validate_trace(tr.export())
        # the registry serves the same numbers as EngineStats
        snap = eng.metrics.snapshot()
        assert snap["serving_requests_submitted_total"] == 3
        assert snap["serving_steps_committed_total"] == st.steps_committed
        assert snap["serving_tokens_generated_total"] == st.tokens_generated
        assert snap["serving_ttft_ms"]["count"] == 3
        assert snap["serving_e2e_latency_ms"]["count"] == 3
        assert st.ttft_ms["p50"] == snap["serving_ttft_ms"]["p50"]

    def test_stats_percentiles_guarded_uniformly(self, lm):
        """Every latency series is None until its first sample, then the
        same four-key dict — no per-field ad-hoc guards."""
        cfg, model = lm
        eng = Engine(cfg, model, ServeConfig(**SCFG))
        st = eng.stats()                       # cheap mid-run snapshot
        assert st.ttft_ms is None and st.queue_wait_ms is None
        assert st.e2e_latency_ms is None and st.step_gap_ms is None
        assert st.recovery_ms is None
        eng.submit(_prompts(1, 1)[0], SamplingParams(max_tokens=3,
                                                     ignore_eos=True))
        for _ in eng.stream():
            pass
        st = eng.stats()
        for series in (st.ttft_ms, st.queue_wait_ms, st.e2e_latency_ms):
            assert set(series) == {"mean", "p50", "p95", "p99"}
        assert st.recovery_ms is None          # no failures: still empty

    def test_fake_clock_makes_latencies_exact(self, lm):
        cfg, model = lm
        eng = Engine(cfg, model, ServeConfig(**SCFG), clock=FakeClock())
        eng.submit(_prompts(2, 1)[0], SamplingParams(max_tokens=3,
                                                     ignore_eos=True))
        eng.clock.advance(0.25)                # 250 ms in the queue
        for _ in eng.stream():
            pass
        st = eng.stats()
        want = {"mean": 250.0, "p50": 250.0, "p95": 250.0, "p99": 250.0}
        assert st.queue_wait_ms == pytest.approx(want)
        assert st.ttft_ms == pytest.approx(want)      # clock frozen after

    def test_recorder_sees_engine_and_scheduler_events(self, lm):
        cfg, model = lm
        eng = Engine(cfg, model, ServeConfig(**SCFG))
        rec = FlightRecorder(clock=eng.clock)
        eng.recorder = rec
        eng.sched.recorder = rec
        eng.submit(_prompts(3, 1)[0], SamplingParams(max_tokens=3,
                                                     ignore_eos=True))
        for _ in eng.stream():
            pass
        kinds = collections.Counter(e["kind"] for e in rec.events())
        assert kinds["admit"] == 1
        assert kinds["commit"] == eng.stats().steps_committed
        assert rec.dumps == []                 # nothing dumped: no faults


# ---------------------------------------------------------------------------
# integration: supervisor recovery seams


class TestSupervisedTelemetry:
    def _supervised(self, cfg, model, faults, prompts, tmp_path,
                    sup_cfg=None, max_tokens=6):
        plan = FaultPlan(faults)
        scfg = ServeConfig(**SCFG)

        def factory():
            e = Engine(cfg, model, scfg)
            e.fault_hook = plan.engine_hook
            return e

        sup = ServingSupervisor(
            factory, sup_cfg or SupervisorConfig(flight_dir=str(tmp_path)))
        eng = factory()
        sup.attach(eng)
        eng.tracer = Tracer(clock=eng.clock)
        sp = SamplingParams(max_tokens=max_tokens, ignore_eos=True)
        events = [[] for _ in prompts]
        for i, p in enumerate(prompts):
            eng.submit(p, sp, on_token=events[i].append)
        return sup, events

    def test_every_recovery_action_leaves_a_dump(self, lm, tmp_path):
        """A retried transient plus a quarantined NaN row: dump reasons
        reconcile exactly with the stats counters, one on-disk artifact
        per dump, spans stay closed, bystanders keep baseline tokens."""
        cfg, model = lm
        prompts = _prompts(2, 3)
        want = _baseline(cfg, model, prompts)
        sup, events = self._supervised(
            cfg, model,
            [Fault("plan", "raise", at=1),
             Fault("commit", "nan", at=6, run=2)],
            prompts, tmp_path,
            sup_cfg=SupervisorConfig(quarantine_after=2,
                                     flight_dir=str(tmp_path)))
        sup.drive()
        eng = sup.engine
        st = eng.stats()
        reasons = collections.Counter(sup.recorder.dump_reasons())
        assert st.step_retries >= 1 and st.quarantines == 1
        assert reasons["step-retry"] == st.step_retries
        assert reasons["quarantine"] == st.quarantines
        assert reasons["engine-restart"] == st.engine_restarts
        on_disk = [p for p in tmp_path.iterdir()
                   if p.name.startswith("flight-")]
        assert len(on_disk) == len(sup.recorder.dumps)
        tr = eng.tracer
        assert tr.open_requests() == []
        assert tr.counts["request"] == st.requests_submitted
        assert tr.counts["step"] == st.steps_committed
        validate_trace(tr.export())
        errored = [i for i, e in enumerate(events)
                   if e[-1].finish_reason == FinishReason.ERROR]
        assert len(errored) == 1
        for i, e in enumerate(events):
            assert sum(o.finished for o in e) == 1
            if i not in errored:
                assert _tokens(e) == want[i]

    def test_restart_carries_telemetry_to_new_engine(self, lm, tmp_path):
        cfg, model = lm
        prompts = _prompts(4, 3)
        want = _baseline(cfg, model, prompts, max_tokens=8)
        sup, events = self._supervised(cfg, model, [], prompts, tmp_path,
                                       max_tokens=8)
        old = sup.engine
        tr = old.tracer
        for _ in range(4):                     # partial progress
            sup.run_step()
        new = sup.restart()
        assert new.tracer is tr                # one tracer per lifetime
        assert new.recorder is sup.recorder
        assert new.clock is old.clock          # one shared timeline
        sup.drive()
        assert [_tokens(e) for e in events] == want
        st = new.stats()
        assert st.engine_restarts == 1
        reasons = collections.Counter(sup.recorder.dump_reasons())
        assert reasons["engine-restart"] == 1
        assert (tmp_path / "flight-0001-engine-restart.json").exists()
        # idempotent request_submit: salvage re-submission did not
        # double-count request spans
        assert tr.counts["request"] == st.requests_submitted == len(prompts)
        assert tr.open_requests() == []
        validate_trace(tr.export())
        # carried histograms kept pre-restart samples and live in the new
        # engine's rebuilt registry
        assert new.metrics.snapshot()["serving_ttft_ms"]["count"] == \
            len(prompts)


# ---------------------------------------------------------------------------
# integration: front-end stats message


class TestFrontendStats:
    def test_stats_roundtrip_json_and_prometheus(self, lm):
        cfg, model = lm
        eng = Engine(cfg, model,
                     ServeConfig(max_batch=1, max_len=48, kv_block_size=4))

        async def main():
            async with AsyncEngine(eng, max_queue=2) as aeng:
                async with FrontendServer(aeng) as srv:
                    async with ServeClient(port=srv.port) as c:
                        evs = await c.request([1, 2, 3, 4], max_tokens=4,
                                              temperature=0.0,
                                              ignore_eos=True)
                        snap = await c.stats()
                        prom = await c.stats(format="prometheus")
                    return evs, snap, prom

        evs, snap, prom = asyncio.run(main())
        assert evs[-1]["finished"]
        assert snap["type"] == "stats"
        s = snap["stats"]
        assert s["serving_requests_submitted_total"] == 1
        assert s["serving_tokens_generated_total"] == 4
        assert s["serving_ttft_ms"]["count"] == 1
        assert prom["format"] == "prometheus"
        assert "# TYPE serving_ttft_ms summary" in prom["text"]
        assert 'serving_ttft_ms{quantile="0.99"}' in prom["text"]


class TestAgainstJaxTelemetry:
    def test_prometheus_text_equals_jax_registry(self):
        """The same observations through both packages' registries (every
        kind, callbacks, values spread over the buckets and out of range)
        render the same Prometheus text and the same snapshot."""
        from repro.serving.telemetry import MetricsRegistry as JRegistry

        rng = np.random.default_rng(0)
        xs = np.concatenate([rng.lognormal(1.0, 2.0, 500), [0.0, 1e-9, 1e9]])
        regs = []
        for Reg in (MetricsRegistry, JRegistry):
            reg = Reg()
            reg.counter("reqs_total", "requests").inc(7)
            reg.gauge("depth", "queue depth").set(3.25)
            h = reg.histogram("lat_ms", "latency")
            for x in xs:
                h.observe(float(x))
            reg.register_callback("live", "gauge", lambda: 11, "a callback")
            regs.append(reg)
        assert regs[0].render_prometheus() == regs[1].render_prometheus()
        assert regs[0].snapshot() == regs[1].snapshot()

    def test_engine_metrics_and_trace_against_jax(self, lm):
        """The port's engine under a ``FakeClock``: its registry renders the
        JAX engine's Prometheus text on the same workload (same bridged
        params, same steps), and its trace passes both packages' schema
        checkers with counts equal to its stats."""
        import jax
        from repro.analysis import validate_trace as jvalidate
        from repro.models import build_model as jbuild
        from repro.models import get_config as jget
        from repro.serving.api import SamplingParams as JSamplingParams
        from repro.serving.engine import Engine as JEngine
        from repro.serving.engine import ServeConfig as JServeConfig
        from repro.serving.telemetry import FakeClock as JFakeClock
        from repro_torch.bridge import jax_params_to_torch

        jcfg = jget("qwen1.5-0.5b").reduced(layers=2).replace(
            compute_dtype="float32", param_dtype="float32")
        jparams = jbuild(jcfg).init(jax.random.PRNGKey(0))
        cfg, _ = lm
        model = jax_params_to_torch(
            cfg, jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
        prompts = _prompts(3, 4)
        jeng = JEngine(jcfg, jparams, JServeConfig(paged=True, **SCFG),
                       clock=JFakeClock())
        for p in prompts:
            jeng.submit(p, JSamplingParams(max_tokens=5, ignore_eos=True))
        for _ in jeng.stream():
            pass
        eng = Engine(cfg, model, ServeConfig(**SCFG), clock=FakeClock())
        tr = Tracer(clock=eng.clock)
        eng.tracer = tr
        for p in prompts:
            eng.submit(p, SamplingParams(max_tokens=5, ignore_eos=True))
        for _ in eng.stream():
            pass
        assert eng.metrics.render_prometheus() == jeng.metrics.render_prometheus()
        doc = tr.export()
        validate_trace(doc)
        jvalidate(doc)
        st = eng.stats()
        counts = doc["otherData"]["counts"]
        assert counts["request"] == st.requests_submitted == 4
        assert counts["step"] == st.steps_committed
        assert counts["prefill_chunk"] == st.prefill_chunks
