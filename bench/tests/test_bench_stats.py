"""The end-to-end metrics' arithmetic on hand-made runs: rates over all the
window, tails over all its samples, and a stall inside the window moving
them."""
import bench_local  # noqa: F401
import pytest

from harness.record import Request, Run, percentile
from harness.spec import load_reader

READ = {n: load_reader(bench_local.BENCH, n)
        for n in ("serve_tok_s", "ttft_p95_ms", "itl_p95_ms", "distill_tok_s",
                  "setup_s")}


def test_percentile_by_hand():
    assert percentile([], 95) is None
    assert percentile([5.0], 95) == 5.0
    # 1..21: the 95th lies at rank 19 of 0..20
    assert percentile([float(i) for i in range(1, 22)], 95) == pytest.approx(20.0)
    assert percentile([0.0, 10.0], 50) == pytest.approx(5.0)


def _serve_run(stall: float = 0.0) -> Run:
    """Ten requests submitted at 0, 1, ..., 9 s, each answered 0.1 s later and
    then every 0.05 s for 4 more tokens; ``stall`` seconds added to every
    token after t = 5 s."""
    run = Run("x", {}, {}, 10.0, t_open=0.0, t_close=10.0)
    for i in range(10):
        r = Request(uid=i, prompt=[1], max_tokens=5, submit=float(i))
        for j in range(5):
            t = i + 0.1 + 0.05 * j
            r.times.append(t + (stall if t > 5.0 else 0.0))
            r.tokens.append(j)
        run.requests.append(r)
    return run


def test_serving_metrics_by_hand():
    run = _serve_run()
    assert READ["serve_tok_s"](run) == pytest.approx(50 / 10.0)
    assert READ["ttft_p95_ms"](run) == pytest.approx(100.0)
    assert READ["itl_p95_ms"](run) == pytest.approx(50.0)


def test_a_stall_inside_the_window_moves_them():
    calm, stalled = _serve_run(), _serve_run(stall=2.0)
    assert READ["ttft_p95_ms"](stalled) > READ["ttft_p95_ms"](calm) + 1000.0
    # tokens pushed past the window's close are not the window's
    assert READ["serve_tok_s"](stalled) < READ["serve_tok_s"](calm)
    # the stall falls between the tokens of requests in flight at 5 s
    for i in range(10):
        calm.requests.append(Request(uid=50 + i, prompt=[1], max_tokens=2,
                                     submit=4.8, times=[4.9, 7.0], tokens=[1, 2]))
    assert READ["itl_p95_ms"](calm) == pytest.approx(2100.0)


def test_a_failed_request_misses_every_limit():
    run = _serve_run()
    for i in range(3):
        run.requests.append(Request(uid=100 + i, prompt=[1], max_tokens=1, submit=9.0))
    assert READ["ttft_p95_ms"](run) is None


def test_distill_rate_counts_all_the_window():
    run = Run("x", {}, {}, 10.0, t_open=0.0, t_close=10.0, setup_s=3.5)
    run.steps = [{"start": i * 2.0, "end": i * 2.0 + 2.0, "tokens": 100} for i in range(5)]
    assert READ["distill_tok_s"](run) == pytest.approx(500 / 10.0)
    run.steps.append({"start": 10.0, "end": 12.0, "tokens": 100})   # past the close
    assert READ["distill_tok_s"](run) == pytest.approx(500 / 10.0)
    assert READ["setup_s"](run) == 3.5


class _Tracer:
    """The program's Tracer as the host-time reader sees it: spans in
    microseconds from an epoch."""

    def __init__(self, spans):
        self._epoch = 0.0
        self.events = [{"ph": "X", "name": n, "ts": a * 1e6, "dur": (b - a) * 1e6}
                       for n, a, b in spans]

    def export(self):
        return {"traceEvents": self.events}


@pytest.mark.parametrize("runtime,want_ms", [
    ([], None),                                         # the card's calls not recorded
    ([("cudaLaunchKernel", 6.0, 6.01)], 350.0),         # none inside the spans
    ([("cudaLaunchKernel", 1.05, 1.25)], 250.0),        # a launch waits 200 ms
    ([("cudaLaunchKernel", 0.9, 1.05), ("cudaMemcpyAsync", 5.0, 5.1)], 325.0),
])
def test_host_time_leaves_out_the_runtimes_waits(runtime, want_ms):
    """Two steps of 350 ms: plan 1.0-1.05, launch 1.05-1.3, commit 1.3-1.35,
    and the same at 3 s; a runtime call counts only where it lies inside
    them."""
    spans = [(n, a + t, b + t) for t in (0.0, 2.0)
             for n, a, b in (("plan", 1.0, 1.05), ("launch", 1.05, 1.3),
                             ("commit", 1.3, 1.35))]
    run = Run("x", {}, {}, 10.0, t_open=0.0, t_close=10.0, trace=True)
    run.tracer = _Tracer(spans)
    run.device.runtime = runtime
    run.device.device = "cuda"
    got = load_reader(bench_local.BENCH, "host_ms_per_step.serve")(run)
    assert got == (None if want_ms is None else pytest.approx(want_ms))


def test_the_served_sample_holds_the_longest_and_a_decoded_request():
    from harness.serve import sample
    run = Run("x", {}, {}, 10.0, t_open=0.0, t_close=10.0)
    for i in range(20):
        run.requests.append(Request(uid=i, prompt=[1] * (10 + i), max_tokens=4,
                                    tokens=[1, 2, 3, 4], reason="LENGTH"))
    run.extra["decode_steps"] = {3: 2, 7: 5}
    got = [r.uid for r in sample(run, 12345678901, 8)]
    assert got[:2] == [19, 7] and len(got) == 2
    run.extra["decode_steps"] = {}
    assert [r.uid for r in sample(run, 12345678901, 4)] == [19]
