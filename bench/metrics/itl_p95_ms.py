"""itl_p95_ms: the 95th percentile of every gap between consecutive output
tokens of one request, both emitted inside the window."""
from harness.record import percentile


def read(run):
    gaps = [(b - a) * 1e3 for r in run.requests
            for a, b in zip(r.times, r.times[1:])
            if run.inside(a) and run.inside(b)]
    return percentile(gaps, 95)
