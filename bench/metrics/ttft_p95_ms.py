"""ttft_p95_ms: the 95th percentile, over every request submitted inside
the window, of submit (an open loop: when it was due) to its first token;
a request that never got one counts as missing every limit."""
import math

from harness.record import percentile


def read(run):
    mine = [r for r in run.requests if run.inside(r.submit)]
    if not mine:
        return None
    v = percentile([(r.times[0] - r.submit) * 1e3 if r.times else math.inf
                    for r in mine], 95)
    return v if math.isfinite(v) else None
