"""step_mfu.distill: the whole distillation step's share of the card's
roofline, in percent: the least time of the steps completed inside the
window (teacher forward, student forward and backward, no recomputation:
``harness/work.py::distill_step_seconds``) over the window's wall time."""
from harness.work import distill_step_seconds


def read(run):
    done = [s for s in run.steps if s["end"] <= run.t_close]
    if not done or run.window_s <= 0:
        return None
    t = run.traffic
    rel = run.extra.get("relation")
    least = len(done) * distill_step_seconds(run.config, int(t["batch"]),
                                             int(t["seq"]), rel)
    return 100.0 * least / run.window_s
