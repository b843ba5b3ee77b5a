"""step_mfu.serve: the whole serving step's share of the card's roofline,
in percent: the least time of the steps launched inside the window
(useful operations at their type's data-sheet peak or compulsory bytes at
the HBM rate, whichever is larger, from the configuration's shapes and
each row's depth: ``harness/work.py::serve_step_seconds``) over the
window's wall time."""
from harness.work import serve_step_seconds, shape_of


def read(run):
    steps = [s for s in run.steps if run.inside(s["t"])]
    if not steps or run.window_s <= 0:
        return None
    shape = shape_of(run.config)
    least = sum(serve_step_seconds(shape, s["rows"]) for s in steps)
    return 100.0 * least / run.window_s
