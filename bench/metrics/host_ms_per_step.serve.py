"""host_ms_per_step.serve: the engine host loop's own time per step: the
program's Tracer spans plan + launch + commit that start inside the window,
less the time spent inside CUDA runtime calls during them
(``harness/trace.py::DeviceTrace.runtime``), over the steps committed in
the window.  A launch or copy waits
inside the runtime while the device's queue is full, so the runtime's time
is the device's, not the host's; what is left is the engine's Python and
PyTorch's dispatch.  The token sync runs on another thread, outside these
spans.  Nothing where the card's runtime calls were not recorded (a CPU
run has none to take away)."""


def read(run):
    tr = run.tracer
    if tr is None or tr._epoch is None or \
            (run.device.device == "cuda" and not run.device.runtime):
        return None
    spans, steps = [], 0
    for ev in tr.export()["traceEvents"]:
        if ev.get("ph") != "X" or ev["name"] not in ("plan", "launch", "commit"):
            continue
        t0 = tr._epoch + ev["ts"] * 1e-6
        if not run.inside(t0):
            continue
        spans.append((t0, t0 + ev["dur"] * 1e-6))
        steps += ev["name"] == "commit"
    if not steps:
        return None
    host = sum(b - a for a, b in spans) - run.device.overlap(run.device.runtime, spans)
    return 1e3 * host / steps
