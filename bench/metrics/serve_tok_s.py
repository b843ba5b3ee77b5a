"""serve_tok_s: output tokens emitted inside the window, over the window
(a one-token mix: requests per second)."""


def read(run):
    if not run.requests or run.window_s <= 0:
        return None
    n = sum(1 for r in run.requests for t in r.times if run.inside(t))
    return n / run.window_s
