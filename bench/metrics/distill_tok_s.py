"""distill_tok_s: batch x seq x the steps completed inside the window, over
the window; each step ends at a synchronize, and so do the window's
edges."""


def read(run):
    done = [s for s in run.steps if s["end"] <= run.t_close]
    if not done or run.window_s <= 0:
        return None
    return sum(s["tokens"] for s in done) / run.window_s
