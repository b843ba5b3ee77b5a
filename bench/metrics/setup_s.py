"""setup_s: process start to the window's open, on the host clock: the
weights made and loaded (packed for serving), the kernels loaded (built, in
a checkout's first run), the warm-up."""


def read(run):
    return run.setup_s
