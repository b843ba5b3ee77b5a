"""w2a8_roofline_pct.serve: 100 x the least time of the
window's ``w2a8_gemv`` calls (``harness/work.py``, from the arguments the
boundary observer recorded) over the profiler's device time of their CUDA
kernels (``metrics/kernel_names.json``); nothing when either is
missing."""
from harness.kernel_names import names_of


def read(run):
    return run.kernel_roofline_pct("w2a8_gemv", names_of("w2a8_gemv"))
