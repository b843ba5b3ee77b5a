"""The hand-written kernels' boundary, where a counter may see one call.

Each ``kernels/*/ops.py`` calls its kernel's implementation through
:func:`call`, on every device: the CUDA kernel on a CUDA tensor, the plain
PyTorch version on a CPU tensor, empty outputs of the kernel's shapes on a
meta tensor.  With no observer (always, but inside
``launch/op_analysis.count``) it is a plain call.  An observer counts the
call as one kernel, by its work (``launch/roofline.kernel_work``), and does
not count the ATen ops the implementation runs, so a kernel is counted the
same whichever implementation ran it.
"""
from __future__ import annotations

_observer = None


def call(name: str, impl, *args):
    """``impl(*args)``, seen by the active observer as one call of kernel
    ``name`` (its launch counter's name)."""
    obs = _observer
    if obs is None:
        return impl(*args)
    return obs.kernel_call(name, impl, args)


def set_observer(obs) -> None:
    global _observer
    _observer = obs


def observer():
    return _observer
