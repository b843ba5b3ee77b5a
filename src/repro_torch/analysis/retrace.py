"""Step-signature watchdog: fail when steady-state serving steps meet a new
shape, or build the kernels — port of ``repro/analysis/retrace.py``.

JAX's engine jits its step impls, and every new argument signature is a
multi-second compile; its watchdog counts traces.  Eager PyTorch has no
compile cache to miss, so JAX's "traced twice for one signature" check has
no counterpart here.  What still costs in steady state:

* a new signature — the shapes and dtypes of the step's tensors and its
  hashable statics — after the workload's warm-up: an unbucketed width
  (a chunk length or a block-table width off its power-of-two bucket)
  means new allocations, new kernel plans and a workload whose shapes
  never settle;
* a build of the CUDA kernels (``kernels/build.py::build`` compiling,
  ``BuildInfo.seconds > 0``): a first request that meets it waits ~20 s
  for its first token.

:meth:`RetraceWatchdog.attach` wraps the engine's step impls
(``_decode_impl``, ``_chunk_step_impl``, ``_chunk_scan_impl``) with a
counting wrapper and counts kernel builds from then on.  After
:meth:`freeze` (the workload's steady state), a new (impl, signature) or a
build is a violation; ``check()`` raises :class:`RetraceError` naming them.
``counts`` is exposed for tests.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

IMPLS = ("_decode_impl", "_chunk_step_impl", "_chunk_scan_impl")


class RetraceError(RuntimeError):
    """A serving step met a new signature, or built the kernels, in steady
    state."""


def _signature(args, kwargs) -> Tuple:
    """Hashable signature of a call: (shape, dtype, device type) per tensor,
    the value of each hashable static, and the type alone of host data
    (the rows that draw a sample: values, not shapes)."""
    def leaf(x):
        if hasattr(x, "shape") and hasattr(x, "dtype"):
            return (tuple(x.shape), str(x.dtype), x.device.type)
        if isinstance(x, (list, tuple, dict, set)):
            return type(x).__name__
        try:
            hash(x)
        except TypeError:
            return type(x).__name__
        return x

    return (tuple(leaf(x) for x in args),
            tuple(sorted((k, leaf(v)) for k, v in kwargs.items())))


class RetraceWatchdog:
    def __init__(self):
        # (impl name, signature) -> calls
        self.counts: Dict[Tuple[str, Tuple], int] = {}
        self.builds = 0
        self.frozen = False
        self._violations: List[str] = []

    def wrap(self, name: str, fn):
        """Counting wrapper: a new signature after freeze() is a violation."""

        def counted(*args, **kwargs):
            key = (name, _signature(args, kwargs))
            n = self.counts.get(key, 0)
            self.counts[key] = n + 1
            if n == 0 and self.frozen:
                self._violations.append(
                    f"{name} met a new signature after freeze() — "
                    "steady-state steps must reuse their shapes")
            return fn(*args, **kwargs)

        counted.__name__ = f"watchdog[{name}]"
        return counted

    def _watch_builds(self) -> None:
        from repro_torch.kernels import build as kb
        inner = kb.build
        wd = self

        def build():
            fresh = kb._lib is None
            info = inner()
            if fresh and info.seconds > 0:
                wd.builds += 1
                if wd.frozen:
                    wd._violations.append(
                        f"the kernels were built ({info.seconds:.1f} s) after "
                        "freeze() — build them before the first request")
            return info

        build.watchdog = self
        build.inner = inner
        kb.build = build
        self._restore = (kb, inner)

    def detach(self) -> None:
        """Stop counting builds (the step impls stay wrapped)."""
        restore = getattr(self, "_restore", None)
        if restore is not None:
            kb, inner = restore
            kb.build = inner
            self._restore = None

    @classmethod
    def attach(cls, engine) -> "RetraceWatchdog":
        """Wrap ``engine``'s step impls with counting wrappers and count the
        kernel builds from now on."""
        wd = cls()
        for attr in IMPLS:
            if hasattr(engine, attr):
                setattr(engine, attr, wd.wrap(attr, getattr(engine, attr)))
        wd._watch_builds()
        return wd

    def freeze(self) -> None:
        """Declare steady state: every signature the workload needs should
        have been met; any new one, or a build, is a violation."""
        self.frozen = True

    def calls_per_impl(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for (name, _), n in self.counts.items():
            out[name] = out.get(name, 0) + n
        return out

    def signatures_per_impl(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for name, _ in self.counts:
            out[name] = out.get(name, 0) + 1
        return out

    @property
    def violations(self) -> List[str]:
        return list(self._violations)

    def check(self) -> None:
        if self._violations:
            raise RetraceError(
                "; ".join(self._violations)
                + f" (signatures so far: {self.signatures_per_impl()})")
