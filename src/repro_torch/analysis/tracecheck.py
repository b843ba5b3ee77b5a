"""Chrome trace-event JSON schema checker (pure stdlib).

Validates the subset of the Trace Event Format the serving tracer emits
(``repro_torch.serving.tracing``) so CI can gate ``serving_loadgen --smoke
--trace`` on a structurally loadable file rather than eyeballing
Perfetto: the object form (``{"traceEvents": [...]}``), complete events
(``ph == "X"``), instants (``"i"``), and metadata (``"M"``).

``check_trace`` returns a list of human-readable problems (empty ==
valid); ``validate_trace`` raises :class:`TraceCheckError` with the
first few.  Both accept a path, a parsed dict, or a JSON string.

Port of ``repro/analysis/tracecheck.py``, copied with the package renamed.
"""
from __future__ import annotations

import json
import numbers
from typing import List, Union

__all__ = ["TraceCheckError", "check_trace", "validate_trace"]

_KNOWN_PHASES = {"X", "i", "M", "B", "E", "C"}
_METADATA_NAMES = {"process_name", "thread_name", "process_labels",
                   "process_sort_index", "thread_sort_index"}


class TraceCheckError(ValueError):
    """The trace file is not Perfetto-loadable (schema violations)."""


def _is_num(v) -> bool:
    return isinstance(v, numbers.Real) and not isinstance(v, bool)


def _is_id(v) -> bool:
    return isinstance(v, (int, str)) and not isinstance(v, bool)


def _check_event(ev, i: int, errs: List[str]) -> None:
    where = f"traceEvents[{i}]"
    if not isinstance(ev, dict):
        errs.append(f"{where}: event is {type(ev).__name__}, not an object")
        return
    ph = ev.get("ph")
    if not isinstance(ph, str) or not ph:
        errs.append(f"{where}: missing/invalid 'ph'")
        return
    if ph not in _KNOWN_PHASES:
        errs.append(f"{where}: unsupported phase {ph!r}")
        return
    name = ev.get("name")
    if not isinstance(name, str) or not name:
        errs.append(f"{where}: missing/invalid 'name'")
    if "pid" not in ev or not _is_id(ev["pid"]):
        errs.append(f"{where}: missing/invalid 'pid'")

    if ph == "M":
        if name not in _METADATA_NAMES:
            errs.append(f"{where}: unknown metadata event {name!r}")
        args = ev.get("args")
        if not isinstance(args, dict):
            errs.append(f"{where}: metadata event needs an 'args' object")
        return

    # timed events
    if "tid" not in ev or not _is_id(ev["tid"]):
        errs.append(f"{where}: missing/invalid 'tid'")
    ts = ev.get("ts")
    if not _is_num(ts):
        errs.append(f"{where}: missing/non-numeric 'ts'")
    elif ts < 0:
        errs.append(f"{where}: negative 'ts' ({ts})")
    if ph == "X":
        dur = ev.get("dur")
        if not _is_num(dur):
            errs.append(f"{where}: complete event missing numeric 'dur'")
        elif dur < 0:
            errs.append(f"{where}: negative 'dur' ({dur})")
    if ph == "i" and ev.get("s") not in (None, "t", "p", "g"):
        errs.append(f"{where}: instant scope {ev.get('s')!r} invalid")
    args = ev.get("args")
    if args is not None and not isinstance(args, dict):
        errs.append(f"{where}: 'args' must be an object when present")


def check_trace(trace: Union[str, dict]) -> List[str]:
    """Validate a trace document.  ``trace`` may be a parsed dict, a path
    to a JSON file, or a JSON string.  Returns a list of problems."""
    if isinstance(trace, str):
        text = trace
        if not trace.lstrip().startswith(("{", "[")):
            try:
                with open(trace) as f:
                    text = f.read()
            except OSError as e:
                return [f"cannot read trace file: {e}"]
        try:
            trace = json.loads(text)
        except json.JSONDecodeError as e:
            return [f"not valid JSON: {e}"]

    errs: List[str] = []
    if isinstance(trace, list):
        # the bare JSON-array flavor is legal but our tracer emits the
        # object form; accept both
        events = trace
    elif isinstance(trace, dict):
        events = trace.get("traceEvents")
        if not isinstance(events, list):
            return ["top-level object has no 'traceEvents' array"]
    else:
        return [f"trace root is {type(trace).__name__}, "
                "expected object or array"]

    if not events:
        errs.append("trace contains no events")
    for i, ev in enumerate(events):
        _check_event(ev, i, errs)
        if len(errs) >= 50:
            errs.append("... (further problems elided)")
            break
    return errs


def validate_trace(trace: Union[str, dict]) -> None:
    """Raise :class:`TraceCheckError` if the trace is malformed."""
    errs = check_trace(trace)
    if errs:
        head = "; ".join(errs[:5])
        more = f" (+{len(errs) - 5} more)" if len(errs) > 5 else ""
        raise TraceCheckError(f"malformed trace: {head}{more}")
