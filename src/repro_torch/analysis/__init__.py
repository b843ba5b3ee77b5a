"""Correctness tooling for the port: the static lint
(:mod:`repro_torch.analysis.lint`), the block-pool sanitizer
(:mod:`repro_torch.analysis.shadow`), the step-signature watchdog
(:mod:`repro_torch.analysis.retrace`) and the Chrome trace schema checker
(:mod:`repro_torch.analysis.tracecheck`); ``python -m repro_torch.analysis``
runs the lint and their self-tests.  ``lint``, ``shadow`` and
``tracecheck`` import no torch; ``retrace`` imports it where it counts
builds.
"""
from repro_torch.analysis.lint import (RULES, Finding, Linter, LintResult,
                                       run_lint, write_baseline)
from repro_torch.analysis.retrace import RetraceError, RetraceWatchdog
from repro_torch.analysis.shadow import BlockState, SanitizerError, ShadowBlockPool
from repro_torch.analysis.tracecheck import (TraceCheckError, check_trace,
                                             validate_trace)

__all__ = ["BlockState", "Finding", "Linter", "LintResult", "RULES",
           "RetraceError", "RetraceWatchdog", "SanitizerError",
           "ShadowBlockPool", "TraceCheckError", "check_trace", "run_lint",
           "validate_trace", "write_baseline"]
