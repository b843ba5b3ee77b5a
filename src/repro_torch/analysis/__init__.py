"""Correctness tooling for the port's serving stack: the block-pool
sanitizer (:mod:`repro_torch.analysis.shadow`) and the Chrome trace schema
checker (:mod:`repro_torch.analysis.tracecheck`), copies of the JAX
package's modules of those names."""
from repro_torch.analysis.shadow import BlockState, SanitizerError, ShadowBlockPool
from repro_torch.analysis.tracecheck import (TraceCheckError, check_trace,
                                             validate_trace)

__all__ = ["BlockState", "SanitizerError", "ShadowBlockPool",
           "TraceCheckError", "check_trace", "validate_trace"]
