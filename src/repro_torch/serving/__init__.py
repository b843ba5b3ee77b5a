"""Paged continuous-batching serving for the port (engine, scheduler, block
allocator, prefix cache, sampling).  The host modules api / paged /
prefix_cache / scheduler are copies of the JAX package's; telemetry copies
the clock and histogram of the JAX package's module."""
from repro_torch.serving.api import (EngineStats, FinishReason, GenerationRequest,
                                     SamplingParams, StepOutput, make_request)
from repro_torch.serving.engine import (Engine, Request, ServeConfig,
                                        convert_to_packed)

__all__ = ["Engine", "ServeConfig", "Request",
           "convert_to_packed", "EngineStats", "FinishReason",
           "GenerationRequest", "SamplingParams", "StepOutput", "make_request"]
