"""Paged continuous-batching serving for the port: the engine, its host
modules (api, scheduler, block allocator, prefix cache; copies of the JAX
package's), sampling, and the service layers over the engine (async loop,
TCP front end, supervisor, faults, telemetry, tracing, journal and
recovery).  The exports are ``repro/serving/__init__.py``'s but its
``ServingEngine`` alias and ``sample_top_p``, which nothing here calls."""
from repro_torch.serving.api import (EngineStats, FinishReason, GenerationRequest,
                                     SamplingParams, StepOutput, make_request)
from repro_torch.serving.async_engine import (AsyncEngine, EngineOverloaded,
                                              drive_requests)
from repro_torch.serving.engine import (Engine, Request, ServeConfig,
                                        convert_to_packed)
from repro_torch.serving.frontend import FrontendServer, ServeClient
from repro_torch.serving.paged import BlockAllocator, BlockPoolError
from repro_torch.serving.prefix_cache import RadixPrefixCache
from repro_torch.serving.sampling import greedy, sample_batch
from repro_torch.serving.scheduler import Scheduler

__all__ = [
    "Engine", "ServeConfig", "Request", "convert_to_packed",
    "EngineStats", "FinishReason", "GenerationRequest", "SamplingParams",
    "StepOutput", "make_request", "Scheduler", "BlockAllocator",
    "BlockPoolError", "RadixPrefixCache", "greedy", "sample_batch",
    "AsyncEngine", "EngineOverloaded", "drive_requests",
    "FrontendServer", "ServeClient",
]
