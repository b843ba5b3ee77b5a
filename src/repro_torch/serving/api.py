"""Serving request-lifecycle API (the user-facing half of the engine).

A caller builds a :class:`GenerationRequest` (prompt + per-request
:class:`SamplingParams`), submits it to the :class:`~repro.serving.engine.
Engine`, and consumes :class:`StepOutput` events — one per generated token —
either via ``Engine.stream()`` / ``Engine.step()`` or a per-request
``on_token`` callback.  When a request finishes, the final event carries a
:class:`FinishReason`.

Lifecycle: a submitted request *waits* in the scheduler queue, is *admitted*
into a decode slot, *prefills* (chunked), *decodes*, and *finishes* — with
``STOP`` (EOS), ``LENGTH`` (max_tokens or cache capacity), or ``ABORTED``
(rejected before any compute: empty / oversized prompt, or a full request
queue under backpressure).  Two reasons end a request from the *outside* at
any point in that lifecycle — queued, mid-prefill, or mid-decode:
``CANCELLED`` (``Engine.cancel()`` / a dropped client connection) and
``DEADLINE`` (the request's deadline passed before it finished).  Both keep
the tokens generated so far, immediately free the slot, and release its KV
blocks back to the allocator (or the prefix cache, which keeps the written
prefix resident for future requests); the terminal :class:`StepOutput` is a
marker event with ``token == -1``, and no further events are ever emitted
for that uid.

This module is deliberately jax-free: it is the stable surface contract;
scheduling lives in serving/scheduler.py and jitted compute in
serving/engine.py.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Callable, Dict, List, Optional, Sequence


class FinishReason(str, enum.Enum):
    STOP = "stop"          # hit an EOS / stop token
    LENGTH = "length"      # max_tokens generated, or per-slot cache exhausted
    ABORTED = "aborted"    # rejected (oversized prompt, or queue backpressure)
    CANCELLED = "cancelled"  # Engine.cancel() — queued, mid-prefill, or mid-decode
    DEADLINE = "deadline"  # per-request deadline passed before completion
    ERROR = "error"        # quarantined: the request's step failed repeatedly


class ServingError(RuntimeError):
    """Base class for typed serving-path failures.

    Everything the serving stack raises on purpose derives from this (or
    from :class:`~repro.serving.paged.BlockPoolError`, which predates it),
    so supervisors and front-ends can distinguish engine faults from
    programming errors."""


class StepFailure(ServingError):
    """A committed step produced unusable output (non-finite logits surfaced
    as out-of-range sentinel tokens, or an injected device fault).  Raised by
    ``Engine.commit_step`` *before* any scheduler/request mutation, so the
    failed plan can be re-launched verbatim.  ``uids``/``slots`` name the
    rows the failure was attributed to (empty when not row-attributable)."""

    def __init__(self, message: str, uids: Sequence[int] = (),
                 slots: Sequence[int] = ()):
        super().__init__(message)
        self.uids = list(uids)
        self.slots = list(slots)


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request decode controls (engine defaults fill unset requests).

    ``max_tokens`` counts *generated* tokens only — the prompt never counts,
    and the first token (sampled from the prefill logits) does.
    ``temperature == 0`` selects greedy decoding; otherwise top-p nucleus
    sampling at the given temperature.  ``seed`` makes stochastic sampling
    reproducible per request; ``None`` derives a seed from the engine seed
    and the request uid.
    """
    max_tokens: int = 32
    temperature: float = 0.0
    top_p: float = 1.0
    seed: Optional[int] = None
    ignore_eos: bool = False


@dataclasses.dataclass
class GenerationRequest:
    """One prompt in flight.  Mutable runtime fields are engine-owned.

    ``deadline`` is an absolute ``time.perf_counter()`` instant (``None`` =
    no deadline): once passed, the engine finishes the request with
    ``FinishReason.DEADLINE`` at the next step boundary — whether it is
    still queued, mid-prefill, or mid-decode — keeping any tokens generated
    so far.  Callers usually set it via the ``deadline_s`` (relative
    seconds) argument of ``Engine.submit`` / the async front-end.
    """
    uid: int
    prompt: List[int]
    params: SamplingParams = dataclasses.field(default_factory=SamplingParams)
    on_token: Optional[Callable[["StepOutput"], None]] = None
    deadline: Optional[float] = None
    # -- engine-owned runtime state ------------------------------------------
    output_tokens: List[int] = dataclasses.field(default_factory=list)
    finish_reason: Optional[FinishReason] = None

    @property
    def done(self) -> bool:
        return self.finish_reason is not None

    @property
    def num_generated(self) -> int:
        return len(self.output_tokens)


@dataclasses.dataclass(frozen=True)
class StepOutput:
    """One generated token for one request (the streaming unit).

    Terminal *marker* events — rejection (``ABORTED``), cancellation
    (``CANCELLED``), deadline expiry (``DEADLINE``) — carry ``token == -1``
    and produce no new token; ``index`` is then the count of tokens the
    request had generated when it ended (``-1`` for admission rejections).
    """
    uid: int
    token: int
    index: int                                  # position in the output, 0-based
    finished: bool = False
    finish_reason: Optional[FinishReason] = None


@dataclasses.dataclass(frozen=True)
class EngineStats:
    """Lightweight runtime counters, snapshotted by ``Engine.stats()``.

    ``prefill_positions`` counts cache positions actually run through
    chunked-prefill steps (accounted per chunk as it runs, not per
    admission, so half-prefilled preemptions are charged only for the work
    done); ``prefill_positions_skipped`` counts positions covered by
    prefix-cache-shared blocks instead (zero prefill compute);
    ``prefill_chunks`` is how many per-slot chunks those positions took.
    ``ttft_ms`` holds time-to-first-token percentiles (mean / p50 / p95 /
    p99, wall-clock from submit to the first sampled token) once any request
    has produced one, else ``None``; ``queue_wait_ms`` the same percentiles
    for submit -> admission (how long requests sat in the waiting queue) and
    ``e2e_latency_ms`` for submit -> finish (end-to-end request latency,
    terminal marker events included).  ``queue_depth`` is the instantaneous
    waiting-queue length at snapshot time and ``tokens_generated`` the total
    tokens emitted so far; ``cancellations`` / ``deadline_expirations``
    count requests ended by ``Engine.cancel()`` and by deadline expiry.

    ``step_gap_ms`` holds percentiles of the host-side *dispatch gap* — the
    wall time between a step's outputs being synced off the device and the
    next step's dispatch returning, i.e. how long the device sat idle while
    the host scheduled; ``steps_overlapped`` counts steps that were
    dispatched *before* the previous step was synced (the async loop's
    speculative launches — their gap is zero by construction) out of
    ``steps_committed`` total.

    Block fields are ``None`` on the contiguous (non-paged) path, and
    ``prefix_cache`` is ``None`` unless ``ServeConfig.prefix_cache`` is on —
    when set it holds the radix-cache counters (hits / misses / evictions /
    tokens_matched / cached_blocks / cached_unreferenced_blocks).

    ``sanitizer`` is ``None`` unless ``ServeConfig.sanitize`` is on — when
    set it holds the shadow block pool's counters (transitions validated,
    write-set checks, allocator cross-verifications, published blocks, and
    the per-state block census).

    The robustness counters are filled in by the engine and the serving
    supervisor (serving/supervisor.py): ``step_failures`` counts steps whose
    commit raised (injected device faults, non-finite logits);
    ``step_retries`` how many of those were re-launched against the same
    plan; ``quarantines`` requests finished with ``FinishReason.ERROR``
    after repeated attributable failures; ``engine_restarts`` full
    snapshot-restore cycles; ``load_sheds`` requests rejected or dropped by
    graceful degradation; ``hung_steps`` steps flagged by the median+k·MAD
    hung-step watchdog; ``degrade_tier`` the current degradation tier
    (0 = normal .. 3 = shedding); ``recovery_ms`` percentiles of
    crash-to-first-committed-step wall time across restarts.

    ``requests_submitted`` counts requests accepted by
    ``Engine.submit_request`` — unlike ``admissions`` it does not
    double-count preemption re-admissions, so it equals the number of
    per-request root spans in a trace (supervisor restarts preserve it
    across re-submission of salvaged requests).

    Every field is also exported live by the engine's metrics registry
    (``Engine.metrics``; see the README Observability catalog).  The
    mapping is mechanical: counters gain a ``serving_`` prefix and a
    ``_total`` suffix (``steps_committed`` ↔
    ``serving_steps_committed_total``), instantaneous values are gauges
    (``queue_depth`` ↔ ``serving_queue_depth``, ``blocks_free`` ↔
    ``serving_kv_blocks_free``), and every ``*_ms`` percentile dict is
    rendered from a fixed-memory histogram of the same name
    (``ttft_ms`` ↔ ``serving_ttft_ms``, ``e2e_latency_ms`` ↔
    ``serving_e2e_latency_ms``).
    """
    requests_submitted: int = 0
    admissions: int = 0
    preemptions: int = 0
    prefill_positions: int = 0
    prefill_positions_skipped: int = 0
    prefill_chunks: int = 0
    tokens_generated: int = 0
    queue_depth: int = 0
    cancellations: int = 0
    deadline_expirations: int = 0
    steps_committed: int = 0
    steps_overlapped: int = 0
    ttft_ms: Optional[Dict[str, float]] = None
    queue_wait_ms: Optional[Dict[str, float]] = None
    e2e_latency_ms: Optional[Dict[str, float]] = None
    step_gap_ms: Optional[Dict[str, float]] = None
    blocks_in_use: Optional[int] = None
    blocks_free: Optional[int] = None
    prefix_cache: Optional[Dict[str, int]] = None
    sanitizer: Optional[Dict[str, int]] = None
    # -- robustness (fault-injected serving; see serving/supervisor.py) ------
    step_failures: int = 0
    step_retries: int = 0
    quarantines: int = 0
    engine_restarts: int = 0
    load_sheds: int = 0
    hung_steps: int = 0
    degrade_tier: int = 0
    recovery_ms: Optional[Dict[str, float]] = None
    # -- durability (request journal + device-memory integrity; PR 10) -------
    # kv_corruptions: resident KV blocks whose shadow checksum sweep
    # (ServeConfig.kv_checksums) caught silent device-memory corruption —
    # each recovered by recompute-preempting the rows reading the block.
    # journal_records / journal_commits: records appended and fsync batches
    # written by this process's journal writer (None when journaling is off);
    # journal_replays: recoveries this journal directory has seen in total.
    kv_corruptions: int = 0
    journal_records: Optional[int] = None
    journal_commits: Optional[int] = None
    journal_replays: Optional[int] = None


def make_request(prompt: Sequence[int], uid: int,
                 params: Optional[SamplingParams] = None,
                 on_token: Optional[Callable[[StepOutput], None]] = None,
                 deadline: Optional[float] = None) -> GenerationRequest:
    return GenerationRequest(uid=uid, prompt=list(prompt),
                             params=params or SamplingParams(),
                             on_token=on_token, deadline=deadline)
