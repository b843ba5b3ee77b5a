"""Continuous-batching serving engine — port of ``repro/serving/engine.py``
for the paged KV cache.

Same lifecycle as the JAX engine: ``submit()`` enqueues a
:class:`GenerationRequest`; ``step()`` is plan -> launch -> commit, where
planning (deadline sweep, admission, chunk budgeting, block allocation) is
host-only, launching runs one fused step over the slot batch, and commit
syncs the sampled tokens and applies them to the scheduler.  Every step is
either a pure-decode step (``CausalLM.decode_step``: the paged decode
kernel) or a chunk step in which prefilling rows advance up to
``prefill_chunk`` prompt tokens and decoding rows one token
(``CausalLM.decode_chunk``: the paged prefill kernel); ``prefill_chunk=0``
keeps the stop-the-world whole-prompt scan of decode steps as the parity
baseline.  The radix prefix cache, recompute preemption on pool exhaustion
and cancellation / deadlines behave as in the JAX engine, whose host modules
(scheduler, allocator, prefix cache) are copied unchanged.

The step is split plan -> launch -> commit as in the JAX engine, and the
rest of it comes along: speculative ``plan_spec`` (step N+1 launched on
step N's device tokens), ``plan_stale`` / ``quarantine`` / ``shed_queued``
for the supervisor, the fault hook at the plan, launch and commit seams,
the block-pool sanitizer with KV checksums (``analysis/shadow.py``), the
write-ahead journal, the tracer, the flight recorder and the metrics
registry.

The jitted step impls of the JAX engine are eager methods here, and the
cache is a per-layer list of pools updated in place.  Per-request sampling
streams are ``torch.Generator``s (serving/sampling.py), each advanced at
launch as the JAX engine advances its keys.  Host arrays reach the card
through pinned memory with ``non_blocking`` copies, so a launch never waits
for the device; each launch then copies its sampled tokens into a pinned
host buffer of its own and records a CUDA event after the copy, and the
step's one sync (:meth:`Engine.sync_tokens`) waits on that event alone.
Not ported: the contiguous cache (``paged=False``, ROADMAP Queue A 21b).
"""
from __future__ import annotations

import dataclasses
import zlib
from typing import Dict, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core.bitlinear import convert_linear_params_fp_to_packed
from repro_torch.models import CausalLM, ModelConfig, build_model
from repro_torch.nn.module import torch_dtype
from repro_torch.serving.api import (EngineStats, FinishReason, GenerationRequest,
                                     SamplingParams, StepFailure, StepOutput,
                                     make_request)
from repro_torch.serving.paged import BlockAllocator
from repro_torch.serving.prefix_cache import RadixPrefixCache
from repro_torch.serving.sampling import guard_nonfinite, sample_batch
from repro_torch.serving.scheduler import Scheduler, bucket_length
from repro_torch.serving.telemetry import Clock, Histogram, MetricsRegistry


@dataclasses.dataclass
class ServeConfig:
    max_batch: int = 8               # concurrent decode slots
    max_len: int = 256               # per-slot cache capacity (prompt + gen)
    eos_id: int = 258
    pad_id: int = 256
    temperature: float = 0.0         # default SamplingParams for bare submits
    top_p: float = 1.0
    seed: int = 0                    # base for per-request sampling seeds
    prefill_bucket_min: int = 8      # smallest whole-prompt chunk bucket
    cache_dtype: str = "float32"     # "bfloat16" on the card
    # max prompt tokens a prefilling slot advances per step (chunk widths
    # bucket to powers of two up to this); 0 = whole-prompt sequential scan
    prefill_chunk: int = 32
    # cap on total chunk tokens per step across slots (None = no cap)
    prefill_budget: Optional[int] = None
    kv_block_size: int = 16          # tokens per KV block
    # pool size incl. the reserved trash block; None = full capacity
    num_kv_blocks: Optional[int] = None
    # "fused": the paged CUDA kernels (their plain versions on CPU tensors);
    # "gather": scatter + dense block-table window; "auto": fused on a CUDA
    # model, gather on a CPU one
    attn_impl: str = "auto"
    # radix prefix cache over the paged pool (serving/prefix_cache.py)
    prefix_cache: bool = False
    prefix_cache_blocks: Optional[int] = None
    # block-pool sanitizer (analysis/shadow.py): every block transition and
    # each step's KV write-set checked; O(pool) host work per step
    sanitize: bool = False
    # with sanitize: a crc per written KV block, swept by
    # Engine.check_kv_integrity() (reads the pools back to the host)
    kv_checksums: bool = False
    # write-ahead request journal (serving/journal.py); None = off
    journal_dir: Optional[str] = None

    def __post_init__(self):
        if self.prefill_bucket_min < 1:
            raise ValueError(
                f"prefill_bucket_min={self.prefill_bucket_min} must be >= 1 "
                "(bucket_length would loop forever)")
        if self.prefill_chunk < 0:
            raise ValueError(
                f"prefill_chunk={self.prefill_chunk} must be >= 0 "
                "(0 = whole-prompt chunks)")
        if self.kv_block_size < 1:
            raise ValueError(f"kv_block_size={self.kv_block_size} must be >= 1")
        if self.num_kv_blocks is not None and self.num_kv_blocks < 2:
            raise ValueError(
                f"num_kv_blocks={self.num_kv_blocks}: need the reserved trash "
                "block plus at least one allocatable block")
        if self.attn_impl not in ("auto", "fused", "gather"):
            raise ValueError(
                f"attn_impl={self.attn_impl!r} must be 'auto', 'fused', or "
                "'gather'")
        if self.prefix_cache_blocks is not None and self.prefix_cache_blocks < 1:
            raise ValueError(
                f"prefix_cache_blocks={self.prefix_cache_blocks} must be "
                ">= 1 or None")
        if self.prefill_budget is not None and self.prefill_budget < 1:
            raise ValueError(
                f"prefill_budget={self.prefill_budget} must be >= 1 or None "
                "(a zero budget would stall every prefill forever)")
        if self.kv_checksums and not self.sanitize:
            raise ValueError(
                "kv_checksums=True stores block digests in the sanitizer "
                "shadow pool; it requires ServeConfig(sanitize=True)")

    @property
    def blocks_per_slot(self) -> int:
        """Logical blocks covering one slot's max_len positions."""
        return -(-self.max_len // self.kv_block_size)

    def pool_blocks(self) -> int:
        """Physical pool size (trash block + allocatable blocks)."""
        if self.num_kv_blocks is not None:
            return self.num_kv_blocks
        return 1 + self.max_batch * self.blocks_per_slot


@dataclasses.dataclass
class Request:
    """Legacy request type, kept for the ``generate()`` compatibility path."""
    uid: int
    prompt: List[int]
    max_tokens: int = 32
    output: List[int] = dataclasses.field(default_factory=list)
    done: bool = False


@dataclasses.dataclass
class StepPlan:
    """Host-side plan for one fused step (see the JAX ``StepPlan``):
    terminal ``events`` emitted while planning, the active slots and their
    owners at plan time, the chunk plan, budget-stalled slots, and the
    per-slot write positions."""
    events: List[StepOutput]
    active: List[int]
    owners: Dict[int, int]
    chunks: Dict[int, int]
    stalled: List[int]
    positions: np.ndarray
    spec: bool = False             # speculative: fed the previous step's tokens


@dataclasses.dataclass
class InflightStep:
    """A launched, uncommitted step: its plan, the device tensor of sampled
    tokens (``None`` when no slot was active), when the launch returned, and
    the sanitizer's write-set captured at launch.  On the card ``host`` is
    the pinned buffer the tokens are copied into at launch and ``ready``
    the event recorded after that copy; on the CPU both are ``None``."""
    plan: StepPlan
    tok: Optional[torch.Tensor]
    launched_at: float = 0.0
    write_blocks: Optional[List[int]] = None
    host: Optional[torch.Tensor] = None
    ready: Optional["torch.cuda.Event"] = None


class Engine:
    """Continuous-batching facade: ``submit() / step() / stream()`` plus the
    blocking ``generate()`` wrapper.  ``model`` is a paged-capable
    ``CausalLM`` (attention-only stack); the engine runs on its device."""

    def __init__(self, cfg: ModelConfig, model: CausalLM,
                 scfg: Optional[ServeConfig] = None,
                 clock: Optional[Clock] = None):
        self.clock = clock if clock is not None else Clock()
        self.scfg = scfg if scfg is not None else ServeConfig()
        if any(s.mixer != "attn" for s in cfg.resolved_pattern()):
            raise ValueError(
                f"config {cfg.name!r}: the paged engine serves attention-only "
                "stacks; the contiguous cache is not ported yet (ROADMAP "
                "Queue A 21b)")
        self.paged = True
        self.cfg, self.model = cfg, model
        self.device = model.vocab_mask.device
        impl = self.scfg.attn_impl
        if impl == "auto":
            impl = "fused" if self.device.type == "cuda" else "gather"
        self.attn_impl = impl
        self.allocator = BlockAllocator(self.scfg.pool_blocks(),
                                        self.scfg.kv_block_size)
        self.prefix_cache: Optional[RadixPrefixCache] = None
        if self.scfg.prefix_cache:
            self.prefix_cache = RadixPrefixCache(
                self.allocator, self.scfg.prefix_cache_blocks)
            # alloc() LRU-evicts cached-but-unreferenced prefix blocks
            # before reporting starvation to admission/growth
            self.allocator.reclaim = self.prefix_cache.evict
        self.sched = Scheduler(self.scfg.max_batch, self.scfg.max_len,
                               self.scfg.eos_id, self.scfg.prefill_bucket_min,
                               allocator=self.allocator,
                               prefix_cache=self.prefix_cache,
                               prefill_chunk=self.scfg.prefill_chunk,
                               prefill_budget=self.scfg.prefill_budget)
        # block-pool shadow (analysis/shadow.py): the allocator reports each
        # refcount transition, the scheduler and prefix cache say what each
        # reference means, launch and commit check write-sets and the mirror
        self.shadow = None
        if self.scfg.sanitize:
            from repro_torch.analysis.shadow import ShadowBlockPool
            self.shadow = ShadowBlockPool(self.allocator.num_blocks,
                                          self.allocator.block_size,
                                          checksums=self.scfg.kv_checksums)
            self.allocator.observer = self.shadow
            self.sched.shadow = self.shadow
            if self.prefix_cache is not None:
                self.prefix_cache.shadow = self.shadow
        # write-ahead request journal: accepted submits and committed tokens
        # are durable before they are observable (serving/recovery.py)
        self.journal = None
        if self.scfg.journal_dir:
            from repro_torch.serving.journal import Journal
            self.journal = Journal(self.scfg.journal_dir)
        self._prefill_positions = 0
        self._prefill_skipped = 0
        self._prefill_chunks = 0
        self._uid_counter = 0
        self._requests: Dict[int, GenerationRequest] = {}   # uid -> in flight
        self._submit_ts: Dict[int, float] = {}
        self._ttft_ms = Histogram()
        self._queue_wait_ms = Histogram()
        self._e2e_ms = Histogram()
        # a step launched before the previous sync counts as overlapped,
        # gap 0 by construction
        self._step_gap_ms = Histogram()
        self._last_sync: Optional[float] = None
        self._requests_submitted = 0
        self._steps_committed = 0
        self._steps_overlapped = 0
        self._tokens_generated = 0
        self._cancellations = 0
        self._deadline_expirations = 0
        # robustness counters (bumped here and by the supervisor) and the
        # fault-injection hook (serving/faults.py FaultPlan.engine_hook),
        # called at the plan / launch / commit seams before any mutation
        self.fault_hook = None
        self._step_failures = 0
        self._step_retries = 0
        self._quarantines = 0
        self._engine_restarts = 0
        self._load_sheds = 0
        self._hung_steps = 0
        self._degrade_tier = 0
        self._kv_corruptions = 0
        self._recovery_ms = Histogram()
        # opt-in telemetry sinks: a serving/tracing.Tracer and the
        # supervisor's telemetry.FlightRecorder
        self.tracer = None
        self.recorder = None
        # live decode state, allocated on first admission; idle rows hold
        # pad_id so their (discarded) compute never reads a dead request
        self._cache: Optional[List[Dict[str, torch.Tensor]]] = None
        self._tokens = np.full((self.scfg.max_batch,), self.scfg.pad_id,
                               np.int32)
        self._gens: List[Optional[torch.Generator]] = [None] * self.scfg.max_batch
        # pinned host buffers for the sampled tokens, one per step in flight
        # (at most two: the async loop launches step N+1 before syncing N)
        self._host_tok: List[torch.Tensor] = []
        self._host_next = 0
        self._build_metrics()

    def _build_metrics(self) -> None:
        """(Re)build the metrics registry over the engine's live state (the
        JAX engine's catalog, name for name).  Histograms are registered as
        objects, counters through render-time callbacks; the supervisor
        calls this again after moving the histograms to a restarted
        engine."""
        reg = MetricsRegistry()
        for name, hist, help_ in (
            ("serving_ttft_ms", self._ttft_ms,
             "submit -> first token latency (EngineStats.ttft_ms)"),
            ("serving_queue_wait_ms", self._queue_wait_ms,
             "submit -> admission wait (EngineStats.queue_wait_ms)"),
            ("serving_e2e_latency_ms", self._e2e_ms,
             "submit -> finish latency (EngineStats.e2e_latency_ms)"),
            ("serving_step_gap_ms", self._step_gap_ms,
             "device sync -> next dispatch gap (EngineStats.step_gap_ms)"),
            ("serving_recovery_ms", self._recovery_ms,
             "failure -> healthy commit (EngineStats.recovery_ms)"),
        ):
            reg.register(name, hist, help_)
        for name, kind, fn, help_ in (
            ("serving_requests_submitted_total", "counter",
             lambda: self._requests_submitted,
             "requests accepted by submit_request "
             "(EngineStats.requests_submitted)"),
            ("serving_admissions_total", "counter",
             lambda: self.sched.admissions,
             "requests admitted to slots (EngineStats.admissions)"),
            ("serving_preemptions_total", "counter",
             lambda: self.sched.preemptions,
             "slots preempted for recompute (EngineStats.preemptions)"),
            ("serving_steps_committed_total", "counter",
             lambda: self._steps_committed,
             "fused steps committed (EngineStats.steps_committed)"),
            ("serving_steps_overlapped_total", "counter",
             lambda: self._steps_overlapped,
             "steps launched before the previous sync "
             "(EngineStats.steps_overlapped)"),
            ("serving_tokens_generated_total", "counter",
             lambda: self._tokens_generated,
             "tokens emitted to requests (EngineStats.tokens_generated)"),
            ("serving_prefill_positions_total", "counter",
             lambda: self._prefill_positions,
             "prompt positions run through chunk steps "
             "(EngineStats.prefill_positions)"),
            ("serving_prefill_positions_skipped_total", "counter",
             lambda: self._prefill_skipped,
             "prompt positions covered by shared prefix blocks "
             "(EngineStats.prefill_positions_skipped)"),
            ("serving_prefill_chunks_total", "counter",
             lambda: self._prefill_chunks,
             "prefill chunks advanced (EngineStats.prefill_chunks)"),
            ("serving_cancellations_total", "counter",
             lambda: self._cancellations,
             "client cancellations (EngineStats.cancellations)"),
            ("serving_deadline_expirations_total", "counter",
             lambda: self._deadline_expirations,
             "requests finished by deadline "
             "(EngineStats.deadline_expirations)"),
            ("serving_step_failures_total", "counter",
             lambda: self._step_failures,
             "step failures observed (EngineStats.step_failures)"),
            ("serving_step_retries_total", "counter",
             lambda: self._step_retries,
             "step retries attempted (EngineStats.step_retries)"),
            ("serving_quarantines_total", "counter",
             lambda: self._quarantines,
             "requests quarantined with FinishReason.ERROR "
             "(EngineStats.quarantines)"),
            ("serving_engine_restarts_total", "counter",
             lambda: self._engine_restarts,
             "supervisor snapshot-restores (EngineStats.engine_restarts)"),
            ("serving_load_sheds_total", "counter",
             lambda: self._load_sheds,
             "queued requests shed under pressure "
             "(EngineStats.load_sheds)"),
            ("serving_hung_steps_total", "counter",
             lambda: self._hung_steps,
             "watchdog-flagged slow commits (EngineStats.hung_steps)"),
            ("serving_queue_depth", "gauge",
             lambda: len(self.sched.waiting),
             "requests waiting for a slot (EngineStats.queue_depth)"),
            ("serving_active_slots", "gauge",
             lambda: len(self.sched.active_slots()),
             "slots currently decoding or prefilling"),
            ("serving_degrade_tier", "gauge",
             lambda: self._degrade_tier,
             "graceful-degradation tier (EngineStats.degrade_tier)"),
            ("serving_kv_blocks_free", "gauge",
             lambda: self.allocator.available(),
             "allocatable KV blocks (EngineStats.blocks_free)"),
            ("serving_kv_blocks_in_use", "gauge",
             lambda: self.allocator.blocks_in_use(),
             "referenced KV blocks (EngineStats.blocks_in_use)"),
        ):
            reg.register_callback(name, kind, fn, help_)
        self.metrics = reg

    # -- step cores (the JAX engine's jitted impls) ------------------------------

    def _decode_impl(self, tokens: torch.Tensor, index: torch.Tensor,
                     block_tables: torch.Tensor, draw: Sequence[int]) -> torch.Tensor:
        """One pure-decode step: tokens [B] written at per-row ``index`` [B];
        rows in ``draw`` consume a sample."""
        logits, _ = self.model.decode_step(tokens, self._cache, index,
                                           block_tables, attn_impl=self.attn_impl)
        nxt = sample_batch(logits, self.sched.temperatures, self.sched.top_ps,
                           self._gens, draw)
        return guard_nonfinite(nxt, logits)

    def _chunk_step_impl(self, tokens: torch.Tensor, start: torch.Tensor,
                         lens: torch.Tensor, draw: Sequence[int],
                         block_tables: torch.Tensor) -> torch.Tensor:
        """One fused chunk step over the paged pools: tokens [B, T] hold each
        row's chunk, written at ``start + j`` and attending ``<= start + j``;
        samples from every row's last valid position.  Only rows in ``draw``
        (those that consume the sample) advance their generator, so chunked
        and whole-prompt prefill give the same per-request streams."""
        logits, _ = self.model.decode_chunk(tokens, self._cache, start, lens,
                                            block_tables,
                                            attn_impl=self.attn_impl)
        rows = torch.arange(tokens.shape[0], device=self.device)
        last = logits[rows, lens.long() - 1]
        nxt = sample_batch(last, self.sched.temperatures, self.sched.top_ps,
                           self._gens, draw)
        return guard_nonfinite(nxt, last)

    def _chunk_scan_paged_impl(self, tokens: torch.Tensor, start: torch.Tensor,
                               lens: torch.Tensor, draw: Sequence[int],
                               block_tables: torch.Tensor) -> torch.Tensor:
        """Sequential chunk scan over the paged pools: the ``prefill_chunk=0``
        stop-the-world baseline.  Row ``b`` at scan index ``j`` replays
        position ``start + min(j, lens - 1)`` with its own token once
        ``j >= lens``: the KV projection depends only on (token, position),
        so the rewrite stores identical values, and the row's logits were
        already captured at ``j == lens - 1``."""
        b, slen = tokens.shape
        rows = torch.arange(b, device=self.device)
        last = None
        for j in range(slen):
            jj = torch.clamp(lens - 1, max=j)
            tok = tokens[rows, jj.long()]
            logits, _ = self.model.decode_step(tok, self._cache, start + jj,
                                               block_tables,
                                               attn_impl=self.attn_impl)
            take = (lens - 1 == j)[:, None]
            last = logits if last is None else torch.where(take, logits, last)
        nxt = sample_batch(last, self.sched.temperatures, self.sched.top_ps,
                           self._gens, draw)
        return guard_nonfinite(nxt, last)

    # -- request lifecycle -------------------------------------------------------

    def submit(self, prompt: Sequence[int],
               params: Optional[SamplingParams] = None,
               uid: Optional[int] = None,
               on_token=None,
               deadline_s: Optional[float] = None) -> GenerationRequest:
        """Enqueue a prompt; returns the live GenerationRequest handle.
        ``deadline_s`` (seconds from now) finishes the request with
        ``FinishReason.DEADLINE`` at the first plan boundary past it."""
        if uid is None:
            uid = self._uid_counter
        self._uid_counter = max(self._uid_counter, uid) + 1
        if params is None:
            params = SamplingParams(temperature=self.scfg.temperature,
                                    top_p=self.scfg.top_p)
        deadline = (None if deadline_s is None
                    else self.clock.now() + deadline_s)
        req = make_request(prompt, uid, params, on_token, deadline=deadline)
        return self.submit_request(req)

    def submit_request(self, req: GenerationRequest) -> GenerationRequest:
        if req.uid in self._requests:
            raise ValueError(
                f"uid {req.uid} already belongs to an in-flight request; "
                "reusing it would orphan that request's callback and finish "
                "bookkeeping")
        now = self.clock.now()
        self._requests[req.uid] = req
        self._submit_ts[req.uid] = now
        self._requests_submitted += 1
        if self.tracer is not None:
            # idempotent per uid: supervisor restarts re-submit requests
            self.tracer.request_submit(req.uid, now)
        if self.journal is not None:
            # durable before the caller sees the uid
            self.journal.log_submit(req, now_mono=now)
        self.sched.submit(req)
        return req

    def has_pending(self) -> bool:
        return self.sched.has_work()

    def step(self) -> List[StepOutput]:
        """Admit waiting requests, then run one fused step over the slot
        batch; returns the StepOutputs produced (plan-time terminal events,
        then one token per slot that completed its prompt or decoded)."""
        return self.commit_step(self.launch_step(self.plan_step()))

    # -- plan / launch / commit ---------------------------------------------------

    def plan_step(self) -> StepPlan:
        """Host-only planning: sweep deadlines, admit (sampling streams
        seeded, prefix skips counted, queue wait recorded), plan chunks
        (which may preempt starved slots) and snapshot the active slots."""
        t_plan = self.clock.now()
        if self.fault_hook is not None:
            # before any side effect: a plan fault leaves the scheduler as is
            self.fault_hook("plan", {})
        events = self.expire_deadlines()
        admitted, rejected = self.sched.admit()
        self._finalize_outputs(rejected)
        events.extend(rejected)
        if admitted:
            self._ensure_state()
            now = self.clock.now()
            if self.journal is not None:
                for _, req in admitted:
                    self.journal.log_admit(req.uid)
            for slot, req in admitted:
                self._gens[slot] = self._request_generator(req)
                self._prefill_skipped += int(self.sched.prefix_lens[slot])
                t0 = self._submit_ts.get(req.uid)
                if t0 is not None:
                    self._queue_wait_ms.observe((now - t0) * 1e3)
                if self.tracer is not None:
                    self.tracer.request_admitted(req.uid, now)
        chunks = self.sched.next_chunks()
        active = self.sched.active_slots()
        stalled = [s for s in active
                   if self.sched.pending[s] and s not in chunks]
        owners = {s: self.sched.slots[s].uid for s in active}
        if self.tracer is not None:
            self.tracer.plan_span(t_plan, self.clock.now(),
                                  self._steps_committed, len(active),
                                  len(chunks))
        return StepPlan(events=events, active=active, owners=owners,
                        chunks=chunks, stalled=stalled,
                        positions=self.sched.positions.astype(np.int32,
                                                              copy=True))

    def plan_spec(self, inflight: InflightStep) -> Optional[StepPlan]:
        """Plan step N+1 while step N (``inflight``) is still on the device,
        or return None when only a post-commit plan is safe: the in-flight
        step must be pure decode, every slot must provably survive its
        commit (same owners, no max_tokens or capacity finish, the next
        position's block allocatable), and no admission may be possible.
        An EOS finish is allowed: its speculative row is discarded at commit
        by the owner check."""
        t_plan = self.clock.now()
        plan = inflight.plan
        if inflight.tok is None or plan.chunks or plan.stalled:
            return None
        sc = self.sched
        active = sc.active_slots()
        if not active or active != plan.active:
            return None
        if sc.waiting and any(r is None for r in sc.slots):
            return None                # admission possible: plan it for real
        for slot in active:
            req = sc.slots[slot]
            if req is None or req.uid != plan.owners.get(slot):
                return None
            if req.num_generated + 1 >= req.params.max_tokens:
                return None
            if int(sc.positions[slot]) + 1 > sc.max_len - 1:
                return None
            if not sc.pregrow_decode(slot):
                return None            # pool starved: let commit preempt
        positions = sc.positions.astype(np.int32, copy=True)
        for slot in active:
            positions[slot] += 1       # where step N+1 writes, post-commit-N
        if self.tracer is not None:
            self.tracer.plan_span(t_plan, self.clock.now(),
                                  self._steps_committed, len(active), 0,
                                  spec=True)
        return StepPlan(events=[], active=list(active), owners=dict(plan.owners),
                        chunks={}, stalled=[], positions=positions, spec=True)

    def launch_step(self, plan: StepPlan,
                    feed: Optional[InflightStep] = None) -> InflightStep:
        """Run the planned step without waiting for the device.  A
        speculative plan feeds ``feed.tok``, the previous step's tokens on
        the device, instead of the host copy ``self._tokens``."""
        t_launch = self.clock.now()
        if not plan.active:
            return InflightStep(plan=plan, tok=None, launched_at=t_launch)
        if self.fault_hook is not None:
            # before dispatch: the same plan relaunches verbatim
            self.fault_hook("launch", {"plan": plan})
        self._ensure_state()
        write_blocks = None
        if self.shadow is not None:
            write_blocks = self._sanitize_writes(plan)
        with torch.no_grad():
            if plan.chunks or plan.stalled:
                tok = self._launch_chunk(plan)
            else:
                tok = self._launch_decode(plan, feed)
        host, ready = self._stage_tokens(tok)
        launched_at = self.clock.now()
        if self.tracer is not None:
            self.tracer.launch_span(t_launch, launched_at,
                                    self._steps_committed, plan.spec)
        return InflightStep(plan=plan, tok=tok, launched_at=launched_at,
                            write_blocks=write_blocks, host=host, ready=ready)

    def _stage_tokens(self, tok: torch.Tensor):
        """On the card: copy the sampled tokens into the next pinned host
        buffer (``non_blocking``) and record an event after the copy, so
        the sync waits for this step alone and not for whatever is queued
        behind it.  Two buffers suffice: a buffer is reused two launches
        later, and the loop syncs a step before launching the one after its
        successor."""
        if tok.device.type != "cuda":
            return None, None
        if not self._host_tok:
            self._host_tok = [torch.empty(tok.shape, dtype=tok.dtype,
                                          pin_memory=True) for _ in range(2)]
        host = self._host_tok[self._host_next]
        self._host_next ^= 1
        host.copy_(tok, non_blocking=True)
        ready = torch.cuda.Event()
        ready.record()
        return host, ready

    @staticmethod
    def sync_tokens(inflight: InflightStep) -> np.ndarray:
        """The step's one device sync: wait on the event recorded after the
        step's token copy (``Event.synchronize`` releases the GIL) and read
        the pinned buffer.  On the CPU the tokens are host memory already.
        The async loop runs this on an executor thread."""
        if inflight.ready is not None:
            inflight.ready.synchronize()
            return inflight.host.numpy().copy()
        return inflight.tok.numpy().copy()

    def commit_step(self, inflight: InflightStep,
                    tok_np: Optional[np.ndarray] = None) -> List[StepOutput]:
        """Sync the step's tokens (unless the caller passes ``tok_np``,
        synced off-thread) and apply them: ``advance_prefill`` for chunked
        slots, ``record`` for every slot that produced a token.  Rows whose
        slot changed owner since the plan are discarded; budget-stalled rows
        are skipped."""
        plan = inflight.plan
        sc = self.sched
        outs: List[StepOutput] = []
        if inflight.tok is not None:
            if tok_np is None:
                tok_np = self.sync_tokens(inflight)
            if self.fault_hook is not None:
                # after the sync, before validation or any mutation; may
                # raise or replace token rows (read back from ctx)
                ctx = {"plan": plan, "tok": tok_np}
                self.fault_hook("commit", ctx)
                tok_np = ctx["tok"]
            self._validate_tokens(plan, tok_np)
            now = self.clock.now()
            step_id = self._steps_committed
            self._steps_committed += 1
            if self._last_sync is not None:
                gap = inflight.launched_at - self._last_sync
                if gap <= 0.0:
                    self._steps_overlapped += 1
                self._step_gap_ms.observe(max(0.0, gap) * 1e3)
            self._last_sync = now
            for slot in plan.active:
                req = sc.slots[slot]
                if req is None or req.uid != plan.owners.get(slot):
                    continue           # slot freed mid-flight: discard token
                n = plan.chunks.get(slot)
                if n is not None:
                    if not sc.advance_prefill(slot, n):
                        continue       # still prefilling: no token this step
                elif slot in plan.stalled:
                    continue           # budget-stalled: emit-less pad row
                self._tokens[slot] = int(tok_np[slot])
                outs.append(sc.record(slot, int(tok_np[slot])))
            self._prefill_positions += sum(plan.chunks.values())
            self._prefill_chunks += len(plan.chunks)
            if (self.shadow is not None and self.shadow.checksums_enabled
                    and inflight.write_blocks):
                # digest every block this step wrote (blocks freed by this
                # commit are skipped inside note_checksum)
                for b, d in self._kv_block_digests(
                        inflight.write_blocks).items():
                    self.shadow.note_checksum(b, d)
            if self.tracer is not None:
                self.tracer.device_span(inflight.launched_at, now, step_id,
                                        plan.spec)
                for slot, n in plan.chunks.items():
                    self.tracer.prefill_chunk(plan.owners.get(slot, -1),
                                              inflight.launched_at, now, n)
                self.tracer.commit_span(now, self.clock.now(), step_id,
                                        len(outs), len(plan.chunks))
            if self.recorder is not None:
                self.recorder.record("commit", step=step_id,
                                     active=len(plan.active),
                                     chunks=len(plan.chunks),
                                     outputs=len(outs), spec=plan.spec)
        # a slot freed this step decodes the pad token while idle
        for slot, req in enumerate(sc.slots):
            if req is None:
                self._tokens[slot] = self.scfg.pad_id
        if self.shadow is not None:
            self.shadow.verify(self.allocator)
            if not sc.has_work():
                self.shadow.assert_drained()
        self._finalize_outputs(outs)
        return plan.events + outs

    def _validate_tokens(self, plan: StepPlan, tok_np: np.ndarray) -> None:
        """Reject a step whose consumable rows carry out-of-range tokens
        (``NONFINITE_TOKEN`` from non-finite logits) before any mutation."""
        sc = self.sched
        bad_slots: List[int] = []
        bad_uids: List[int] = []
        for slot in plan.active:
            req = sc.slots[slot]
            if req is None or req.uid != plan.owners.get(slot):
                continue
            if slot in plan.stalled:
                continue
            n = plan.chunks.get(slot)
            if n is not None and n < len(sc.pending[slot]):
                continue               # mid-prompt chunk: sample discarded
            t = int(tok_np[slot])
            if t < 0 or t >= self.cfg.padded_vocab:
                bad_slots.append(slot)
                bad_uids.append(req.uid)
        if bad_slots:
            raise StepFailure(
                f"step produced non-finite/out-of-range tokens for slots "
                f"{bad_slots} (uids {bad_uids}); plan is safe to relaunch",
                uids=bad_uids, slots=bad_slots)

    def plan_stale(self, plan: StepPlan) -> bool:
        """True when ``plan`` no longer matches the scheduler: a request it
        covers was cancelled, expired or preempted since (its slot changed
        owner, or its pending prompt is shorter than the planned chunk).  A
        failed step's plan relaunches verbatim only while fresh."""
        sc = self.sched
        for slot in plan.active:
            req = sc.slots[slot]
            if req is None or req.uid != plan.owners.get(slot):
                return True
            n = plan.chunks.get(slot)
            if n is not None and n > len(sc.pending[slot]):
                return True
        return False

    def quarantine(self, uid: int) -> Optional[StepOutput]:
        """Finish a repeatedly failing request with ``FinishReason.ERROR``,
        keeping its tokens; the slot and blocks free as on a cancel."""
        return self.cancel(uid, FinishReason.ERROR)

    def shed_queued(self, keep: int) -> List[StepOutput]:
        """Load shedding: drop waiting (not admitted) requests from the back
        of the queue until ``keep`` remain, each finished with an
        ``ABORTED`` marker.  Returns the finalized marker events."""
        outs: List[StepOutput] = []
        sc = self.sched
        while len(sc.waiting) > max(0, keep):
            req = sc.waiting.pop()
            sc._arrival.pop(req.uid, None)
            req.finish_reason = FinishReason.ABORTED
            outs.append(StepOutput(uid=req.uid, token=-1,
                                   index=req.num_generated, finished=True,
                                   finish_reason=FinishReason.ABORTED))
            self._load_sheds += 1
        if outs and self.recorder is not None:
            self.recorder.record("load_shed", count=len(outs),
                                 kept=max(0, keep))
        self._finalize_outputs(outs)
        return outs

    def _sanitize_writes(self, plan: StepPlan) -> List[int]:
        """Check the step's KV write-set against the shadow pool before
        launch (host block tables only): a chunked slot writes ``[start,
        start + n)``, a decode or stalled row ``start``; each block must be
        the trash block or owned by the slot alone.  Returns the physical
        write-set without trash, for the ``kv_checksums`` commit."""
        sc = self.sched
        bs = self.allocator.block_size
        width = sc.block_tables.shape[1]
        written: List[int] = []
        for slot in plan.active:
            start = int(plan.positions[slot])
            n = plan.chunks.get(slot, 1)
            first = min(start // bs, width - 1)
            last = min((start + n - 1) // bs, width - 1)
            for lb in range(first, last + 1):
                b = int(sc.block_tables[slot, lb])
                self.shadow.check_write(slot, b)
                if b != 0 and b not in written:       # 0 == TRASH_BLOCK
                    written.append(b)
        return written

    def _to_device(self, arr: np.ndarray) -> torch.Tensor:
        """A host array on the engine's device.  On the card it goes through
        pinned memory with a ``non_blocking`` copy: a plain ``.to()`` of
        pageable memory waits for the stream, which would hold every launch
        until the device caught up."""
        t = torch.from_numpy(np.array(arr, copy=True))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    def _table(self, depth: int) -> torch.Tensor:
        """Block tables cut to the blocks covering ``depth`` positions
        (power-of-two widths, like the JAX engine's retrace buckets)."""
        sc = self.sched
        width = bucket_length(self.allocator.blocks_for(depth), 1,
                              sc.block_tables.shape[1])
        return self._to_device(sc.block_tables[:, :width])

    def _launch_decode(self, plan: StepPlan,
                       feed: Optional[InflightStep] = None) -> torch.Tensor:
        """Pure-decode dispatch: one token per active slot.  A speculative
        plan takes ``feed.tok`` as it lies on the device (clamped at 0 so a
        non-finite sentinel in a row the commit will reject cannot index the
        embedding out of range)."""
        positions = plan.positions
        bt = self._table(int(positions[plan.active].max()) + 1)
        if plan.spec and feed is not None:
            toks = torch.clamp(feed.tok, min=0)
        else:
            toks = self._to_device(self._tokens)
        index = self._to_device(positions)
        return self._decode_impl(toks, index, bt, plan.active)

    def _launch_chunk(self, plan: StepPlan) -> torch.Tensor:
        """Fused chunk-step dispatch: prefilling slots advance their planned
        chunk, decoding slots their one token.  Budget-stalled slots ride
        along as emit-less length-1 pad rows (their stale KV write is
        rewritten identically by the real chunk before anything attends
        it)."""
        sc, scfg = self.sched, self.scfg
        chunks = plan.chunks
        max_l = max(chunks.values()) if chunks else 1
        if scfg.prefill_chunk > 0:
            t = bucket_length(max_l, 1, scfg.prefill_chunk)
        else:
            t = bucket_length(max_l, scfg.prefill_bucket_min, scfg.max_len)
        toks = np.full((scfg.max_batch, t), scfg.pad_id, np.int32)
        start = plan.positions.copy()
        lens = np.ones((scfg.max_batch,), np.int32)
        draw: List[int] = []
        for slot in plan.active:
            n = chunks.get(slot)
            if n is not None:
                toks[slot, :n] = sc.pending[slot][:n]
                lens[slot] = n
                if n == len(sc.pending[slot]):      # prompt exhausted
                    draw.append(slot)
            elif slot in plan.stalled:
                pass                   # emit-less pad row
            else:
                toks[slot, 0] = self._tokens[slot]
                draw.append(slot)
        depth = max(int(start[s]) + int(lens[s]) for s in plan.active)
        bt = self._table(depth)
        args = (self._to_device(toks), self._to_device(start),
                self._to_device(lens), draw, bt)
        if scfg.prefill_chunk > 0:
            return self._chunk_step_impl(*args)
        return self._chunk_scan_paged_impl(*args)

    # -- device-memory integrity (ServeConfig.kv_checksums) --------------------

    def _pool_leaves(self) -> List[torch.Tensor]:
        """Every layer's K and V pool [num_blocks, Hkv, bs, Dh], layers in
        order, K before V: the fixed order of the block digests."""
        self._ensure_state()
        return [layer[k] for layer in self._cache for k in sorted(layer)]

    def _kv_block_digests(self, blocks: Sequence[int]) -> Dict[int, int]:
        """crc32 per requested pool block over every pool's rows of that
        block, in :meth:`_pool_leaves` order.  The blocks are gathered on
        the device and read back as bytes (bf16 has no numpy dtype): the
        ``kv_checksums`` debug cost."""
        leaves = self._pool_leaves()
        idx = torch.tensor([int(b) for b in blocks], dtype=torch.long)
        host = [leaf.index_select(0, idx.to(leaf.device)).contiguous()
                .view(torch.uint8).cpu().numpy() for leaf in leaves]
        out: Dict[int, int] = {}
        for i, b in enumerate(blocks):
            crc = 0
            for h in host:
                crc = zlib.crc32(h[i].tobytes(), crc)
            out[int(b)] = crc
        return out

    def check_kv_integrity(self) -> List[int]:
        """Recompute the digest of every resident checksummed block and
        compare it with the one the shadow recorded at write time.  Returns
        the corrupt block ids (empty without ``kv_checksums``); pass them
        to :meth:`recover_corrupt_blocks`."""
        if self.shadow is None or not self.shadow.checksums_enabled:
            return []
        blocks = self.shadow.checksummed()
        if not blocks:
            return []
        bad = self.shadow.verify_checksums(self._kv_block_digests(blocks))
        if bad:
            self._kv_corruptions += len(bad)
            if self.recorder is not None:
                self.recorder.record("kv_corruption", blocks=len(bad))
        return bad

    def recover_corrupt_blocks(self, blocks: Sequence[int]) -> List[int]:
        """Preempt every slot whose block table references a corrupt block
        (owner or shared reader): recompute rebuilds its KV identically, so
        greedy outputs keep parity.  Drops the prefix cache if a corrupt
        block stays published.  Returns the preempted uids."""
        bad = {int(b) for b in blocks}
        if not bad:
            return []
        sc = self.sched
        uids: List[int] = []
        for slot in list(sc.active_slots()):
            table = sc.block_tables[slot]
            if any(int(table[i]) in bad for i in range(table.shape[0])):
                req = sc.slots[slot]
                uids.append(req.uid)
                sc._preempt(slot)
        if self.prefix_cache is not None and \
                any(int(self.allocator.refcounts[b]) > 0 for b in bad):
            # only trie holds can still reference a corrupt block now, and
            # the trie has no per-block removal
            self.prefix_cache.clear()
        if self.recorder is not None:
            self.recorder.record("kv_corruption_recovered",
                                 blocks=len(bad), preempted=len(uids))
        return uids

    def corrupt_kv_block(self, block: int, seed: int = 0,
                         mode: str = "garbage") -> None:
        """Fault injection (faults.py ``device_mem`` site): overwrite one
        pool block in place behind the allocator in every layer's K and V,
        with seeded garbage (``mode='garbage'``) or one flipped bit
        (``mode='bitflip'``)."""
        rng = np.random.default_rng(seed)
        with torch.no_grad():
            for leaf in self._pool_leaves():
                rows = leaf[block]
                if mode == "bitflip":
                    flat = rows.view(torch.uint8).reshape(-1)
                    i = int(rng.integers(flat.numel()))
                    flat[i:i + 1].bitwise_xor_(1 << int(rng.integers(8)))
                else:
                    new = rng.standard_normal(tuple(rows.shape))
                    rows.copy_(torch.from_numpy(new).to(rows.dtype))

    # -- cancellation / deadlines ---------------------------------------------------

    def cancel(self, uid: int,
               reason: FinishReason = FinishReason.CANCELLED
               ) -> Optional[StepOutput]:
        """End a request from the outside (queued, mid-prefill or mid-decode):
        the slot frees now, its blocks release, and the terminal marker
        StepOutput (token == -1) is emitted and returned; None if the uid is
        not in flight."""
        req = self._requests.get(uid)
        if req is None or req.done:
            return None
        out = self.sched.cancel(uid, reason)
        if out is None:
            self._requests.pop(uid, None)
            self._submit_ts.pop(uid, None)
            return None
        if reason == FinishReason.DEADLINE:
            self._deadline_expirations += 1
        elif reason == FinishReason.ERROR:
            self._quarantines += 1
        else:
            self._cancellations += 1
        if self.recorder is not None:
            self.recorder.record("cancel", uid=uid, reason=reason.name)
        self._finalize_outputs([out])
        return out

    def expire_deadlines(self) -> List[StepOutput]:
        """Finish every in-flight request past its deadline."""
        now = self.clock.now()
        expired = [req.uid for req in self._requests.values()
                   if req.deadline is not None and now >= req.deadline]
        outs = []
        for uid in expired:
            out = self.cancel(uid, FinishReason.DEADLINE)
            if out is not None:
                outs.append(out)
        return outs

    def _finalize_outputs(self, outs: List[StepOutput]) -> None:
        """Latency samples, token counter, the per-request callback and
        in-flight map cleanup."""
        if not outs:
            return
        if self.journal is not None:
            # write-ahead: durable before any callback delivers it
            batch: Dict[int, List[int]] = {}
            for out in outs:
                if out.token >= 0:
                    batch.setdefault(out.uid, []).append(out.token)
            self.journal.log_tokens(batch)
            for out in outs:
                if out.finished:
                    req = self._requests.get(out.uid)
                    n = req.num_generated if req is not None else 0
                    self.journal.log_terminal(out.uid, out.finish_reason, n)
            self.journal.commit()
        now = self.clock.now()
        for out in outs:
            if out.token >= 0:
                self._tokens_generated += 1
                if out.index == 0:
                    t0 = self._submit_ts.get(out.uid)
                    if t0 is not None:
                        self._ttft_ms.observe((now - t0) * 1e3)
                    if self.tracer is not None:
                        self.tracer.request_first_token(out.uid, now)
            req = self._requests.get(out.uid)
            if req is not None and req.on_token is not None:
                req.on_token(out)
            if out.finished:
                t0 = self._submit_ts.pop(out.uid, None)
                if t0 is not None:
                    self._e2e_ms.observe((now - t0) * 1e3)
                if self.tracer is not None:
                    # every terminal path funnels through here
                    reason = (out.finish_reason.name.lower()
                              if out.finish_reason is not None else "stop")
                    tokens = req.num_generated if req is not None else 0
                    self.tracer.request_finish(out.uid, now, reason, tokens)
                self._requests.pop(out.uid, None)

    def stream(self) -> Iterator[StepOutput]:
        """Drive steps until all submitted work finishes, yielding tokens in
        generation order (interleaved across requests)."""
        while self.sched.has_work():
            for out in self.step():
                yield out

    def generate(self, requests: Sequence[Union[Request, GenerationRequest]]
                 ) -> Dict[int, List[int]]:
        """Blocking run-to-completion over a request list.  Legacy
        :class:`Request`s have no finish reason to carry an admission
        rejection, so an oversized prompt raises here."""
        legacy: Dict[int, Request] = {}
        handles: Dict[int, GenerationRequest] = {}

        def rejected(prompt):
            if not prompt or len(prompt) + 1 > self.scfg.max_len:
                return True
            return (self.allocator.blocks_for(len(prompt) + 1)
                    > self.allocator.allocatable)

        bad = [r.uid for r in requests
               if not isinstance(r, GenerationRequest) and rejected(r.prompt)]
        if bad:
            raise ValueError(
                f"prompts of requests {bad} are empty or exceed the per-slot "
                f"cache capacity (ServeConfig.max_len={self.scfg.max_len}, "
                "which counts prompt + generated tokens) or the paged KV "
                "pool (ServeConfig.num_kv_blocks)")
        for r in requests:
            if isinstance(r, GenerationRequest):
                self.submit_request(r)
                handles[r.uid] = r
            else:
                params = SamplingParams(max_tokens=r.max_tokens,
                                        temperature=self.scfg.temperature,
                                        top_p=self.scfg.top_p)
                handles[r.uid] = self.submit(r.prompt, params, uid=r.uid)
                legacy[r.uid] = r
        for _ in self.stream():
            pass
        results = {uid: list(h.output_tokens) for uid, h in handles.items()}
        for uid, r in legacy.items():
            r.output = results[uid]
            r.done = handles[uid].done
        return results

    # -- internals ------------------------------------------------------------------

    def _ensure_state(self) -> None:
        if self._cache is None:
            # the block pool is an init_cache with batch = num_blocks and
            # per-"row" length block_size: [N, Hkv, bs, Dh] per layer
            self._cache = self.model.init_cache(
                self.scfg.pool_blocks(), self.scfg.kv_block_size,
                torch_dtype(self.scfg.cache_dtype), self.device)

    def stats(self) -> EngineStats:
        """Snapshot of the engine's counters, latency percentiles (``None``
        until a series has a sample), block occupancy, and the prefix cache,
        sanitizer, robustness and journal fields, as the JAX engine's."""
        alloc = self.allocator

        def pct(h: Histogram) -> Optional[Dict[str, float]]:
            return h.percentiles() if h.count else None

        return EngineStats(
            requests_submitted=self._requests_submitted,
            admissions=self.sched.admissions,
            preemptions=self.sched.preemptions,
            prefill_positions=self._prefill_positions,
            prefill_positions_skipped=self._prefill_skipped,
            prefill_chunks=self._prefill_chunks,
            tokens_generated=self._tokens_generated,
            queue_depth=len(self.sched.waiting),
            cancellations=self._cancellations,
            deadline_expirations=self._deadline_expirations,
            steps_committed=self._steps_committed,
            steps_overlapped=self._steps_overlapped,
            ttft_ms=pct(self._ttft_ms),
            queue_wait_ms=pct(self._queue_wait_ms),
            e2e_latency_ms=pct(self._e2e_ms),
            step_gap_ms=pct(self._step_gap_ms),
            blocks_in_use=alloc.blocks_in_use(),
            blocks_free=alloc.available(),
            prefix_cache=(None if self.prefix_cache is None
                          else self.prefix_cache.stats()),
            sanitizer=(None if self.shadow is None
                       else self.shadow.stats()),
            step_failures=self._step_failures,
            step_retries=self._step_retries,
            quarantines=self._quarantines,
            engine_restarts=self._engine_restarts,
            load_sheds=self._load_sheds,
            hung_steps=self._hung_steps,
            degrade_tier=self._degrade_tier,
            recovery_ms=pct(self._recovery_ms),
            kv_corruptions=self._kv_corruptions,
            journal_records=(None if self.journal is None
                             else self.journal.appended),
            journal_commits=(None if self.journal is None
                             else self.journal.commits),
            journal_replays=(None if self.journal is None
                             else self.journal.state.recoveries))

    def kv_cache_bytes(self) -> int:
        """Resident bytes of the paged KV pools."""
        return sum(leaf.numel() * leaf.element_size()
                   for leaf in self._pool_leaves())

    def _request_generator(self, req: GenerationRequest) -> torch.Generator:
        """The row's sampling stream, seeded as the JAX engine seeds its key
        (``repro/serving/engine.py`` ``_request_key``)."""
        seed = req.params.seed
        if seed is None:
            seed = (self.scfg.seed + 0x9E3779B9 * (req.uid + 1)) & 0x7FFFFFFF
        return torch.Generator(device=self.device).manual_seed(seed)


# -- packed-weight conversion ------------------------------------------------------

def convert_to_packed(cfg: ModelConfig, qat_model: CausalLM
                      ) -> Tuple[ModelConfig, CausalLM]:
    """QAT student -> packed ternary serving model on the same device.

    Every quantized BitLinear weight ``w`` [K, N] becomes ``w_packed`` uint8
    [K/4, N] plus a per-layer scalar ``delta``; every other tensor is copied.
    Each layer is converted on its own (the JAX ``convert_to_packed`` walks
    the repeat-stacked leaves, see ROADMAP Queue C)."""
    packed_cfg = cfg.replace(quant=dataclasses.replace(cfg.quant, mode="packed"))
    dev = qat_model.vocab_mask.device
    model = build_model(packed_cfg, device=dev)
    src = qat_model.state_dict()
    with torch.no_grad():
        for key, t in model.state_dict().items():
            if key.endswith(".w_packed") or key.endswith(".delta"):
                w = src[key.rsplit(".", 1)[0] + ".w"]
                t.copy_(convert_linear_params_fp_to_packed(w)[key.rsplit(".", 1)[1]])
            else:
                t.copy_(src[key])
    return packed_cfg, model
