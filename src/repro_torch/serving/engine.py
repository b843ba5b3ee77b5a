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

The jitted step impls of the JAX engine are eager methods here, and the
cache is a per-layer list of pools updated in place.  Per-request sampling
streams are ``torch.Generator``s (serving/sampling.py).  Not ported in this
slice: the contiguous cache (``paged=False``), speculative ``plan_spec``,
the sanitizer and KV checksums, the journal, tracer / flight recorder /
fault hook, the metrics registry, ``shed_queued`` and ``quarantine``.
"""
from __future__ import annotations

import dataclasses
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
from repro_torch.serving.telemetry import Clock, Histogram


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


@dataclasses.dataclass
class InflightStep:
    """A launched, uncommitted step: its plan, the device tensor of sampled
    tokens (``None`` when no slot was active) and when the launch returned."""
    plan: StepPlan
    tok: Optional[torch.Tensor]
    launched_at: float = 0.0


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
                "stacks; the contiguous cache is not ported yet")
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
        self._prefill_positions = 0
        self._prefill_skipped = 0
        self._prefill_chunks = 0
        self._uid_counter = 0
        self._requests: Dict[int, GenerationRequest] = {}   # uid -> in flight
        self._submit_ts: Dict[int, float] = {}
        self._ttft_ms = Histogram()
        self._queue_wait_ms = Histogram()
        self._e2e_ms = Histogram()
        self._step_gap_ms = Histogram()
        self._last_sync: Optional[float] = None
        self._requests_submitted = 0
        self._steps_committed = 0
        self._tokens_generated = 0
        self._cancellations = 0
        self._deadline_expirations = 0
        # live decode state, allocated on first admission; idle rows hold
        # pad_id so their (discarded) compute never reads a dead request
        self._cache: Optional[List[Dict[str, torch.Tensor]]] = None
        self._tokens = np.full((self.scfg.max_batch,), self.scfg.pad_id,
                               np.int32)
        self._gens: List[Optional[torch.Generator]] = [None] * self.scfg.max_batch

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
        self._requests[req.uid] = req
        self._submit_ts[req.uid] = self.clock.now()
        self._requests_submitted += 1
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
        events = self.expire_deadlines()
        admitted, rejected = self.sched.admit()
        self._finalize_outputs(rejected)
        events.extend(rejected)
        if admitted:
            self._ensure_state()
            now = self.clock.now()
            for slot, req in admitted:
                self._gens[slot] = self._request_generator(req)
                self._prefill_skipped += int(self.sched.prefix_lens[slot])
                t0 = self._submit_ts.get(req.uid)
                if t0 is not None:
                    self._queue_wait_ms.observe((now - t0) * 1e3)
        chunks = self.sched.next_chunks()
        active = self.sched.active_slots()
        stalled = [s for s in active
                   if self.sched.pending[s] and s not in chunks]
        owners = {s: self.sched.slots[s].uid for s in active}
        return StepPlan(events=events, active=active, owners=owners,
                        chunks=chunks, stalled=stalled,
                        positions=self.sched.positions.astype(np.int32,
                                                              copy=True))

    def launch_step(self, plan: StepPlan) -> InflightStep:
        """Run the planned step without syncing its sampled tokens."""
        if not plan.active:
            return InflightStep(plan=plan, tok=None,
                                launched_at=self.clock.now())
        self._ensure_state()
        with torch.no_grad():
            if plan.chunks or plan.stalled:
                tok = self._launch_chunk(plan)
            else:
                tok = self._launch_decode(plan)
        return InflightStep(plan=plan, tok=tok, launched_at=self.clock.now())

    def commit_step(self, inflight: InflightStep) -> List[StepOutput]:
        """Sync the step's tokens (the step's one device sync) and apply
        them: ``advance_prefill`` for chunked slots, ``record`` for every slot
        that produced a token.  Rows whose slot changed owner since the plan
        are discarded; budget-stalled rows are skipped."""
        plan = inflight.plan
        sc = self.sched
        outs: List[StepOutput] = []
        if inflight.tok is not None:
            tok_np = inflight.tok.cpu().numpy()
            self._validate_tokens(plan, tok_np)
            now = self.clock.now()
            self._steps_committed += 1
            if self._last_sync is not None:
                gap = inflight.launched_at - self._last_sync
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
        # a slot freed this step decodes the pad token while idle
        for slot, req in enumerate(sc.slots):
            if req is None:
                self._tokens[slot] = self.scfg.pad_id
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

    def _table(self, depth: int) -> torch.Tensor:
        """Block tables cut to the blocks covering ``depth`` positions
        (power-of-two widths, like the JAX engine's retrace buckets)."""
        sc = self.sched
        width = bucket_length(self.allocator.blocks_for(depth), 1,
                              sc.block_tables.shape[1])
        bt = torch.from_numpy(np.ascontiguousarray(sc.block_tables[:, :width]))
        return bt.to(self.device)

    def _launch_decode(self, plan: StepPlan) -> torch.Tensor:
        """Pure-decode dispatch: one token per active slot."""
        positions = plan.positions
        bt = self._table(int(positions[plan.active].max()) + 1)
        toks = torch.from_numpy(self._tokens.copy()).to(self.device)
        index = torch.from_numpy(positions.copy()).to(self.device)
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
        dev = self.device
        args = (torch.from_numpy(toks).to(dev), torch.from_numpy(start).to(dev),
                torch.from_numpy(lens).to(dev), draw, bt)
        if scfg.prefill_chunk > 0:
            return self._chunk_step_impl(*args)
        return self._chunk_scan_paged_impl(*args)

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
        else:
            self._cancellations += 1
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
        now = self.clock.now()
        for out in outs:
            if out.token >= 0:
                self._tokens_generated += 1
                if out.index == 0:
                    t0 = self._submit_ts.get(out.uid)
                    if t0 is not None:
                        self._ttft_ms.observe((now - t0) * 1e3)
            req = self._requests.get(out.uid)
            if req is not None and req.on_token is not None:
                req.on_token(out)
            if out.finished:
                t0 = self._submit_ts.pop(out.uid, None)
                if t0 is not None:
                    self._e2e_ms.observe((now - t0) * 1e3)
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
        """Snapshot of the counters this engine keeps (the robustness and
        durability fields of :class:`EngineStats` stay at their defaults)."""
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
            ttft_ms=pct(self._ttft_ms),
            queue_wait_ms=pct(self._queue_wait_ms),
            e2e_latency_ms=pct(self._e2e_ms),
            step_gap_ms=pct(self._step_gap_ms),
            blocks_in_use=alloc.blocks_in_use(),
            blocks_free=alloc.available(),
            prefix_cache=(None if self.prefix_cache is None
                          else self.prefix_cache.stats()))

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
