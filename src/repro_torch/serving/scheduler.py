"""Slot-based continuous-batching scheduler (host-side bookkeeping).

The decode batch is a fixed array of ``n_slots`` rows.  Each slot
independently tracks which request occupies it and the row's cache position,
so rows at different sequence depths coexist in a single jitted step — the
engine passes a per-row int32 index vector down to the attention cache
update (nn/attention.py:Attention.decode / decode_chunk).

**Chunked, interleaved prefill** (Sarathi-style piggybacking): admission no
longer prefills.  ``admit()`` only assigns a slot (and blocks) and parks the
not-yet-prefilled tokens in ``pending[slot]``; every engine step then calls
``next_chunks()`` to plan up to ``prefill_chunk`` prompt tokens per
prefilling slot, runs one fused step that advances those chunks *and* one
decode token for every decoding slot, and reports progress back through
``advance_prefill()``.  ``positions[slot]`` is the row's next cache write:
the resident-token count while prefilling, ``prompt_len + generated - 1``
once decoding.  ``prefill_remaining()`` exposes the per-slot backlog.
``prefill_chunk == 0`` plans the whole remaining prompt as one chunk — the
stop-the-world admission-prefill semantics, kept as the parity reference.
``prefill_budget`` caps the **total** chunk tokens per step across slots
(not just per slot): a burst of long prompts stalls past the budget instead
of fattening the fused step and starving decode latency.

Requests can also end from the outside: ``cancel(uid)`` removes a queued
request or frees a live slot (mid-prefill included) with
``FinishReason.CANCELLED`` / ``DEADLINE``, releasing its blocks through the
same ``_free`` path as a finish — prefix-cache-published progress stays
resident.

Cache layouts (engine-selected):

* **contiguous** — one preallocated cache region of per-slot capacity
  ``max_len``; the slot index is the cache row.
* **paged** — the scheduler additionally owns a :class:`~repro.serving.paged.
  BlockAllocator` and a per-slot int32 block table.  Admission allocates
  enough blocks to cover the *first chunk* (plus the next decode write when
  that chunk completes the prompt) and *waits on blocks as well as slots*
  (strict FIFO: a blocked queue head is not overtaken); ``next_chunks`` grows
  the allocation chunk-by-chunk and ``record`` one block at a time as decode
  advances; finishing frees the blocks.  If the pool is exhausted mid-flight
  — growing a decode row *or* a half-prefilled chunk — the slot is
  **preempted**: its blocks are freed and the request returns to the front of
  the queue, to be re-admitted later by re-prefilling prompt +
  generated-so-far (vLLM-style recompute preemption — greedy decoding resumes
  token-for-token; stochastic requests restart their PRNG stream).

Prefix sharing (paged + :class:`~repro.serving.prefix_cache.
RadixPrefixCache`): admission is match-then-allocate — the trie is walked
with the request's tokens, matched blocks are pinned with ``share()`` and
mapped into the head of the slot's block table, and only the remainder is
freshly allocated; ``prefix_lens[slot]`` records where prefill resumes.
Because chunk writes always land in owned blocks, the match is capped at the
last block boundary *strictly below* the final token — a block-aligned full
match re-runs its last block instead of remapping a discarded write to the
trash block.  Publication is **as-blocks-fill**: every ``advance_prefill``
(and every exit path — finish *and* preemption) publishes the request's
fully written blocks into the trie, so identical prompts admitted while a
long prompt is still mid-prefill share everything filled so far, and a
preempted half-prefilled slot resumes by re-matching its own published
blocks.  ``_free`` thus *releases* blocks rather than destroying them: the
allocator drops the request's references and anything the trie also holds
stays resident, cached-but-unreferenced, until LRU eviction reclaims it.

Lifecycle per engine step:
  1. ``admit()`` moves FIFO-waiting requests into free slots. Prompts that
     cannot fit (len(prompt) + 1 > max_len, or more blocks than the whole
     pool) finish immediately as ABORTED.
  2. ``next_chunks()`` plans this step's chunk per prefilling slot (growing
     or preempting as the pool allows).
  3. the engine runs one fused chunk+decode step; for every chunked slot it
     calls ``advance_prefill(slot, n)``, and for every slot that produced a
     token (decoding slots, and prefilling slots whose chunk exhausted the
     prompt — their first sampled token) it calls ``record(slot, token)``,
     which appends the token, applies the request's stop conditions (EOS
     unless ignore_eos, max_tokens counted as generated tokens, per-slot
     cache capacity) and frees the slot when the request finishes — the next
     ``admit()`` immediately refills it.

The scheduler owns the per-slot sampling-parameter vectors (temperature,
top-p) that the engine feeds the jitted sampler; idle rows decode a pad token
greedily at the last cache position and their output is discarded (contiguous:
their stale cache write is overwritten before any real row can attend to it;
paged: their block table points every entry at the trash block).
"""
from __future__ import annotations

from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.serving.api import (FinishReason, GenerationRequest, SamplingParams,
                               StepOutput)
from repro_torch.serving.paged import BlockAllocator, TRASH_BLOCK
from repro_torch.serving.prefix_cache import RadixPrefixCache


def bucket_length(n: int, lo: int, hi: int) -> int:
    """Round ``n`` up to a power of two in [lo, hi] (bounds recompiles to
    O(log(max_len)) prefill shapes)."""
    if lo < 1:
        raise ValueError(f"bucket lower bound {lo} must be >= 1")
    b = lo
    while b < n:
        b *= 2
    return min(b, hi)


def total_len(req: GenerationRequest) -> int:
    """Tokens the request's cache must currently hold: the prompt plus every
    generated token (nonzero generated happens on preemption re-admission)."""
    return len(req.prompt) + req.num_generated


class Scheduler:
    def __init__(self, n_slots: int, max_len: int, eos_id: int,
                 bucket_min: int = 8,
                 allocator: Optional[BlockAllocator] = None,
                 prefix_cache: Optional[RadixPrefixCache] = None,
                 prefill_chunk: int = 0,
                 prefill_budget: Optional[int] = None):
        if prefix_cache is not None and allocator is None:
            raise ValueError("prefix_cache requires the paged allocator")
        if prefill_chunk < 0:
            raise ValueError(f"prefill_chunk={prefill_chunk} must be >= 0 "
                             "(0 = whole-prompt chunks)")
        if prefill_budget is not None and prefill_budget < 1:
            raise ValueError(f"prefill_budget={prefill_budget} must be >= 1 "
                             "or None (a 0 budget would never prefill)")
        self.n_slots = n_slots
        self.max_len = max_len
        self.eos_id = eos_id
        # smallest whole-prompt chunk bucket (prefill_chunk == 0 mode);
        # chunk-width bucketing itself happens engine-side
        self.bucket_min = bucket_min
        self.prefill_chunk = prefill_chunk
        # cap on *total* chunk tokens planned per engine step, across all
        # prefilling slots (None = per-slot prefill_chunk only): bounds the
        # whole step's prefill work so a burst of long prompts cannot starve
        # decode latency; slots past the budget stall for the step
        self.prefill_budget = prefill_budget
        self.waiting: Deque[GenerationRequest] = deque()
        # uid -> arrival sequence number; preemption reinserts by arrival
        # order so an older request is never overtaken (strict FIFO even
        # when several slots preempt in one step)
        self._seq = 0
        self._arrival: dict = {}
        self.slots: List[Optional[GenerationRequest]] = [None] * n_slots
        # per-slot cache index of the *next* decode write; invariant for an
        # occupied slot: position = prompt_len + num_generated - 1 (the first
        # generated token comes from prefill logits and is written to the
        # cache only when the next decode step consumes it). Idle rows park at
        # max_len - 1, a position any real row overwrites before attending.
        self.positions = np.full((n_slots,), max_len - 1, np.int32)
        self.temperatures = np.zeros((n_slots,), np.float32)
        self.top_ps = np.ones((n_slots,), np.float32)
        # runtime counters (surfaced via Engine.stats())
        self.admissions = 0
        self.preemptions = 0
        # per-slot not-yet-prefilled tokens (prompt suffix, plus regenerated
        # outputs on preemption resume); nonempty = the slot is *prefilling*
        # and next_chunks() feeds it, empty = the slot is decoding
        self.pending: List[List[int]] = [[] for _ in range(n_slots)]
        # -- paged state (allocator is None on the contiguous path) ----------
        self.allocator = allocator
        self.prefix_cache = prefix_cache
        # per-slot prefill start offset: cache positions [0, prefix_lens[s])
        # are covered by trie-shared blocks and prefill starts there.
        # shared_counts[s] = leading entries of block_ids[s] that are shared
        # (read-only) rather than owned.
        self.prefix_lens = np.zeros((n_slots,), np.int32)
        self.shared_counts = [0] * n_slots
        # sanitizer hook (repro.analysis.shadow.ShadowBlockPool): claim /
        # attach_reader declare what each block reference *means* per slot.
        self.shadow = None
        # flight-recorder hook (repro.serving.telemetry.FlightRecorder),
        # attached by the supervisor: admissions and preemptions land in the
        # ring so a post-mortem dump shows the scheduling context around a
        # failure.  None by default — one attribute check when off.
        self.recorder = None
        if allocator is not None:
            self.block_tables = np.full(
                (n_slots, allocator.blocks_for(max_len)), TRASH_BLOCK,
                np.int32)
            self.block_ids: List[List[int]] = [[] for _ in range(n_slots)]
        else:
            self.block_tables = None
            self.block_ids = None

    # -- queue / slot management ---------------------------------------------

    def submit(self, req: GenerationRequest) -> None:
        if req.uid not in self._arrival:
            self._arrival[req.uid] = self._seq
            self._seq += 1
        self.waiting.append(req)

    def has_work(self) -> bool:
        return bool(self.waiting) or any(r is not None for r in self.slots)

    def active_slots(self) -> List[int]:
        return [i for i, r in enumerate(self.slots) if r is not None]

    def prefill_remaining(self, slot: int) -> int:
        """Prompt tokens the slot still has to prefill (0 once decoding)."""
        return len(self.pending[slot])

    def admit(self) -> Tuple[List[Tuple[int, GenerationRequest]],
                             List[StepOutput]]:
        """Fill free slots from the waiting queue (FIFO).  Admission does
        **not** prefill: the request's unprefilled tokens are parked in
        ``pending[slot]`` and ``next_chunks()`` feeds them to the fused step
        chunk by chunk.  Returns the newly admitted (slot, request) pairs
        plus StepOutputs for any request rejected up front (empty prompt,
        prompt too long for the per-slot cache, or needing more blocks than
        the whole pool holds — checked against the *full* requirement so a
        never-fitting prompt aborts instead of thrashing preempt/resume).
        On the paged path only the first chunk's blocks are allocated here;
        a queue head that merely has to *wait* for them stays queued and is
        not overtaken (strict FIFO, no starvation).

        With a prefix cache, admission is match-then-allocate: trie-matched
        blocks are pinned (``share()``) and mapped into the head of the block
        table, fresh blocks are allocated only for the first chunk of the
        remainder, and the covered prefix length lands in
        ``prefix_lens[slot]`` where prefill resumes.  The match is capped at
        the last block boundary strictly below the final token, so the first
        chunk (which seeds the first sampled token's logits) always writes
        owned blocks — a block-aligned full match re-runs its last block."""
        admitted: List[Tuple[int, GenerationRequest]] = []
        rejected: List[StepOutput] = []
        free = [i for i, r in enumerate(self.slots) if r is None]
        while free and self.waiting:
            req = self.waiting[0]
            total = total_len(req)
            # positions the request will eventually hold: the prompt (plus
            # any regenerated tokens) and the next decode write — except that
            # positions >= max_len are never written (LENGTH fires first), so
            # a resumed request sitting exactly at capacity needs no extra
            # block for a write that will never happen
            full_cover = min(total + 1, self.max_len)
            alloc = self.allocator
            too_long = (total + 1 > self.max_len if req.num_generated == 0
                        else total > self.max_len)
            if not req.prompt or too_long or (
                    alloc is not None
                    and alloc.blocks_for(full_cover) > alloc.allocatable):
                self.waiting.popleft()
                self._arrival.pop(req.uid, None)
                req.finish_reason = FinishReason.ABORTED
                rejected.append(StepOutput(uid=req.uid, token=-1, index=-1,
                                           finished=True,
                                           finish_reason=FinishReason.ABORTED))
                continue
            ids: List[int] = []
            shared: List[int] = []
            start = 0
            tokens = list(req.prompt) + list(req.output_tokens)
            if alloc is not None:
                if self.prefix_cache is not None:
                    # pin matched blocks *before* alloc(): its reclaim hook
                    # may LRU-evict, and a pinned block (refcount >= 2) is
                    # never an eviction victim.  Cap the match so at least
                    # the block holding the final token is re-prefilled —
                    # chunk writes then never land in a shared block.
                    matched = self.prefix_cache.match(tokens)
                    n_used = min(len(matched), (total - 1) // alloc.block_size)
                    shared = matched[:n_used]
                    for b in shared:
                        alloc.share(b)
                    start = len(shared) * alloc.block_size
                cover = self._chunk_cover(start, total)
                got = alloc.alloc(alloc.blocks_for(cover) - len(shared))
                if got is None:
                    if shared:         # un-pin; the trie keeps them cached
                        alloc.free(shared)
                    break              # head waits for blocks; FIFO preserved
                ids = shared + got
            self.waiting.popleft()
            slot = free.pop(0)
            self.slots[slot] = req
            self.positions[slot] = start       # next fill position
            self.pending[slot] = tokens[start:]
            self.temperatures[slot] = req.params.temperature
            self.top_ps[slot] = req.params.top_p
            if alloc is not None:
                if self.shadow is not None:
                    self.shadow.claim(slot, got)
                    for b in shared:
                        self.shadow.attach_reader(slot, b)
                self.block_ids[slot] = ids
                self.block_tables[slot, :] = TRASH_BLOCK
                self.block_tables[slot, :len(ids)] = ids
                self.shared_counts[slot] = len(shared)
                self.prefix_lens[slot] = start
                if self.prefix_cache is not None:
                    self.prefix_cache.record_admission(len(shared))
            admitted.append((slot, req))
            self.admissions += 1
            if self.recorder is not None:
                self.recorder.record("admit", uid=req.uid, slot=slot,
                                     prefix_len=start)
        return admitted, rejected

    def _cover(self, start: int, n: int, completes: bool) -> int:
        """Positions an ``n``-token chunk from ``start`` must have allocated:
        the chunk's writes, plus the next decode write when the chunk
        completes the prompt (positions >= max_len are never written, so the
        capacity edge needs no phantom block)."""
        return min(start + n + (1 if completes else 0), self.max_len)

    def _chunk_cover(self, start: int, total: int) -> int:
        """Cover for the slot's next *unclipped* chunk from ``start``
        (admission's first-chunk allocation; the per-step ``prefill_budget``
        clip is applied later, in :meth:`next_chunks`)."""
        suffix = total - start
        n = suffix if self.prefill_chunk <= 0 else min(self.prefill_chunk,
                                                       suffix)
        return self._cover(start, n, completes=n == suffix)

    def next_chunks(self) -> Dict[int, int]:
        """Plan this step's prefill work: {slot: chunk length} for every
        prefilling slot, each up to ``prefill_chunk`` tokens (0 = the whole
        remainder).  ``prefill_budget`` additionally caps the *sum* of chunk
        tokens across slots: planning walks slots in order, clipping the last
        funded chunk and stalling the rest for this step (a stalled slot
        stays admitted and resumes next step — decode rows never consume
        budget, so one burst of long prompts cannot fatten every step).  On
        the paged path the slot's allocation is grown to cover the chunk
        first; if the pool cannot (even after prefix-cache eviction), the
        half-prefilled slot is preempted — its published blocks let the
        resume skip the recompute when the cache is on."""
        plan: Dict[int, int] = {}
        budget = self.prefill_budget
        for slot, req in enumerate(self.slots):
            if req is None or not self.pending[slot]:
                continue
            remaining = len(self.pending[slot])
            n = remaining if self.prefill_chunk <= 0 else min(
                self.prefill_chunk, remaining)
            if budget is not None:
                if budget <= 0:
                    continue               # stalled: over budget this step
                n = min(n, budget)
            if self.allocator is not None:
                start = int(self.positions[slot])
                need = self.allocator.blocks_for(self._cover(
                    start, n, completes=n == remaining))
                if not self._grow_to(slot, need):
                    self._preempt(slot)
                    continue
            if budget is not None:
                budget -= n
            plan[slot] = n
        return plan

    def advance_prefill(self, slot: int, n: int) -> bool:
        """Mark ``n`` chunk tokens as filled (the fused step wrote their KV).
        Publishes the slot's newly completed blocks into the prefix cache —
        publish-as-blocks-fill, so identical prompts arriving while a long
        prompt is mid-prefill share everything resident so far (chunks that
        complete no new block skip the publish walk entirely, keeping the
        per-step host cost off the hot path; ``_free`` republishes the final
        state on every exit anyway).  Returns True when the prompt is
        exhausted: the step's sampled token for this row is the request's
        first output and the engine records it."""
        req = self.slots[slot]
        if req is None:
            raise ValueError(f"advance_prefill() on idle slot {slot}")
        filled_before = int(self.positions[slot])
        del self.pending[slot][:n]
        self.positions[slot] += n
        if self.prefix_cache is not None:
            bs = self.allocator.block_size
            filled = int(self.positions[slot])
            if filled // bs > filled_before // bs:
                tokens = (list(req.prompt) + list(req.output_tokens))[:filled]
                self.prefix_cache.insert(tokens,
                                         self.block_ids[slot][:filled // bs])
        return not self.pending[slot]

    def _free(self, slot: int) -> None:
        """Release the slot.  With a prefix cache the request's fully written
        blocks (prompt + generated prefix — everything up to the last cache
        write) are published into the trie first, so ``allocator.free`` only
        drops this request's references and trie-held blocks stay resident,
        cached-but-unreferenced, instead of recycling."""
        req = self.slots[slot]
        if self.allocator is not None:
            if self.prefix_cache is not None and req is not None:
                written = int(self.positions[slot])   # cache-valid positions
                tokens = (list(req.prompt) + list(req.output_tokens))[:written]
                self.prefix_cache.insert(tokens, self.block_ids[slot])
            self.allocator.free(self.block_ids[slot])
            self.block_ids[slot] = []
            self.block_tables[slot, :] = TRASH_BLOCK
            self.shared_counts[slot] = 0
        self.slots[slot] = None
        self.pending[slot] = []
        self.positions[slot] = self.max_len - 1
        self.prefix_lens[slot] = 0
        self.temperatures[slot] = 0.0
        self.top_ps[slot] = 1.0

    # -- cancellation ----------------------------------------------------------

    def cancel(self, uid: int, reason: FinishReason = FinishReason.CANCELLED,
               ) -> Optional[StepOutput]:
        """End a request from the outside — still queued, mid-prefill, or
        mid-decode.  Frees its slot and releases its blocks (``_free``: with
        a prefix cache the fully written prefix is *published*, so even a
        half-prefilled cancellation leaves its progress resident for future
        identical prompts).  Returns the terminal marker StepOutput, or None
        if the uid is not live here (already finished, or never submitted).
        The caller (engine) guarantees no further StepOutputs are emitted
        for this uid — any in-flight step's row is discarded on commit."""
        for i, req in enumerate(self.waiting):
            if req.uid == uid:
                del self.waiting[i]
                self._arrival.pop(uid, None)
                req.finish_reason = reason
                return StepOutput(uid=uid, token=-1, index=req.num_generated,
                                  finished=True, finish_reason=reason)
        for slot, req in enumerate(self.slots):
            if req is not None and req.uid == uid:
                req.finish_reason = reason
                self._arrival.pop(uid, None)
                self._free(slot)
                return StepOutput(uid=uid, token=-1, index=req.num_generated,
                                  finished=True, finish_reason=reason)
        return None

    # -- per-token lifecycle ---------------------------------------------------

    def pregrow_decode(self, slot: int) -> bool:
        """Grow the slot's allocation to cover its *next* decode write
        (position ``positions[slot] + 1``) ahead of time — the async loop's
        speculative launch calls this before dispatching step N+1 while step
        N is still on the device; ``record()``'s own growth then finds the
        block already present (``_grow_to`` is idempotent)."""
        if self.allocator is None:
            return True
        nxt = int(self.positions[slot]) + 1
        if nxt > self.max_len - 1:      # never written: LENGTH fires first
            return True
        return self._grow_to(slot, nxt // self.allocator.block_size + 1)

    def record(self, slot: int, token: int) -> StepOutput:
        """Append one generated token to the slot's request, apply stop
        conditions, and free the slot if the request finished.  On the paged
        path, grow the slot's block table when the next write position
        crosses into an unallocated block; if the pool is exhausted the slot
        is preempted (freed + requeued at the front) instead."""
        req = self.slots[slot]
        if req is None:
            raise ValueError(f"record() on idle slot {slot}")
        req.output_tokens.append(token)
        self.positions[slot] = len(req.prompt) + req.num_generated - 1

        reason: Optional[FinishReason] = None
        if token == self.eos_id and not req.params.ignore_eos:
            reason = FinishReason.STOP
        elif req.num_generated >= req.params.max_tokens:
            reason = FinishReason.LENGTH
        elif self.positions[slot] > self.max_len - 1:
            reason = FinishReason.LENGTH   # per-slot cache exhausted
        elif self.allocator is not None and not self._grow(slot):
            # re-admission must cover prompt + generated (+ the next write
            # where one can still happen, mirroring admit())
            cover = min(total_len(req) + 1, self.max_len)
            if self.allocator.blocks_for(cover) > self.allocator.allocatable:
                # the whole pool is smaller than this one request: finish
                # cleanly with the output kept instead of losing it to a
                # preempt->abort cycle
                reason = FinishReason.LENGTH
            else:
                self._preempt(slot)

        out = StepOutput(uid=req.uid, token=token,
                         index=req.num_generated - 1,
                         finished=reason is not None, finish_reason=reason)
        if reason is not None:
            req.finish_reason = reason
            self._arrival.pop(req.uid, None)
            self._free(slot)
        return out

    def _grow(self, slot: int) -> bool:
        """Ensure the slot's allocation covers its next write position."""
        return self._grow_to(
            slot, int(self.positions[slot]) // self.allocator.block_size + 1)

    def _grow_to(self, slot: int, need: int) -> bool:
        """Grow the slot's allocation to ``need`` blocks, one at a time.
        ``alloc()`` internally tries prefix-cache eviction before giving up,
        so growth preempts only when every block is pinned by live work."""
        while len(self.block_ids[slot]) < need:
            got = self.allocator.alloc(1)
            if got is None:
                return False
            if self.shadow is not None:
                self.shadow.claim(slot, got)
            self.block_ids[slot].extend(got)
            self.block_tables[slot, len(self.block_ids[slot]) - 1] = got[0]
        return True

    def _preempt(self, slot: int) -> None:
        """Recompute preemption: free the slot and its blocks, requeue the
        request in arrival order (admitted requests always predate everyone
        still waiting, so this lands at/near the front).  Re-admission
        prefills prompt + generated tokens, so the request resumes where it
        left off — and with a prefix cache, ``_free`` publishes the written
        blocks first, so the resume usually re-matches them and skips the
        recompute entirely (unless eviction reclaimed them meanwhile)."""
        req = self.slots[slot]
        seq = self._arrival[req.uid]
        i = 0
        while i < len(self.waiting) and \
                self._arrival[self.waiting[i].uid] < seq:
            i += 1
        self.waiting.insert(i, req)
        self._free(slot)
        self.preemptions += 1
        if self.recorder is not None:
            self.recorder.record("preempt", uid=req.uid, slot=slot,
                                 generated=req.num_generated)
