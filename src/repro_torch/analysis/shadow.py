"""ASan-style shadow state machine for the paged KV block pool.

:class:`~repro_torch.serving.paged.BlockAllocator` enforces *local* invariants
(no double free, no share of a free block) but cannot see *who* holds a
block or *why* — a refcount of 2 looks the same whether it is two slots
sharing a prefix block or a bookkeeping bug double-counting one holder.
:class:`ShadowBlockPool` mirrors every block's lifecycle state explicitly:

    FREE ──alloc──▶ OWNED ──publish──▶ SHARED ──release──▶ PUBLISHED
      ▲               │(slot-exclusive,  (slot + trie /      (trie only,
      │               │ writable)        multi-reader,        evictable)
      │               ▼                  read-only)               │
      └──────── last free ◀──────────────────────── unpublish + free

* ``on_alloc`` / ``on_share`` / ``on_free`` are the **observer** hooks wired
  into the allocator (``BlockAllocator.observer``): they validate every
  refcount transition against a mirrored count and move blocks across the
  FREE boundary.
* ``claim`` / ``attach_reader`` / ``publish`` / ``unpublish`` are the
  **semantic** hooks the scheduler and prefix cache call to say what a
  reference *means*: a slot taking exclusive ownership of fresh blocks, a
  slot mapping an already-published prefix block read-only, the trie
  publishing a filled block, the trie evicting one.
* ``check_write`` is the engine-level write-set check: before a fused step
  dispatches, every block the step will scatter KV into must be OWNED by
  the writing slot (or the trash block).  Published/shared blocks are
  immutable — the whole prefix-sharing story rests on that.
* ``verify`` cross-checks the mirror against the real allocator (refcount
  array and free-list membership) and ``assert_drained`` asserts the
  end-of-work steady state: no OWNED or SHARED blocks, only FREE /
  PUBLISHED (cached-but-unreferenced) / TRASH.

Deliberately numpy-free pure Python: the shadow runs on the host
bookkeeping path only and must never import the accelerator stack.
Violations raise :class:`SanitizerError` immediately at the faulting call,
so the traceback points at the transition that broke the protocol.

Port of ``repro/analysis/shadow.py``, copied with the package renamed.
"""
from __future__ import annotations

import enum
from typing import Dict, List, Optional, Sequence

TRASH_BLOCK = 0   # mirrors repro_torch.serving.paged.TRASH_BLOCK (import-free)

UNOWNED = -1      # owner value for blocks no slot holds exclusively


class SanitizerError(RuntimeError):
    """A block-pool lifecycle or write-set violation caught by the shadow."""


class BlockState(enum.Enum):
    FREE = "free"              # on the allocator free list
    OWNED = "owned"            # exclusively held (and writable) by one slot
    SHARED = "shared"          # multiple holders (slot(s) and/or trie): read-only
    PUBLISHED = "published"    # trie-only (cached-but-unreferenced): read-only
    TRASH = "trash"            # block 0: idle-row sink, writable by anyone


class ShadowBlockPool:
    """Mirror of one :class:`BlockAllocator`'s block lifecycle."""

    def __init__(self, num_blocks: int, block_size: int,
                 checksums: bool = False):
        self.num_blocks = num_blocks
        self.block_size = block_size
        self.state: List[BlockState] = [BlockState.FREE] * num_blocks
        self.state[TRASH_BLOCK] = BlockState.TRASH
        self.owner: List[int] = [UNOWNED] * num_blocks
        self.refs: List[int] = [0] * num_blocks
        self.refs[TRASH_BLOCK] = 1
        self._published = set()       # blocks the trie currently references
        # optional per-block content digests (ServeConfig.kv_checksums): the
        # engine records a crc after each step's writes; a sweep comparing
        # fresh digests against these catches silent device-memory
        # corruption of resident blocks (the faults.py device_mem site)
        self.checksums_enabled = checksums
        self._checksums: Dict[int, int] = {}
        # counters surfaced through EngineStats.sanitizer
        self.transitions = 0
        self.write_checks = 0
        self.verifications = 0
        self.checksum_sweeps = 0
        self.checksum_mismatches = 0

    # -- helpers ---------------------------------------------------------------

    def _fail(self, msg: str) -> None:
        raise SanitizerError(f"shadow block pool: {msg}")

    def _guard(self, block_id: int, op: str) -> int:
        b = int(block_id)
        if not 0 <= b < self.num_blocks:
            self._fail(f"{op} on out-of-range block {b}")
        return b

    # -- allocator observer hooks (repro_torch.serving.paged.BlockAllocator) ---------

    def on_alloc(self, ids: Sequence[int]) -> None:
        """Blocks popped off the free list, refcount 1 each.  They are OWNED
        but unclaimed until the scheduler says which slot took them."""
        for b in ids:
            b = self._guard(b, "alloc")
            if self.state[b] is not BlockState.FREE:
                self._fail(f"alloc of block {b} in state "
                           f"{self.state[b].value} (refcount {self.refs[b]}) "
                           "— the allocator recycled a block that still has "
                           "a holder")
            self.state[b] = BlockState.OWNED
            self.owner[b] = UNOWNED
            self.refs[b] = 1
            self.transitions += 1

    def on_share(self, block_id: int, refcount: int) -> None:
        """One reference added.  The semantic meaning (reader vs trie) is
        declared separately via ``attach_reader`` / ``publish``."""
        b = self._guard(block_id, "share")
        if self.state[b] in (BlockState.FREE, BlockState.TRASH):
            self._fail(f"share of {self.state[b].value} block {b}")
        self.refs[b] += 1
        if self.refs[b] != refcount:
            self._fail(f"share of block {b}: allocator refcount {refcount} "
                       f"!= shadow refcount {self.refs[b]} — a refcount "
                       "update bypassed the protocol")
        self.transitions += 1

    def on_free(self, block_id: int, refcount: int) -> None:
        """One reference dropped; the block recycles at zero."""
        b = self._guard(block_id, "free")
        if self.state[b] in (BlockState.FREE, BlockState.TRASH) \
                or self.refs[b] <= 0:
            self._fail(f"free of {self.state[b].value} block {b}")
        self.refs[b] -= 1
        if self.refs[b] != refcount:
            self._fail(f"free of block {b}: allocator refcount {refcount} "
                       f"!= shadow refcount {self.refs[b]}")
        if self.refs[b] == 0:
            if b in self._published:
                self._fail(f"published block {b} released to the free list "
                           "— a trie reference was dropped without evicting "
                           "the node (unpublish)")
            self.state[b] = BlockState.FREE
            self.owner[b] = UNOWNED
            # content of a free block is unconstrained until its next writer
            self._checksums.pop(b, None)
        elif self.refs[b] == 1 and b in self._published:
            # the last non-trie holder let go: cached-but-unreferenced
            self.state[b] = BlockState.PUBLISHED
            self.owner[b] = UNOWNED
        self.transitions += 1

    # -- semantic hooks (scheduler / prefix cache) -----------------------------

    def claim(self, slot: int, ids: Sequence[int]) -> None:
        """A slot takes exclusive ownership of freshly allocated blocks
        (admission suffix blocks, decode growth, pregrow)."""
        for b in ids:
            b = self._guard(b, "claim")
            if self.state[b] is not BlockState.OWNED:
                self._fail(f"slot {slot} claimed block {b} in state "
                           f"{self.state[b].value} — only freshly allocated "
                           "blocks can be owned")
            if self.owner[b] not in (UNOWNED, slot):
                self._fail(f"slot {slot} claimed block {b} already owned by "
                           f"slot {self.owner[b]}")
            self.owner[b] = slot
            self.transitions += 1

    def attach_reader(self, slot: int, block_id: int) -> None:
        """A slot maps an already-published prefix block into its table
        read-only (trie match on admission)."""
        b = self._guard(block_id, "attach_reader")
        if self.state[b] not in (BlockState.SHARED, BlockState.PUBLISHED):
            self._fail(f"slot {slot} attached to block {b} in state "
                       f"{self.state[b].value} — prefix matches may only "
                       "map published blocks")
        self.state[b] = BlockState.SHARED
        self.transitions += 1

    def publish(self, block_id: int) -> None:
        """The trie takes its reference to a filled block: the owning slot
        keeps reading it, but it is immutable from here on."""
        b = self._guard(block_id, "publish")
        if self.state[b] is not BlockState.OWNED:
            self._fail(f"publish of block {b} in state "
                       f"{self.state[b].value} — only a slot-owned filled "
                       "block can enter the trie")
        if b in self._published:
            self._fail(f"double publish of block {b}")
        self.state[b] = BlockState.SHARED
        self.owner[b] = UNOWNED
        self._published.add(b)
        self.transitions += 1

    def unpublish(self, block_id: int) -> None:
        """The trie evicts its node; the allocator ``free`` that follows
        moves the block to FREE (eviction only targets trie-only blocks)."""
        b = self._guard(block_id, "unpublish")
        if b not in self._published:
            self._fail(f"unpublish of block {b} the trie does not hold")
        if self.state[b] is not BlockState.PUBLISHED:
            self._fail(f"unpublish of block {b} in state "
                       f"{self.state[b].value} — a live request still reads "
                       "it, eviction must never reclaim pinned blocks")
        self._published.discard(b)
        self.transitions += 1

    # -- engine-level checks ---------------------------------------------------

    def check_write(self, slot: int, block_id: int) -> None:
        """A fused step is about to scatter KV into ``block_id`` on behalf of
        ``slot``: legal only into the trash block or a block that slot owns
        exclusively.  Shared/published blocks are immutable."""
        b = self._guard(block_id, "write")
        self.write_checks += 1
        if b == TRASH_BLOCK:
            return
        if self.state[b] is not BlockState.OWNED or self.owner[b] != slot:
            self._fail(
                f"slot {slot} is about to write block {b} in state "
                f"{self.state[b].value}"
                + (f" owned by slot {self.owner[b]}"
                   if self.state[b] is BlockState.OWNED else "")
                + " — chunk/decode scatters must land only in blocks the "
                  "writing slot owns exclusively")

    def verify(self, allocator) -> None:
        """Cross-check the mirror against the live allocator: refcounts must
        match and free-list membership must agree with FREE states."""
        self.verifications += 1
        for b in range(self.num_blocks):
            if int(allocator.refcounts[b]) != self.refs[b]:
                self._fail(f"block {b}: allocator refcount "
                           f"{int(allocator.refcounts[b])} != shadow "
                           f"refcount {self.refs[b]}")
        free = set(allocator._free)
        for b in range(self.num_blocks):
            if (self.state[b] is BlockState.FREE) != (b in free):
                self._fail(f"block {b}: shadow state {self.state[b].value} "
                           "disagrees with allocator free-list membership")

    def assert_drained(self) -> None:
        """No live work: every block must be FREE, PUBLISHED (cached-but-
        unreferenced prefix blocks), or TRASH.  A leftover OWNED/SHARED
        block is a leaked reference."""
        leaked = [(b, self.state[b].value, self.owner[b])
                  for b in range(self.num_blocks)
                  if self.state[b] in (BlockState.OWNED, BlockState.SHARED)]
        if leaked:
            self._fail(f"{len(leaked)} block(s) leaked at drain "
                       f"(block, state, owner): {leaked[:8]}")

    # -- per-block content checksums (device-memory integrity) -----------------

    def note_checksum(self, block_id: int, digest: int) -> None:
        """Record the content digest of a block the engine just (re)wrote.
        Until the block's next legal write or free, any digest drift means
        something mutated device memory behind the protocol's back.  Blocks
        already back on the free list (written by a row that finished in the
        same commit) are skipped — their content is unconstrained."""
        b = self._guard(block_id, "note_checksum")
        if b != TRASH_BLOCK and self.state[b] is not BlockState.FREE:
            self._checksums[b] = int(digest)

    def checksummed(self) -> List[int]:
        """Blocks with a recorded digest (resident, written at least once)."""
        return sorted(self._checksums)

    def verify_checksums(self, digests: Dict[int, int]) -> List[int]:
        """Compare freshly computed digests against the recorded ones;
        returns the corrupt block ids (recorded and fresh digest differ).
        The caller (``Engine.check_kv_integrity``) decides recovery —
        unlike protocol violations this is *environmental* damage, so it
        is reported, not raised."""
        self.checksum_sweeps += 1
        bad = [b for b, d in digests.items()
               if b in self._checksums and self._checksums[b] != int(d)]
        self.checksum_mismatches += len(bad)
        return sorted(bad)

    # -- telemetry -------------------------------------------------------------

    def counts(self) -> Dict[str, int]:
        by_state: Dict[str, int] = {}
        for s in self.state:
            by_state[s.value] = by_state.get(s.value, 0) + 1
        return by_state

    def stats(self) -> Dict[str, int]:
        out = {"transitions": self.transitions,
               "write_checks": self.write_checks,
               "verifications": self.verifications,
               "published": len(self._published)}
        if self.checksums_enabled:
            out["checksum_sweeps"] = self.checksum_sweeps
            out["checksum_mismatches"] = self.checksum_mismatches
            out["checksummed_blocks"] = len(self._checksums)
        for state, n in self.counts().items():
            out[f"state_{state}"] = n
        return out
