"""Block-pooled paged KV cache: host-side allocator and block tables.

Instead of every decode slot owning a contiguous ``max_len`` KV region
(`n_slots * max_len` positions resident whether used or not), each attention
layer's cache is one shared pool of fixed-size blocks
``[num_blocks, Hkv, block_size, Dh]`` and every slot holds an int32 *block
table* mapping logical block ``j`` (positions ``j*bs .. (j+1)*bs - 1``) to a
pool block id.  The scheduler allocates blocks on admission (enough to cover
the prompt plus the first decode write), grows a slot one block at a time as
decoding advances, and returns blocks to the free list when the request
finishes, aborts, or is preempted — so resident KV bytes track the *actual*
token footprint of the batch, the paper's serving-memory story applied to
the cache instead of the weights.

Block 0 is reserved as the **trash block**: idle decode rows (and insert
writes past a slot's allocation) are pointed at it, so the jitted decode step
never needs a branch on slot occupancy; trash contents are never attended by
a live row because live rows only gather their own (or prefix-shared,
read-only) blocks.

``refcounts`` is the prefix-sharing protocol (serving/prefix_cache.py):
every holder of a block — an admitted request via its block table, or the
radix prefix cache via a trie node — owns one reference.  ``share()`` adds a
reference to a live block (the scheduler calls it for every trie-matched
prefix block it maps into a slot's table, and the prefix cache calls it when
a block is first inserted into the trie); ``free()`` drops one reference and
recycles the block only at zero.  A block whose sole remaining reference is
the trie's is *cached-but-unreferenced*: resident so a repeated prefix skips
its prefill, but reclaimable — ``alloc()`` calls the ``reclaim`` hook (wired
to :meth:`RadixPrefixCache.evict`) to LRU-evict such blocks before reporting
starvation.  Shared blocks are never written: block-granular matching means a
shared prefix always ends on a block boundary, so a request's own writes
(prefill suffix + decode growth) land in its exclusively-owned blocks and
recomputed-but-matched tail positions are discarded to the trash block
instead of copy-on-write.

Violations of the lifecycle (double free, freeing the trash block, sharing a
free block) raise :class:`BlockPoolError` — real exceptions, not ``assert``s,
so the invariants hold under ``python -O`` too.
"""
from __future__ import annotations

from collections import deque
from typing import Callable, Deque, List, Optional, Sequence

import numpy as np

TRASH_BLOCK = 0


class BlockPoolError(RuntimeError):
    """Block lifecycle violation: double free, free/share of the trash
    block, or share of a block that is not allocated."""


class BlockAllocator:
    """Free-list allocator over a fixed pool of KV blocks."""

    def __init__(self, num_blocks: int, block_size: int):
        if num_blocks < 2:
            raise ValueError(
                f"num_blocks={num_blocks}: need at least the reserved trash "
                "block plus one allocatable block")
        if block_size < 1:
            raise ValueError(f"block_size={block_size} must be >= 1")
        self.num_blocks = num_blocks
        self.block_size = block_size
        # per-block reference counts (one per holder: slot block tables and
        # prefix-cache trie nodes).  Block 0 (the trash block) is pinned with
        # refcount 1 and never enters the free list.
        self.refcounts = np.zeros((num_blocks,), np.int32)
        self.refcounts[TRASH_BLOCK] = 1
        self._free: Deque[int] = deque(range(1, num_blocks))
        # eviction hook: called by alloc() with the shortfall when the free
        # list cannot satisfy a request; returns blocks actually reclaimed.
        # The engine wires this to RadixPrefixCache.evict so cached-but-
        # unreferenced prefix blocks are LRU-recycled instead of starving
        # admission/growth.
        self.reclaim: Optional[Callable[[int], int]] = None
        # sanitizer hook (repro.analysis.shadow.ShadowBlockPool): when set,
        # every alloc/share/free transition is mirrored and validated.
        self.observer = None
        # fault-injection hook (repro.serving.faults.FaultPlan.alloc_hook):
        # when set and returning True for this call, alloc() reports
        # starvation even if blocks are free — a simulated exhaustion spike.
        # Callers already treat None as "wait and retry next step", so the
        # injected starvation exercises the real backoff path.
        self.fault_hook: Optional[Callable[[int], bool]] = None

    # -- capacity ------------------------------------------------------------

    def available(self) -> int:
        return len(self._free)

    @property
    def allocatable(self) -> int:
        """Total blocks a single request could ever hold."""
        return self.num_blocks - 1

    def blocks_for(self, n_tokens: int) -> int:
        """Blocks needed to cover ``n_tokens`` cache positions."""
        return -(-n_tokens // self.block_size)

    def blocks_in_use(self) -> int:
        """Allocated blocks (any holder), excluding the trash block."""
        return self.allocatable - len(self._free)

    # -- alloc / free ----------------------------------------------------------

    def alloc(self, n: int) -> Optional[List[int]]:
        """Pop ``n`` blocks (refcount 1 each); None if fewer are free —
        callers treat that as 'wait', never as partial allocation.  When the
        free list is short, the ``reclaim`` hook (prefix-cache LRU eviction)
        is given a chance to recycle cached-but-unreferenced blocks first."""
        if self.fault_hook is not None and self.fault_hook(n):
            return None
        if n > len(self._free) and self.reclaim is not None:
            self.reclaim(n - len(self._free))
        if n > len(self._free):
            return None
        ids = [self._free.popleft() for _ in range(n)]
        self.refcounts[ids] = 1
        if self.observer is not None:
            self.observer.on_alloc(ids)
        return ids

    def share(self, block_id: int) -> int:
        """Add a reference to an allocated block (prefix sharing: a slot's
        block table or a trie node becoming an additional holder)."""
        if block_id == TRASH_BLOCK:
            raise BlockPoolError("share() on the reserved trash block")
        if self.refcounts[block_id] <= 0:
            raise BlockPoolError(f"share() on free block {block_id}")
        self.refcounts[block_id] += 1
        if self.observer is not None:
            self.observer.on_share(int(block_id), int(self.refcounts[block_id]))
        return int(self.refcounts[block_id])

    def free(self, ids: Sequence[int]) -> None:
        """Drop one reference per id; a block recycles onto the free list
        only when its last holder lets go."""
        for b in ids:
            if b == TRASH_BLOCK:
                raise BlockPoolError("free() on the reserved trash block")
            if self.refcounts[b] <= 0:
                raise BlockPoolError(f"double free of block {b}")
            self.refcounts[b] -= 1
            if self.refcounts[b] == 0:
                self._free.append(b)
            if self.observer is not None:
                self.observer.on_free(int(b), int(self.refcounts[b]))
