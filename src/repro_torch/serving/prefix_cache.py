"""Radix prefix cache: share system-prompt KV blocks across requests.

The serving-side payoff of the 1.58-bit story is that the KV cache is the
dominant resident state after weight packing — and without sharing, every
request carrying the same system prompt re-prefills it from scratch and
holds a private copy of its blocks.  This module is the allocation-policy
layer that fixes that: a block-granular radix tree (trie whose edges are
whole KV blocks, keyed by their ``block_size`` token ids) mapping token-id
prefixes to pool block ids, layered on :class:`~repro.serving.paged.
BlockAllocator` refcounts.

Protocol (driven by serving/scheduler.py + serving/engine.py):

* **match** — on admission the scheduler walks the trie with the request's
  token sequence.  Every fully-matched block is mapped into the slot's block
  table via ``share()`` (refcount bump, zero prefill compute for those
  positions); the engine prefills only the unmatched suffix.
* **insert** — right after admission (and again on every exit path) the
  request's fully-written prompt blocks are published into the trie: each
  newly created node takes its own ``share()`` reference, so the trie is a
  first-class holder.  A node that already exists keeps its existing block
  (the request's duplicate stays private and is freed normally) — dedup
  without copy-on-write, since block-granular matching means shared blocks
  are never written.
* **release** — when a request finishes or is preempted, ``free()`` drops
  its references; blocks the trie also holds fall to a *cached-but-
  unreferenced* state (refcount 1, held by the trie alone) instead of
  recycling — hot system prompts stay resident.
* **evict** — when ``BlockAllocator.alloc()`` would otherwise starve (its
  ``reclaim`` hook), cached-but-unreferenced **leaf** nodes are evicted in
  LRU order (cascading: an evicted leaf may expose its parent).  Blocks a
  live request still references are never evicted.

The trie never holds the trash block, and nothing here touches device
memory: eviction just drops references — the pool rows become ordinary free
blocks whose stale contents are overwritten before any row attends to them.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.serving.paged import TRASH_BLOCK, BlockAllocator, BlockPoolError


class _Node:
    """One cached KV block: trie edge label ``key`` (the block's token ids),
    the pool block holding its KV, and LRU bookkeeping."""
    __slots__ = ("key", "block_id", "children", "parent", "last_used")

    def __init__(self, key: Optional[Tuple[int, ...]], block_id: int,
                 parent: Optional["_Node"], last_used: int):
        self.key = key
        self.block_id = block_id
        self.children: Dict[Tuple[int, ...], "_Node"] = {}
        self.parent = parent
        self.last_used = last_used


class RadixPrefixCache:
    """Block-granular radix index from token-id prefixes to pool block ids.

    ``max_blocks`` (``ServeConfig.prefix_cache_blocks``) caps how many blocks
    the trie may hold; inserts past the cap evict LRU cached-but-unreferenced
    leaves (best effort — blocks pinned by live requests stay).  ``None``
    means unbounded: eviction then happens only when ``alloc()`` starves.

    Counters (``hits``/``misses``/``evictions``/``tokens_matched``) feed
    ``Engine.stats()``.
    """

    def __init__(self, allocator: BlockAllocator,
                 max_blocks: Optional[int] = None):
        if max_blocks is not None and max_blocks < 1:
            raise ValueError(f"max_blocks={max_blocks} must be >= 1 or None")
        self.allocator = allocator
        self.block_size = allocator.block_size
        self.max_blocks = max_blocks
        self._root = _Node(None, TRASH_BLOCK, None, 0)
        self._clock = 0                 # monotonic LRU counter (no wall time)
        self._num_nodes = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.tokens_matched = 0
        # sanitizer hook (repro.analysis.shadow.ShadowBlockPool): publish /
        # unpublish mark blocks immutable while the trie references them.
        self.shadow = None

    def __len__(self) -> int:
        """Blocks currently held by the trie."""
        return self._num_nodes

    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    def _block_keys(self, tokens: Sequence[int], n_blocks: int):
        bs = self.block_size
        for j in range(n_blocks):
            yield j, tuple(tokens[j * bs:(j + 1) * bs])

    # -- lookup ----------------------------------------------------------------

    def match(self, tokens: Sequence[int]) -> List[int]:
        """Longest cached block-aligned prefix of ``tokens`` -> pool block
        ids, LRU-touched.  Takes **no** references — the scheduler pins the
        result with ``share()`` before anything (eviction included) can run.
        Counters are NOT updated here: a queue head waiting on blocks
        re-matches every step, so the scheduler reports the outcome once per
        actual admission via :meth:`record_admission`."""
        node, ids = self._root, []
        now = self._tick()
        for _, key in self._block_keys(tokens, len(tokens) // self.block_size):
            child = node.children.get(key)
            if child is None:
                break
            child.last_used = now
            ids.append(child.block_id)
            node = child
        return ids

    def record_admission(self, n_matched_blocks: int) -> None:
        """Count one admission's match outcome (hit iff any block shared)."""
        if n_matched_blocks > 0:
            self.hits += 1
            self.tokens_matched += n_matched_blocks * self.block_size
        else:
            self.misses += 1

    # -- publication -----------------------------------------------------------

    def insert(self, tokens: Sequence[int], block_ids: Sequence[int]) -> int:
        """Publish the fully-written block prefix of ``tokens`` (KV in
        ``block_ids[j]`` for logical block ``j``) into the trie; returns the
        number of *new* nodes created.  Callers pass only positions whose KV
        is actually written (prompt after prefill; prompt + generated prefix
        on exit).  Existing nodes are kept as-is (dedup): the caller's
        duplicate block simply stays request-private."""
        node = self._root
        now = self._tick()
        n_full = min(len(tokens) // self.block_size, len(block_ids))
        created = 0
        for j, key in self._block_keys(tokens, n_full):
            child = node.children.get(key)
            if child is None:
                if block_ids[j] == TRASH_BLOCK:
                    break              # never cache trash-mapped entries
                self.allocator.share(block_ids[j])   # the trie's reference
                if self.shadow is not None:
                    self.shadow.publish(int(block_ids[j]))
                child = _Node(key, int(block_ids[j]), node, now)
                node.children[key] = child
                self._num_nodes += 1
                created += 1
            else:
                child.last_used = now
            node = child
        if self.max_blocks is not None and self._num_nodes > self.max_blocks:
            self.evict(self._num_nodes - self.max_blocks)
        return created

    # -- eviction --------------------------------------------------------------

    def _evictable_leaves(self) -> List[_Node]:
        out, stack = [], [self._root]
        while stack:
            node = stack.pop()
            stack.extend(node.children.values())
            if node is not self._root and not node.children and \
                    self.allocator.refcounts[node.block_id] == 1:
                out.append(node)       # trie is the sole holder
        return out

    def evict(self, n: int) -> int:
        """LRU-evict up to ``n`` cached-but-unreferenced blocks (leaf nodes
        whose only reference is the trie's), cascading upward as parents
        become leaves.  Returns blocks actually reclaimed; wired as the
        allocator's ``reclaim`` hook.  O(nodes) per scan — fine at pool
        scale (hundreds of blocks), swap in a heap if pools grow."""
        freed = 0
        while freed < n:
            leaves = self._evictable_leaves()
            if not leaves:
                break
            leaves.sort(key=lambda nd: nd.last_used)
            for victim in leaves:
                if freed >= n:
                    break
                del victim.parent.children[victim.key]
                if self.shadow is not None:
                    self.shadow.unpublish(victim.block_id)
                self.allocator.free([victim.block_id])
                self._num_nodes -= 1
                self.evictions += 1
                freed += 1
        return freed

    def clear(self) -> int:
        """Drop every cached-but-unreferenced block (e.g. between benchmark
        phases); pinned blocks stay."""
        return self.evict(self._num_nodes)

    # -- telemetry -------------------------------------------------------------

    def cached_unreferenced(self) -> int:
        """Blocks resident purely for reuse (refcount 1, trie-held) —
        reclaimable the moment the pool runs short."""
        stack, n = [self._root], 0
        while stack:
            node = stack.pop()
            stack.extend(node.children.values())
            if node is not self._root and \
                    self.allocator.refcounts[node.block_id] == 1:
                n += 1
        return n

    def stats(self) -> Dict[str, int]:
        return {
            "hits": self.hits,
            "misses": self.misses,
            "evictions": self.evictions,
            "tokens_matched": self.tokens_matched,
            "cached_blocks": self._num_nodes,
            "cached_unreferenced_blocks": self.cached_unreferenced(),
        }
