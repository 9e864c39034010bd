"""Content-addressed cross-round prefix KV cache (host-side index).

Counterpart of ``adversarial_spec_tpu/engine/prefix_cache.py`` (a copy,
emitting the same flight-recorder events through the port's ``obs``
package). The debate loop's dominant compute is redundant prefill: every
round all N opponents re-prefill the same spec+transcript prefix, and
round R+1 re-prefills everything round R already computed. This module is
the host-side half of the fix — the device half is the ref-counted page
pool in engine/kvcache.py:

- Token streams are split into page-size-aligned BLOCKS and indexed in a
  radix trie keyed by exact block content (full-content verification —
  no collision risk).
- Each cached block points at the physical page holding its KV. The
  cache holds one allocator reference per cached page; live sequences
  that adopt a prefix hold their own. Pages free only at refcount zero.
- ``lookup`` returns the longest cached prefix (whole blocks only);
  ``insert`` registers a finished admission's full blocks; ``evict_pages``
  drops least-recently-used LEAF blocks whose page no live sequence
  references — middle blocks are never evicted, keeping every cached
  chain contiguous.

Sharing is safe without copies because blocks are immutable once full
and every writer's positions lie strictly past its adopted prefix. A
faulted slot merely drops its references; it can never scribble into a
shared page. Process-wide config + stats live here too
(``ADVSPEC_PREFIX_CACHE``, default on). The lower KV tiers
(engine/kvtier.py, ``attach_tiers``) hang below the radix: LRU-evicted
leaves demote into them and ``lookup_tiered`` continues the walk past
the device tier. The module holds no device state (page content lives
wherever the caller keeps it), so the mock engine uses it for CPU
accounting.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

from adversarial_spec_tpu_torch import obs as obs_mod
from adversarial_spec_tpu_torch.engine import procconfig
from adversarial_spec_tpu_torch.engine.kvcache import OutOfPages, PageAllocator
from adversarial_spec_tpu_torch.engine.kvtier import chain_hash


@dataclass
class PrefixCacheConfig:
    """Process-wide knobs, set once per CLI round (or by tests)."""

    enabled: bool = True
    # Max pages the cache itself may hold references to; 0 = bounded only
    # by the pool (eviction then happens on allocation pressure alone).
    max_pages: int = 0


@dataclass
class PrefixCacheStats(procconfig.StatsBase):
    """Process-wide counters, aggregated across every cache instance
    (each ContinuousBatcher). ``reset`` zeroes in place so engines
    holding a reference keep counting into the same object."""

    lookups: int = 0
    hits: int = 0
    misses: int = 0
    cached_tokens: int = 0  # tokens matched by lookups
    prefilled_tokens: int = 0  # tokens actually run through prefill
    saved_tokens: int = 0  # forward tokens skipped thanks to reuse
    inserted_blocks: int = 0
    evicted_blocks: int = 0
    evicted_pages: int = 0

    def record_lookup(self, matched_tokens: int) -> None:
        self.lookups += 1
        if matched_tokens > 0:
            self.hits += 1
            self.cached_tokens += matched_tokens
        else:
            self.misses += 1
        # Every engine (the batcher and the mock's CPU accounting)
        # funnels lookups through here — ONE emit site covers both.
        obs_mod.emit(
            obs_mod.CacheEvent(
                op="lookup",
                matched_tokens=matched_tokens,
                hit=matched_tokens > 0,
            )
        )
        if obs_mod.config().enabled:
            obs_mod.hot.hit_ratio.set(round(self.hits / self.lookups, 6))

    def record_prefill(self, computed_tokens: int, saved_tokens: int) -> None:
        self.prefilled_tokens += computed_tokens
        self.saved_tokens += saved_tokens

    def snapshot(self) -> dict:
        out = self.as_dict()
        out["hit_rate"] = round(self.hits / self.lookups, 4) if self.lookups else 0.0
        return out


_state = procconfig.ProcState(
    PrefixCacheConfig(
        enabled=os.environ.get("ADVSPEC_PREFIX_CACHE", "1") != "0"
    ),
    PrefixCacheStats(),
    # max_pages is config-only (the cap), not part of the perf payload.
    snapshot_fields=("enabled",),
)
_config = _state.config
stats = _state.stats


def config() -> PrefixCacheConfig:
    return _state.config


def configure(
    enabled: bool | None = None, max_pages: int | None = None
) -> PrefixCacheConfig:
    return _state.configure(enabled=enabled, max_pages=max_pages)


def reset_stats() -> None:
    _state.reset_stats()


def snapshot() -> dict:
    """Stats + config, the ``perf.prefix_cache`` payload."""
    return _state.snapshot()


@dataclass
class _Block:
    """One cached page-size block of tokens; a radix-trie node."""

    tokens: tuple
    page: int
    parent: "_Block | None"
    children: dict = field(default_factory=dict)
    last_used: int = 0
    # Content-addressed chain hash (engine/kvtier.py) — the block's
    # cross-process identity, stamped at insert when tiers are
    # attached; None on a tier-less cache (hashing skipped).
    chain: str | None = None


class PrefixCache:
    """Radix index of cached token blocks over one ``PageAllocator``.

    All methods are O(blocks touched); the cache is host-side bookkeeping
    only — page CONTENT lives wherever the caller keeps it (the device
    pool for real engines, nowhere for the mock engine's accounting).
    """

    def __init__(
        self,
        allocator: PageAllocator,
        page_size: int | None = None,
        *,
        max_pages: int = 0,
        stats: PrefixCacheStats | None = None,
    ):
        self.allocator = allocator
        self.page_size = page_size or allocator.page_size
        self.max_pages = max_pages
        self.stats = stats if stats is not None else globals()["stats"]
        self._root: dict[tuple, _Block] = {}
        self._by_page: dict[int, _Block] = {}
        self._clock = 0
        # Lower tiers (engine/kvtier.py), attached by the owner before
        # the first insert: LRU-evicted leaves demote into them, and
        # ``lookup_tiered`` continues the radix walk past the device
        # tier. ``_kv_fetch(page, n_tokens)`` (scheduler-installed)
        # returns a LAZY payload materializer for a page's KV — None on
        # accounting-only caches (the mock engine).
        self.tiers = None
        self._kv_fetch = None

    def attach_tiers(self, tiers, kv_fetch=None) -> None:
        """Arm the host/disk tiers. Must precede the first ``insert``
        (blocks are chain-stamped at insert; a block inserted tier-less
        has no cross-process identity and silently skips demotion)."""
        self.tiers = tiers
        self._kv_fetch = kv_fetch

    @property
    def cached_pages(self) -> int:
        return len(self._by_page)

    def _blocks(self, tokens) -> list[tuple]:
        ps = self.page_size
        n = len(tokens) // ps
        return [tuple(tokens[i * ps : (i + 1) * ps]) for i in range(n)]

    def lookup(self, tokens, record: bool = True) -> tuple[int, list[int]]:
        """Longest cached prefix of ``tokens``: (matched token count —
        always a page multiple — and the pages backing it, in order).

        ``record=False`` skips the stats (a caller that may DEFER the
        admission — scheduler pool-full retries — records once, with the
        actually-adopted count, when the admission really starts)."""
        self._clock += 1
        pages: list[int] = []
        children = self._root
        for key in self._blocks(tokens):
            node = children.get(key)
            if node is None:
                break
            node.last_used = self._clock
            pages.append(node.page)
            children = node.children
        matched = len(pages) * self.page_size
        if record:
            self.stats.record_lookup(matched)
        return matched, pages

    def lookup_tiered(
        self, tokens, record: bool = True
    ) -> tuple[int, list[int], list]:
        """``lookup`` continued past the device tier: after the radix
        walk stops, subsequent full blocks are matched against the host
        tier, then the disk store, by chain hash — the contiguous run
        of lower-tier blocks the admission can promote instead of
        prefilling. Returns ``(matched_tokens, pages, tier_hits)``;
        with no tiers attached it degenerates to ``lookup``."""
        self._clock += 1
        pages: list[int] = []
        hits: list = []
        children = self._root
        chain = ""
        blocks = self._blocks(tokens)
        depth = 0
        for key in blocks:
            node = children.get(key)
            if node is None:
                break
            node.last_used = self._clock
            if self.tiers is not None:
                # Reuse the chain stamped at insert — rehashing ~every
                # matched block per lookup (and per pool-full admission
                # retry) would be pure hot-path recomputation.
                chain = (
                    node.chain
                    if node.chain is not None
                    else chain_hash(chain, key)
                )
            pages.append(node.page)
            children = node.children
            depth += 1
        if self.tiers is not None:
            for key in blocks[depth:]:
                chain = chain_hash(chain, key)
                hit = self.tiers.lookup_chain(chain, key)
                if hit is None:
                    break
                hits.append(hit)
        matched = len(pages) * self.page_size
        if record:
            self.stats.record_lookup(matched)
            if self.tiers is not None:
                self.tiers.record_lookup(hits)
        return matched, pages, hits

    def insert(self, tokens, pages: list[int]) -> int:
        """Register the full blocks of ``tokens``; ``pages[i]`` is the
        allocator page holding block i's KV. Blocks already cached keep
        their existing page (first writer wins — content is identical by
        construction). Returns the number of newly cached blocks."""
        self._clock += 1
        blocks = self._blocks(tokens)
        if len(pages) < len(blocks):
            blocks = blocks[: len(pages)]
        added = 0
        children = self._root
        parent: _Block | None = None
        chain = ""
        for key, page in zip(blocks, pages):
            if self.tiers is not None:
                chain = chain_hash(chain, key)
            node = children.get(key)
            if node is None:
                node = _Block(
                    tokens=key,
                    page=page,
                    parent=parent,
                    chain=chain if self.tiers is not None else None,
                )
                # Ownership transfer: the ref is recorded in _by_page on
                # the next line and released by _drop (LRU eviction /
                # clear); nothing between can raise.
                self.allocator.cache_ref(page)
                self._by_page[page] = node
                children[key] = node
                added += 1
                if self.tiers is not None and self.tiers.needs_store(chain):
                    # Disk write-through: queue the new block for the
                    # persistent store (flushed at drain end — file I/O
                    # off the serving path). The payload gather is
                    # dispatched NOW (the page is live and immutable
                    # here; by flush time it may be reused) but
                    # materializes lazily. needs_store first: a
                    # re-promoted/rehydrated block already queued or on
                    # disk must not pay a discarded gather.
                    self.tiers.enqueue_store(
                        chain,
                        key,
                        self._kv_fetch(page, len(key))
                        if self._kv_fetch is not None
                        else None,
                    )
            node.last_used = self._clock
            parent = node
            children = node.children
        self.stats.inserted_blocks += added
        if added:
            obs_mod.emit(obs_mod.CacheEvent(op="insert", blocks=added))
        if self.max_pages > 0 and self.cached_pages > self.max_pages:
            self._evict(self.cached_pages - self.max_pages, shared_ok=True)
        return added

    def _leaves(self) -> list[_Block]:
        return [b for b in self._by_page.values() if not b.children]

    def _drop(self, block: _Block) -> bool:
        """Remove one leaf block from the index and release the cache's
        page reference. Returns True if the page actually freed (no live
        sequence was sharing it).

        With tiers attached the block DEMOTES on its way out: its KV is
        gathered off the page BEFORE the reference drops (the page may
        return to the free list and be re-used by the very allocation
        that triggered this eviction — the gather is an independent
        copy, started async, materialized off the hot path), and the
        block enters the host tier keyed by its chain hash."""
        siblings = (
            block.parent.children if block.parent is not None else self._root
        )
        del siblings[block.tokens]
        del self._by_page[block.page]
        if self.tiers is not None and block.chain is not None:
            self.tiers.demote(
                block.chain,
                block.tokens,
                self._kv_fetch(block.page, len(block.tokens))
                if self._kv_fetch is not None
                else None,
            )
        freed = self.allocator.refcount(block.page) == 1
        self.allocator.cache_unref(block.page)
        self.stats.evicted_blocks += 1
        if freed:
            self.stats.evicted_pages += 1
        obs_mod.emit(
            obs_mod.CacheEvent(op="evict", blocks=1, pages=int(freed))
        )
        return freed

    def _evict(self, n_pages: int, shared_ok: bool) -> int:
        """Evict LRU leaves until ``n_pages`` pages were released.
        ``shared_ok=False`` (allocation pressure) only counts — and only
        touches — blocks whose page frees immediately; ``shared_ok=True``
        (cap enforcement) also drops blocks still referenced by live
        sequences (their pages free later, when the sequence does).

        One LRU-sorted pass per wave: dropping a leaf can turn its
        parent into a leaf, so waves repeat only while the target is
        short AND the previous wave made progress — O(blocks log blocks)
        per wave instead of a full rescan per released page."""
        released = 0
        while released < n_pages:
            wave = sorted(
                (
                    b
                    for b in self._leaves()
                    if shared_ok or self.allocator.refcount(b.page) == 1
                ),
                key=lambda b: b.last_used,
            )
            if not wave:
                break
            for victim in wave:
                if released >= n_pages:
                    break
                if victim.children:  # no longer a leaf is impossible;
                    continue  # defensive against future reentrancy
                if self._drop(victim) or shared_ok:
                    released += 1
        return released

    def evict_pages(self, n_pages: int) -> int:
        """Free ≥ ``n_pages`` pages back to the allocator if possible
        (called when an admission would otherwise hit OutOfPages).
        Returns how many pages were actually freed."""
        if n_pages <= 0:
            return 0
        return self._evict(n_pages, shared_ok=False)

    def extend_evicting(self, seq_id: int, n_tokens: int) -> None:
        """``allocator.extend`` with allocation pressure converted into
        LRU eviction of unreferenced cached blocks: reclaim exactly the
        shortfall and retry once, so the cache can never crowd out a
        live admission. The one reclaim policy both real engines and the
        mock's accounting share. Raises OutOfPages if the pool is full
        even with every cold block evicted."""
        try:
            self.allocator.extend(seq_id, n_tokens)
        except OutOfPages:
            need = (
                self.allocator.pages_needed(seq_id, n_tokens)
                - self.allocator.free_pages
            )
            if self.evict_pages(need) < need:
                raise
            self.allocator.extend(seq_id, n_tokens)

    def clear(self) -> None:
        """Drop every cached block (releasing all cache references)."""
        while self._by_page:
            for b in self._leaves():
                self._drop(b)
