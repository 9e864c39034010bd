"""The port's paged KV-cache manager and prefix cache.

The reference's allocator and radix-index cases (``tests/test_kvcache.py``,
``tests/test_prefix_cache.py`` ``TestPageAllocatorRefs`` and
``TestPrefixCacheIndex``) replayed on the port's copies, a randomized
operation sequence run through both packages' allocators and caches in
lockstep, and the port's in-place ``write_tokens``/``read_tokens``
against the reference's functional ones on the same data.
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adversarial_spec_tpu.engine import kvcache as jax_kv
from adversarial_spec_tpu.engine import prefix_cache as jax_prefix
from adversarial_spec_tpu_torch.engine import prefix_cache as prefix_mod
from adversarial_spec_tpu_torch.engine.kvcache import (
    OutOfPages,
    PageAllocator,
    PagedCacheLayout,
    init_page_pool,
    read_tokens,
    write_tokens,
)
from adversarial_spec_tpu_torch.engine.prefix_cache import PrefixCache


class TestPageAllocator:
    def test_extend_allocates_minimal_pages(self):
        a = PageAllocator(n_pages=8, page_size=4)
        a.new_sequence(0)
        assert len(a.extend(0, 3)) == 1  # 3 tokens → 1 page
        assert a.length(0) == 3
        assert a.extend(0, 1) == []  # 4th token fits the same page
        assert len(a.extend(0, 1)) == 1  # 5th token → second page
        assert a.free_pages == 6

    def test_out_of_pages_rolls_back(self):
        a = PageAllocator(n_pages=2, page_size=2)
        a.new_sequence(0)
        a.extend(0, 4)
        a.new_sequence(1)
        with pytest.raises(OutOfPages):
            a.extend(1, 2)
        assert a.length(1) == 0 and a.free_pages == 0
        a.free_sequence(0)
        assert a.free_pages == 2
        a.extend(1, 2)

    def test_free_sequence_recycles_and_duplicates_rejected(self):
        a = PageAllocator(n_pages=4, page_size=2)
        a.new_sequence(0)
        a.extend(0, 8)
        assert a.free_pages == 0
        with pytest.raises(ValueError, match="already allocated"):
            a.new_sequence(0)
        a.free_sequence(0)
        assert a.free_pages == 4

    def test_table_array_padding_and_overflow(self):
        a = PageAllocator(n_pages=8, page_size=2)
        a.new_sequence(0)
        a.new_sequence(1)
        a.extend(0, 4)
        a.extend(1, 2)
        arr = a.table_array([0, 1], max_pages=4)
        assert arr.shape == (2, 4)
        assert (arr[0, :2] >= 0).all() and (arr[0, 2:] == -1).all()
        assert arr[1, 0] >= 0 and (arr[1, 1:] == -1).all()
        with pytest.raises(ValueError, match="spans"):
            a.table_array([0], max_pages=1)

    def test_adopt_shares_and_frees_at_zero(self):
        a = PageAllocator(8, 4)
        a.new_sequence(0)
        pages = a.extend(0, 8)
        a.new_sequence(1)
        a.adopt(1, pages, 8)
        assert all(a.refcount(p) == 2 for p in pages)
        a.free_sequence(0)
        assert all(a.refcount(p) == 1 for p in pages)
        assert a.free_pages == 6
        a.free_sequence(1)
        assert a.free_pages == 8
        a.check_invariants()

    def test_adopt_must_come_first_and_cover_pages(self):
        a = PageAllocator(8, 4)
        a.new_sequence(0)
        pages = a.extend(0, 4)
        a.new_sequence(1)
        a.extend(1, 1)
        with pytest.raises(ValueError, match="adopt must come first"):
            a.adopt(1, pages, 4)
        a.new_sequence(2)
        with pytest.raises(ValueError, match="exactly"):
            a.adopt(2, pages, 3)
        a.new_sequence(3)
        with pytest.raises(ValueError, match="unallocated"):
            a.adopt(3, [7], 4)

    def test_double_free_and_corruption_detected(self):
        a = PageAllocator(4, 4)
        a.new_sequence(0)
        [p] = a.extend(0, 4)
        a._free.append(p)  # corrupt: page both free and referenced
        with pytest.raises(RuntimeError, match="both free and referenced"):
            a.check_invariants()
        a._free.pop()
        a.free_sequence(0)
        with pytest.raises(RuntimeError, match="double free"):
            a.cache_unref(p)

    def test_out_of_pages_rollback_keeps_refs_clean(self):
        a = PageAllocator(2, 4)
        a.new_sequence(0)
        a.extend(0, 4)
        a.new_sequence(1)
        with pytest.raises(OutOfPages):
            a.extend(1, 12)
        a.check_invariants()
        assert a.free_pages == 1

    def test_truncate_releases_only_this_sequences_hold(self):
        a = PageAllocator(8, 4)
        a.new_sequence(0)
        pages = a.extend(0, 12)
        a.cache_ref(pages[2])  # the tail page is also cached
        released = a.truncate(0, 5)
        assert released == [pages[2]]
        assert a.refcount(pages[2]) == 1 and a.length(0) == 5
        assert a.covered_tokens(0) == 8
        with pytest.raises(ValueError, match="cannot truncate"):
            a.truncate(0, 6)
        a.check_invariants()

    def test_swap_pin_blocks_free(self):
        a = PageAllocator(4, 4)
        a.new_sequence(0)
        [p] = a.extend(0, 4)
        a.swap_pin(p)
        with pytest.raises(RuntimeError, match="swap in flight"):
            a.free_sequence(0)
        a.swap_unpin(p)
        with pytest.raises(RuntimeError, match="without pin"):
            a.swap_unpin(p)


class TestPrefixCacheIndex:
    def _cached(self, n_tokens, page_size=4, n_pages=32):
        a = PageAllocator(n_pages, page_size)
        c = PrefixCache(a, stats=prefix_mod.PrefixCacheStats())
        toks = list(range(n_tokens))
        a.new_sequence(0)
        a.extend(0, n_tokens)
        full = n_tokens // page_size
        c.insert(toks[: full * page_size], a.table(0)[:full])
        a.free_sequence(0)
        return a, c, toks

    def test_longest_prefix_and_divergence(self):
        a, c, toks = self._cached(12)
        m, pages = c.lookup(toks)
        assert m == 12 and len(pages) == 3
        assert c.lookup(toks[:8] + [99] * 4)[0] == 8
        assert c.lookup([99] + toks[1:])[0] == 0
        assert c.lookup(toks[:7])[0] == 4  # whole blocks only

    def test_lru_leaf_eviction_frees_pages(self):
        a, c, toks = self._cached(12)
        assert c.evict_pages(1) == 1
        assert a.free_pages == 32 - 2
        assert c.lookup(toks)[0] == 8  # the chain shrank from the tail

    def test_eviction_skips_pages_shared_with_live_sequences(self):
        a, c, toks = self._cached(8)
        m, pages = c.lookup(toks[:8])
        a.new_sequence(7)
        a.adopt(7, pages, 8)
        assert c.evict_pages(2) == 0
        a.free_sequence(7)
        assert c.evict_pages(2) == 2

    def test_max_pages_cap_enforced_on_insert(self):
        a = PageAllocator(32, 4)
        c = PrefixCache(a, max_pages=2, stats=prefix_mod.PrefixCacheStats())
        for base in (0, 100):
            a.new_sequence(base)
            a.extend(base, 8)
            c.insert(list(range(base, base + 8)), a.table(base))
            a.free_sequence(base)
        assert c.cached_pages <= 2
        a.check_invariants()

    def test_clear_releases_everything(self):
        a, c, toks = self._cached(12)
        c.clear()
        assert c.cached_pages == 0 and a.free_pages == 32
        a.check_invariants()

    def test_extend_evicting_reclaims_cold_blocks(self):
        a, c, toks = self._cached(12, n_pages=4)
        a.new_sequence(1)
        c.extend_evicting(1, 8)  # needs 2 pages, 1 free: evicts one block
        assert a.length(1) == 8 and c.cached_pages == 2
        with pytest.raises(OutOfPages):
            c.extend_evicting(1, 16)
        a.check_invariants()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_operations_match_reference(seed):
    """One random sequence of admit/adopt/extend/truncate/insert/evict/free
    through both packages' allocator + cache: identical page tables, free
    lists, refcounts and lookups after every step."""
    rng = random.Random(seed)
    ps, n_pages = 4, 24
    pa = PageAllocator(n_pages, ps)
    ja = jax_kv.PageAllocator(n_pages, ps)
    pc = PrefixCache(pa, stats=prefix_mod.PrefixCacheStats())
    jc = jax_prefix.PrefixCache(ja, stats=jax_prefix.PrefixCacheStats())
    live: dict[int, list[int]] = {}
    next_id = 0
    for _ in range(120):
        op = rng.choice(["admit", "extend", "truncate", "free", "evict"])
        if op == "admit":
            toks = [rng.randrange(3) for _ in range(rng.randrange(1, 14))]
            outs = []
            for a, c in ((pa, pc), (ja, jc)):
                m, pages = c.lookup(toks)
                a.new_sequence(next_id)
                try:
                    if m:
                        a.adopt(next_id, pages, m)
                    c.extend_evicting(next_id, len(toks) - m + 1)
                    c.insert(toks, a.table(next_id)[: len(toks) // ps])
                    outs.append(("ok", m))
                except OutOfPages:
                    a.free_sequence(next_id)
                    outs.append(("oop", m))
            assert outs[0] == outs[1]
            if outs[0][0] == "ok":
                live[next_id] = toks
            next_id += 1
        elif op == "extend" and live:
            sid = rng.choice(sorted(live))
            n = rng.randrange(1, 6)
            res = []
            for a, c in ((pa, pc), (ja, jc)):
                try:
                    c.extend_evicting(sid, n)
                    res.append("ok")
                except OutOfPages:
                    res.append("oop")
            assert res[0] == res[1]
        elif op == "truncate" and live:
            sid = rng.choice(sorted(live))
            n = rng.randrange(0, pa.length(sid) + 1)
            assert pa.truncate(sid, n) == ja.truncate(sid, n)
        elif op == "free" and live:
            sid = rng.choice(sorted(live))
            del live[sid]
            pa.free_sequence(sid)
            ja.free_sequence(sid)
        elif op == "evict":
            n = rng.randrange(1, 4)
            assert pc.evict_pages(n) == jc.evict_pages(n)
        pa.check_invariants()
        assert pa._free == ja._free and pa._refs == ja._refs
        assert pa._tables == ja._tables and pa._lengths == ja._lengths
        assert pc.cached_pages == jc.cached_pages


def test_write_and_read_tokens_match_reference():
    """The port scatters IN PLACE; the reference returns a new pool. Same
    K/V, same page ids and offsets (one row crossing a page boundary,
    one row on scattered pages) give the same pool and the same gather."""
    layout = PagedCacheLayout(
        n_pages=6, page_size=4, n_layers=2, n_kv_heads=2, head_dim=8
    )
    rng = np.random.default_rng(0)
    k_new = rng.standard_normal((2, 2, 2, 5, 8)).astype(np.float32)
    v_new = rng.standard_normal((2, 2, 2, 5, 8)).astype(np.float32)
    page_ids = np.array([[1, 1, 1, 1, 2], [5, 5, 3, 3, 3]], np.int32)
    offsets = np.array([[0, 1, 2, 3, 0], [2, 3, 0, 1, 2]], np.int32)

    ref = jax_kv.write_tokens(
        jax_kv.init_page_pool(layout, dtype=jnp.float32),
        jnp.asarray(k_new), jnp.asarray(v_new), page_ids, offsets,
    )
    pool = init_page_pool(layout, device=torch.device("cpu"), dtype=torch.float32)
    same = write_tokens(
        pool, torch.from_numpy(k_new), torch.from_numpy(v_new), page_ids, offsets
    )
    assert same is pool
    for name in ("k", "v"):
        np.testing.assert_array_equal(pool[name].numpy(), np.asarray(ref[name]))
    back_ref = jax_kv.read_tokens(ref, page_ids, offsets)
    back = read_tokens(pool, page_ids, offsets)
    for name in ("k", "v"):
        assert back[name].shape == (2, 2, 2, 5, 8)
        np.testing.assert_array_equal(back[name].numpy(), np.asarray(back_ref[name]))
    np.testing.assert_array_equal(back["k"].numpy(), k_new)
