"""Paged KV-cache manager: page allocator + device page pool.

Counterpart of ``adversarial_spec_tpu/engine/kvcache.py``. The host-side
bookkeeping (``OutOfPages``, ``PagedCacheLayout``, ``PageAllocator``: free
list, ref-counted per-sequence page tables, ``truncate``/``adopt``/
``cache_ref``/swap pins and ``check_invariants``) is the reference's, line
for line — it is plain Python over integers. The page pool is a dict of
torch tensors ``{"k", "v": [L, n_pages, Hkv, page_size, D]}`` (plus
``{"ks", "vs"}`` scale pages for an int8 pool) on the engine's device,
read by the paged decode kernels (``ops/paged_attention.py``) and written
IN PLACE by ``write_tokens`` (the reference returns a new functional
pool; the port saves the copy). torch is imported inside the pool
functions only, as the reference imports jax: the host-side allocator
stays importable from torch-free flows (the mock engine, a ``mock://``
fleet worker).

Sizing: a debate round's opponents share the pool; ``n_pages`` bounds
total resident tokens across all rows, not per-row length.

Pages are REF-COUNTED: a page may back several sequences at once (a
cached prefix adopted by every opponent in a round — engine/
prefix_cache.py) plus one reference held by the prefix cache itself. A
page returns to the free list only when its last reference drops.
Sharing is copy-on-append: block content is immutable once a page is
full, and a writer's positions always lie past its adopted prefix.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


class OutOfPages(RuntimeError):
    pass


@dataclass
class PagedCacheLayout:
    n_pages: int
    page_size: int
    n_layers: int
    n_kv_heads: int
    head_dim: int

    @property
    def tokens_capacity(self) -> int:
        return self.n_pages * self.page_size


class PageAllocator:
    """Free-list page allocator with per-sequence ordered page tables.

    Every allocated page carries a reference count: 1 per sequence whose
    table contains it plus 1 if the prefix cache holds it. ``extend``
    allocates fresh pages at refcount 1; ``adopt`` appends already-
    allocated (shared) pages to a new sequence's table, bumping their
    counts; ``free_sequence`` / ``cache_unref`` drop references and a
    page returns to the free list only at zero.
    """

    def __init__(self, n_pages: int, page_size: int):
        self.n_pages = n_pages
        self.page_size = page_size
        self._free = list(range(n_pages - 1, -1, -1))  # pop() → page 0 first
        self._tables: dict[int, list[int]] = {}
        self._lengths: dict[int, int] = {}
        self._refs: dict[int, int] = {}  # page -> reference count
        # Pages with an in-flight tier swap: they must stay referenced
        # until the swap owner unpins, and freeing one is a bookkeeping
        # corruption check_invariants / _release catch.
        self._swap_pins: dict[int, int] = {}  # page -> pin count

    @property
    def free_pages(self) -> int:
        return len(self._free)

    def refcount(self, page: int) -> int:
        return self._refs.get(page, 0)

    def new_sequence(self, seq_id: int) -> None:
        if seq_id in self._tables:
            raise ValueError(f"sequence {seq_id} already allocated")
        self._tables[seq_id] = []
        self._lengths[seq_id] = 0

    def pages_needed(self, seq_id: int, n_tokens: int) -> int:
        """Fresh pages an ``extend(seq_id, n_tokens)`` would allocate."""
        needed = -(-(self._lengths[seq_id] + n_tokens) // self.page_size)
        return max(0, needed - len(self._tables[seq_id]))

    def extend(self, seq_id: int, n_tokens: int) -> list[int]:
        """Reserve room for n_tokens more; returns newly allocated pages."""
        table = self._tables[seq_id]
        length = self._lengths[seq_id]
        needed_pages = -(-(length + n_tokens) // self.page_size)
        new_pages = []
        while len(table) < needed_pages:
            if not self._free:
                # Roll back this call's allocations before failing.
                for p in new_pages:
                    table.remove(p)
                    del self._refs[p]
                    self._free.append(p)
                raise OutOfPages(
                    f"paged KV cache exhausted: {self.n_pages} pages of "
                    f"{self.page_size} tokens all in use"
                )
            p = self._free.pop()
            table.append(p)
            self._refs[p] = 1
            new_pages.append(p)
        self._lengths[seq_id] = length + n_tokens
        return new_pages

    def adopt(self, seq_id: int, pages: list[int], n_tokens: int) -> None:
        """Share already-allocated ``pages`` (a cached prefix) into a fresh
        sequence. Must precede any ``extend`` for the sequence — adopted
        pages form its table head, exactly covering ``n_tokens``."""
        if self._tables[seq_id] or self._lengths[seq_id]:
            raise ValueError(
                f"sequence {seq_id} already has pages; adopt must come first"
            )
        if n_tokens != len(pages) * self.page_size:
            raise ValueError(
                f"adopt of {len(pages)} pages must cover exactly "
                f"{len(pages) * self.page_size} tokens, got {n_tokens}"
            )
        for p in pages:
            if p not in self._refs:
                raise ValueError(f"cannot adopt unallocated page {p}")
        for p in pages:
            self._refs[p] += 1
        self._tables[seq_id].extend(pages)
        self._lengths[seq_id] = n_tokens

    def cache_ref(self, page: int) -> None:
        """Take the prefix cache's reference on an allocated page."""
        if page not in self._refs:
            raise ValueError(f"cannot cache-ref unallocated page {page}")
        self._refs[page] += 1

    def cache_unref(self, page: int) -> None:
        """Drop the prefix cache's reference (page frees at zero)."""
        self._release(page)

    def swap_pin(self, page: int) -> None:
        """Mark ``page`` as the target of an in-flight tier swap. Freeing
        a pinned page is a refcount corruption. Pins pair with
        ``swap_unpin`` in try/finally."""
        if page not in self._refs:
            raise ValueError(f"cannot swap-pin unallocated page {page}")
        self._swap_pins[page] = self._swap_pins.get(page, 0) + 1

    def swap_unpin(self, page: int) -> None:
        """Drop one swap pin (the page's owning references keep it alive
        from here)."""
        n = self._swap_pins.get(page, 0)
        if n <= 0:
            raise RuntimeError(f"swap-unpin without pin on page {page}")
        if n == 1:
            del self._swap_pins[page]
        else:
            self._swap_pins[page] = n - 1

    def _release(self, page: int) -> None:
        refs = self._refs.get(page, 0)
        if refs <= 0:
            raise RuntimeError(f"double free of page {page}")
        if refs == 1:
            if page in self._swap_pins:
                raise RuntimeError(
                    f"freeing page {page} with a tier swap in flight "
                    "(swap_pin held)"
                )
            del self._refs[page]
            self._free.append(page)
        else:
            self._refs[page] = refs - 1

    def truncate(self, seq_id: int, n_tokens: int) -> list[int]:
        """Shrink ``seq_id`` to ``n_tokens``, releasing tail pages that no
        longer back any of its tokens — the speculative-decode rollback
        primitive: a verify step reserves pages for the full γ-token draft
        up front, then rolls the rejected tail back here. Each released
        page drops ONE reference, so a tail page shared with the prefix
        cache merely loses this sequence's hold.

        Returns the pages this sequence released (refcount dropped; they
        are back on the free list only if that was the last reference).
        """
        length = self._lengths[seq_id]
        if not 0 <= n_tokens <= length:
            raise ValueError(
                f"cannot truncate sequence {seq_id} ({length} tokens) "
                f"to {n_tokens}"
            )
        table = self._tables[seq_id]
        keep = -(-n_tokens // self.page_size)
        released = table[keep:]
        del table[keep:]
        for p in released:
            self._release(p)
        self._lengths[seq_id] = n_tokens
        return released

    def length(self, seq_id: int) -> int:
        return self._lengths[seq_id]

    def covered_tokens(self, seq_id: int) -> int:
        """KV slots actually writable for this sequence — its page count
        times the page size (≥ ``length``; the page-rounded bound the
        scheduler's speculative write mask is built from)."""
        return len(self._tables[seq_id]) * self.page_size

    def table(self, seq_id: int) -> list[int]:
        return list(self._tables[seq_id])

    def free_sequence(self, seq_id: int) -> None:
        for p in self._tables.pop(seq_id):
            self._release(p)
        del self._lengths[seq_id]

    def check_invariants(self) -> None:
        """Raise RuntimeError on any bookkeeping violation: a page both
        free and referenced, a duplicate free-list entry, a table entry
        without a reference, a refcount below what the tables imply, or
        pages leaked/conjured. Cheap (O(pages))."""
        free = self._free
        free_set = set(free)
        if len(free_set) != len(free):
            raise RuntimeError("free list contains duplicate pages")
        if free_set & self._refs.keys():
            raise RuntimeError(
                f"pages both free and referenced: "
                f"{sorted(free_set & self._refs.keys())}"
            )
        if len(free) + len(self._refs) != self.n_pages:
            raise RuntimeError(
                f"page conservation violated: {len(free)} free + "
                f"{len(self._refs)} referenced != {self.n_pages}"
            )
        table_refs: dict[int, int] = {}
        for seq_id, table in self._tables.items():
            if len(set(table)) != len(table):
                raise RuntimeError(f"sequence {seq_id} table has dup pages")
            for p in table:
                table_refs[p] = table_refs.get(p, 0) + 1
        for p, n in table_refs.items():
            if p in free_set:
                raise RuntimeError(f"free page {p} is in a live table")
            if self._refs.get(p, 0) < n:
                raise RuntimeError(
                    f"page {p}: {n} table refs exceed refcount "
                    f"{self._refs.get(p, 0)}"
                )
        for p, r in self._refs.items():
            if r < 1:
                raise RuntimeError(f"page {p} has nonpositive refcount {r}")
            # A page's references are its table memberships plus AT MOST
            # ONE prefix-cache hold; anything beyond is a leak.
            if r > table_refs.get(p, 0) + 1:
                raise RuntimeError(
                    f"page {p}: refcount {r} exceeds "
                    f"{table_refs.get(p, 0)} table refs + 1 cache ref "
                    "(leaked reference)"
                )
        for p, n in self._swap_pins.items():
            if n < 1:
                raise RuntimeError(f"page {p} has nonpositive swap pin {n}")
            if p not in self._refs:
                raise RuntimeError(
                    f"page {p} swap-pinned but not referenced "
                    "(in-flight swap against a freed page)"
                )

    def table_array(self, seq_ids: list[int], max_pages: int) -> np.ndarray:
        """Batched page table [B, max_pages], -1-padded, for the kernel."""
        out = np.full((len(seq_ids), max_pages), -1, np.int32)
        for i, sid in enumerate(seq_ids):
            t = self._tables[sid]
            if len(t) > max_pages:
                raise ValueError(
                    f"sequence {sid} spans {len(t)} pages > {max_pages}"
                )
            out[i, : len(t)] = t
        return out


def init_page_pool(
    layout: PagedCacheLayout,
    *,
    device: torch.device,
    dtype: torch.dtype | None = None,
    kv_dtype: str = "",
) -> dict[str, torch.Tensor]:
    """Zeroed device page pool ``{"k", "v": [L, n_pages, Hkv, page, D]}``
    (per-layer stacked, heads-major pages).

    ``kv_dtype="int8"``: int8 K/V pages plus f32 scale pages
    ``{"ks", "vs": [L, n_pages, Hkv, page, 1]}`` — the paged counterpart
    of the dense int8 cache (``models/transformer.py:init_cache``); the
    presence of ``"ks"`` marks a quantized pool. ``dtype`` defaults to
    bf16."""
    import torch

    from adversarial_spec_tpu_torch.models.transformer import check_kv_dtype

    dtype = torch.bfloat16 if dtype is None else dtype
    shape = (
        layout.n_layers,
        layout.n_pages,
        layout.n_kv_heads,
        layout.page_size,
        layout.head_dim,
    )
    if check_kv_dtype(kv_dtype):
        sshape = shape[:-1] + (1,)
        return {
            "k": torch.zeros(shape, dtype=torch.int8, device=device),
            "v": torch.zeros(shape, dtype=torch.int8, device=device),
            "ks": torch.zeros(sshape, dtype=torch.float32, device=device),
            "vs": torch.zeros(sshape, dtype=torch.float32, device=device),
        }
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
    }


def _index(ids, device: torch.device) -> torch.Tensor:
    import torch

    return torch.as_tensor(np.asarray(ids), device=device).reshape(-1).long()


def write_tokens(
    pool: dict[str, torch.Tensor],
    k_new: torch.Tensor,  # [L, B, Hkv, S, D] — heads-major cache layout
    v_new: torch.Tensor,
    page_ids,  # [B, S] physical page per token (array-like)
    offsets,  # [B, S] slot within page per token
    ks_new: torch.Tensor | None = None,  # [L, B, Hkv, S, 1] (int8 pools)
    vs_new: torch.Tensor | None = None,
) -> dict[str, torch.Tensor]:
    """Scatter freshly computed K/V into their pages, IN PLACE; returns
    ``pool``. ``pool[l, pid[n], :, off[n]] = new[n, l]`` for every layer
    and token: the advanced indices at dims 1 and 3 are separated by the
    head slice, so the token axis leads the update (built token-major).
    A quantized pool takes the matching scale slices too (both or
    neither), in the dense int8 cache's layout."""
    L, B, H, S, D = k_new.shape
    dev = pool["k"].device
    pid, off = _index(page_ids, dev), _index(offsets, dev)
    new = {"k": k_new, "v": v_new}
    if "ks" in pool:
        if ks_new is None or vs_new is None:
            raise ValueError("quantized pool requires ks_new/vs_new scale slices")
        new.update(ks=ks_new, vs=vs_new)

    def flat(x):  # [L, B, H, S, X] → [B*S, L, H, X]
        return x.permute(1, 3, 0, 2, 4).reshape(B * S, L, H, x.shape[-1])

    for name, x in new.items():
        pool[name][:, pid, :, off] = flat(x).to(pool[name].dtype)
    return pool


def read_tokens(
    pool: dict[str, torch.Tensor],
    page_ids,  # [B, S] physical page per token
    offsets,  # [B, S] slot within page per token
) -> dict[str, torch.Tensor]:
    """Gather per-token K/V (and an int8 pool's scales) back out of their
    pages: the exact inverse of ``write_tokens``, in the dense-cache layout
    [L, B, Hkv, S, D|1] (new tensors). Materializes a cached prefix into a
    fresh admission's dense prefill cache (engine/scheduler.py)."""
    B, S = np.asarray(page_ids).shape
    dev = pool["k"].device
    pid, off = _index(page_ids, dev), _index(offsets, dev)

    def gather(x):  # → [B*S, L, H, D] → [L, B, H, S, D]
        g = x[:, pid, :, off]
        L, H = x.shape[0], x.shape[2]
        return g.reshape(B, S, L, H, x.shape[-1]).permute(2, 0, 3, 1, 4)

    return {k: gather(v) for k, v in pool.items()}
