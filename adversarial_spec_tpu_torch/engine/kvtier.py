"""Tiered KV cache: host-RAM offload + persistent content-addressed store.

Counterpart of ``adversarial_spec_tpu/engine/kvtier.py``: the same tier
state machine, config, stats, invariants and quarantine rules, and the
same on-disk entry format. Payloads are dicts of torch tensors (on the
CPU; the batcher's demotion copies land in pinned host buffers): the disk
store writes a tensor's raw bytes under numpy's dtype name (``bfloat16``
for bf16) and reads entries back as CPU tensors, so an entry this module
writes is byte-identical to the reference's for the same chain, tokens
and payload, and each package reads the other's files, without
``ml_dtypes``.

The fleet's handoff publication and prefetch (``publish_chains``,
``prefetch_chains``) wait for the fleet (ROADMAP A.10).

The reference's description of the module:

The device page pool (engine/kvcache.py) is tier 0 and dies twice over:
LRU pressure evicts a prefix block's page and the next admission re-pays
its prefill, and a process restart re-pays prefill for every hot system
prompt/spec document. Debate workloads are worst-case — every round
shares a giant document prefix across many opponents. This module adds
the two tiers below the pool:

- **Tier 1 — host RAM** (:class:`HostTier`): when the prefix cache
  LRU-evicts a leaf block, its KV pages demote to host buffers. The
  device→host copy is started at evict time (``copy_to_host_async``
  discipline — the scheduler passes a LAZY materializer, so the fetch
  resolves off the hot path) and the block re-promotes into a later
  admission's pages with an async ``device_put`` that overlaps the
  delta prefill. Bounded by ``--kv-host-mb``; LRU overflow spills to
  tier 2 (or drops when no store is armed).
- **Tier 2 — disk** (:class:`DiskStore`): a content-addressed store
  keyed by the radix block's CHAIN HASH (parent chain + block tokens —
  the same identity the radix trie realizes through dict hashing) plus
  a model/config fingerprint. Versioned header, atomic rename writes,
  sha-verified payloads, corrupt-entry quarantine. A restarted process
  — or a fleet with overlapping prompts — rehydrates hot prefixes
  instead of re-prefilling. Inserted blocks write through to the store
  (queued; flushed at drain end, off the serving path), so restart
  rehydration does not depend on eviction pressure ever having fired.

The tier state machine (every demoted block ends in EXACTLY ONE of
re-promote / spill / host-free; a consumed disk entry stays resident for
the next restart) is host-side and content-free, so the mock engine
drives the same machine deterministically on CPU with ``payload=None``
— hit ratios, swap counts, and SwapEvents pin in tier-1 without a TPU.

Process-wide config + stats follow the ``procconfig`` pattern shared
with ``interleave``/``spec``/``prefix_cache``: the CLI arms per round
(``--kv-host-mb``, ``--kv-store-dir``, ``--kv-flush-blocks``,
``--no-kv-tier``; env ``ADVSPEC_KV_HOST_MB`` / ``ADVSPEC_KV_STORE_DIR``
/ ``ADVSPEC_KV_FLUSH_BLOCKS`` / ``ADVSPEC_KV_TIER``) and snapshots into
``perf.kv_tier``. Imports no jax.
"""

from __future__ import annotations

import hashlib
import itertools
import json
import os
import threading
import time
import weakref
from dataclasses import dataclass, field

import numpy as np
import torch

from adversarial_spec_tpu_torch import obs as obs_mod
from adversarial_spec_tpu_torch.engine import procconfig
from adversarial_spec_tpu_torch.resilience import lockdep as lockdep_mod

DEFAULT_HOST_MB = 256

# -- config + stats ---------------------------------------------------------


@dataclass
class TierConfig:
    """Process-wide knobs, set once per CLI round (or by tests)."""

    enabled: bool = True
    # Host-RAM tier budget in MiB (0 disables tier 1).
    host_mb: int = DEFAULT_HOST_MB
    # Disk-store root directory ("" disables tier 2).
    store_dir: str = ""
    # Write-through flush threshold: flush the pending disk queue every
    # N queued blocks (0 = only at drain-end settle()). Mid-drain
    # flushes write ONLY already-resolved payloads — an unresolved lazy
    # materializer stays queued, so the no-sync-on-hot-path discipline
    # holds. Armed for cross-replica handoff (fleet disaggregation):
    # a decode replica can only adopt blocks that reached the shared
    # store before the drain ended.
    flush_blocks: int = 0


def env_enabled() -> bool:
    """The process default for the master switch (``ADVSPEC_KV_TIER``)."""
    return os.environ.get("ADVSPEC_KV_TIER", "1") != "0"


def env_host_mb() -> int:
    """The process default host budget (``ADVSPEC_KV_HOST_MB``)."""
    try:
        return max(0, int(os.environ.get("ADVSPEC_KV_HOST_MB", DEFAULT_HOST_MB)))
    except ValueError:
        return DEFAULT_HOST_MB


def env_store_dir() -> str:
    """The process default store root (``ADVSPEC_KV_STORE_DIR``)."""
    return os.environ.get("ADVSPEC_KV_STORE_DIR", "") or ""


def env_flush_blocks() -> int:
    """The process default flush threshold (``ADVSPEC_KV_FLUSH_BLOCKS``)."""
    try:
        return max(0, int(os.environ.get("ADVSPEC_KV_FLUSH_BLOCKS", "0")))
    except ValueError:
        return 0


@dataclass
class TierStats(procconfig.StatsBase):
    """Process-wide tier counters, aggregated across every batcher (and
    the mock engine's deterministic accounting).

    ``tier_lookups`` counts radix lookups that CONTINUED past the device
    tier (the prefix cache had tiers attached), so the per-tier hit
    rates measure how often the lower tiers rescued a device miss.
    Promotion (host→device) and rehydration (disk→device) are counted
    separately: the first is the pressure-thrash save, the second the
    restart/fleet save. ``recomputed_blocks`` counts promotions that
    LOST THE RACE (entry evicted/corrupt between lookup and promotion)
    and fell back to prefill — the correctness escape hatch, visible so
    a noisy store shows up in telemetry rather than as silent slowness.
    """

    tier_lookups: int = 0
    host_hits: int = 0  # lookups that matched >= 1 host-resident block
    disk_hits: int = 0  # lookups that matched >= 1 disk-resident block
    demoted_blocks: int = 0
    demoted_tokens: int = 0
    promoted_blocks: int = 0  # host -> device re-promotions
    promoted_tokens: int = 0
    rehydrated_blocks: int = 0  # disk -> device rehydrations
    rehydrated_tokens: int = 0
    recomputed_blocks: int = 0  # promotions lost the race -> prefilled
    spilled_blocks: int = 0  # host LRU overflow written through to disk
    host_freed_blocks: int = 0  # host LRU overflow dropped (no store)
    store_writes: int = 0
    store_corrupt: int = 0  # quarantined disk entries
    swap_in_s: float = 0.0  # promotion/rehydration wall (host+disk -> dev)
    swap_out_s: float = 0.0  # demotion/spill/store wall

    def record_lookup(self, host_blocks: int, disk_blocks: int) -> None:
        self.tier_lookups += 1
        if host_blocks:
            self.host_hits += 1
        if disk_blocks:
            self.disk_hits += 1
        if obs_mod.config().enabled:
            obs_mod.hot.tier_hit_ratio("host").set(
                round(self.host_hits / self.tier_lookups, 6)
            )
            obs_mod.hot.tier_hit_ratio("disk").set(
                round(self.disk_hits / self.tier_lookups, 6)
            )

    def snapshot(self) -> dict:
        out = self.as_dict()
        out["host_hit_rate"] = (
            round(self.host_hits / self.tier_lookups, 4)
            if self.tier_lookups
            else 0.0
        )
        out["disk_hit_rate"] = (
            round(self.disk_hits / self.tier_lookups, 4)
            if self.tier_lookups
            else 0.0
        )
        return out


_state = procconfig.ProcState(
    TierConfig(
        enabled=env_enabled(),
        host_mb=env_host_mb(),
        store_dir=env_store_dir(),
        flush_blocks=env_flush_blocks(),
    ),
    TierStats(),
    coerce={
        "host_mb": lambda v: max(0, int(v)),
        "flush_blocks": lambda v: max(0, int(v)),
    },
)
_config = _state.config
stats = _state.stats


def config() -> TierConfig:
    return _state.config


def configure(
    enabled: bool | None = None,
    host_mb: int | None = None,
    store_dir: str | None = None,
    flush_blocks: int | None = None,
) -> TierConfig:
    return _state.configure(
        enabled=enabled,
        host_mb=host_mb,
        store_dir=store_dir,
        flush_blocks=flush_blocks,
    )


def reset_stats() -> None:
    _state.reset_stats()


def snapshot() -> dict:
    """Stats + config, the ``perf.kv_tier`` payload."""
    return _state.snapshot()


def armed() -> bool:
    """True when the process config arms at least one lower tier."""
    return _config.enabled and (_config.host_mb > 0 or bool(_config.store_dir))


# -- content addressing -----------------------------------------------------


def chain_hash(parent: str, tokens) -> str:
    """Content address of one radix block: the chain ``(parent chain,
    block tokens)`` — the same identity the trie realizes through dict
    hashing, made stable across processes (the disk store's key).
    Tokens may be ints (real engines) or strings (the mock's 4-char
    chunks); both serialize through ``str``."""
    h = hashlib.sha256()
    h.update(parent.encode("ascii"))
    h.update(b"\x00")
    for t in tokens:
        h.update(str(t).encode("utf-8"))
        h.update(b"\x1f")
    return h.hexdigest()


def fingerprint(*parts) -> str:
    """Model/config fingerprint for the disk store: KV produced under a
    different model, dtype, page size, or layout must never rehydrate —
    the parts hash into the store's namespace directory."""
    h = hashlib.sha256()
    h.update(json.dumps([str(p) for p in parts]).encode("utf-8"))
    return h.hexdigest()[:16]


# -- tier 1: host RAM -------------------------------------------------------


@dataclass
class HostBlock:
    chain: str
    tokens: tuple
    # None (mock accounting), a dict of np arrays, or a ZERO-ARG LAZY
    # MATERIALIZER (the scheduler's demotion fetch: the device->host
    # copy was started at evict time; calling the closure resolves it —
    # free once the async copy has landed).
    payload: object
    n_tokens: int
    last_used: int = 0


class HostTier:
    """Bounded LRU of demoted KV blocks in host RAM.

    Capacity is byte-budgeted (``capacity_bytes`` / ``block_bytes`` —
    the owner computes bytes-per-block from the pool layout; the mock
    passes a nominal figure). The conservation invariant the chaos
    tests pin: every block ever demoted ends in EXACTLY ONE of
    resident / promoted / spilled / freed — ``check_invariants``
    raises on any bookkeeping drift."""

    def __init__(self, capacity_bytes: int, block_bytes: int):
        self.capacity_bytes = max(0, int(capacity_bytes))
        self.block_bytes = max(1, int(block_bytes))
        self._blocks: dict[str, HostBlock] = {}
        self._clock = 0
        # Conservation counters (lifetime, for check_invariants).
        self.demoted = 0
        self.promoted = 0
        self.spilled = 0
        self.freed = 0

    @property
    def resident_blocks(self) -> int:
        return len(self._blocks)

    @property
    def resident_bytes(self) -> int:
        return len(self._blocks) * self.block_bytes

    def put(self, chain: str, tokens, payload) -> list[HostBlock]:
        """Demote one block; returns the LRU blocks evicted to make
        room (the caller spills them to disk or frees them)."""
        self._clock += 1
        old = self._blocks.pop(chain, None)
        if old is not None:
            # Re-demotion of a chain already resident: the old copy is
            # replaced (content-identical by construction) — account it
            # freed so conservation holds.
            self.freed += 1
        self.demoted += 1
        self._blocks[chain] = HostBlock(
            chain=chain,
            tokens=tuple(tokens),
            payload=payload,
            n_tokens=len(tokens),
            last_used=self._clock,
        )
        evicted: list[HostBlock] = []
        while (
            self.resident_bytes > self.capacity_bytes
            and len(self._blocks) > 1
        ):
            lru = min(self._blocks.values(), key=lambda b: b.last_used)
            evicted.append(self._blocks.pop(lru.chain))
        if self.resident_bytes > self.capacity_bytes:
            # A single block over budget: nothing to keep.
            evicted.extend(self._blocks.values())
            self._blocks.clear()
        return evicted

    def get(self, chain: str) -> HostBlock | None:
        b = self._blocks.get(chain)
        if b is not None:
            self._clock += 1
            b.last_used = self._clock
        return b

    def take_promoted(self, chain: str) -> HostBlock | None:
        """Remove a block the caller just re-promoted into the device
        pool (terminal state: promoted). Called AFTER the device write
        lands, so a fault mid-promotion leaves the block resident —
        the tier is never corrupted by an aborted swap."""
        b = self._blocks.pop(chain, None)
        if b is not None:
            self.promoted += 1
        return b

    def note_spilled(self, n: int = 1) -> None:
        self.spilled += n

    def note_freed(self, n: int = 1) -> None:
        self.freed += n

    @staticmethod
    def materialize(block: HostBlock):
        """Resolve a lazy payload in place (the demotion fetch closure
        — by promotion/spill time the async copy has landed, so this is
        a free host read, not a device sync)."""
        if callable(block.payload):
            block.payload = block.payload()
        return block.payload

    def clear(self) -> None:
        self.freed += len(self._blocks)
        self._blocks.clear()

    def check_invariants(self) -> None:
        """Raise RuntimeError on bookkeeping drift: byte accounting,
        duplicate identity, or conservation (demoted blocks must all be
        accounted resident/promoted/spilled/freed)."""
        if len({b.chain for b in self._blocks.values()}) != len(self._blocks):
            raise RuntimeError("host tier holds duplicate chains")
        for chain, b in self._blocks.items():
            if b.chain != chain:
                raise RuntimeError(
                    f"host tier key {chain} holds block {b.chain}"
                )
        accounted = (
            len(self._blocks) + self.promoted + self.spilled + self.freed
        )
        if accounted != self.demoted:
            raise RuntimeError(
                f"host tier conservation violated: {self.demoted} demoted "
                f"!= {len(self._blocks)} resident + {self.promoted} "
                f"promoted + {self.spilled} spilled + {self.freed} freed"
            )


# -- tier 2: disk -----------------------------------------------------------

_MAGIC = b"ADVSPECKV"
_VERSION = 1


# Payload dtypes by the names numpy gives them (the entry header's
# ``dtype`` field): ``bfloat16`` is the name ``ml_dtypes`` gives numpy's
# bf16, so an entry either package writes names its dtype the same way.
_DTYPES = {
    "float32": torch.float32,
    "float16": torch.float16,
    "bfloat16": torch.bfloat16,
    "float64": torch.float64,
    "int8": torch.int8,
    "uint8": torch.uint8,
    "int16": torch.int16,
    "int32": torch.int32,
    "int64": torch.int64,
    "bool": torch.bool,
}
_NAMES = {v: k for k, v in _DTYPES.items()}


def _payload_array(value) -> tuple[str, list[int], bytes]:
    """(dtype name, shape, raw bytes) of one payload array: a torch
    tensor (any device; bf16 through its 16-bit view, since numpy has no
    bf16) or a numpy array."""
    if isinstance(value, torch.Tensor):
        t = value.detach().to("cpu").contiguous()
        if t.dtype not in _NAMES:
            raise TypeError(f"unsupported payload dtype {t.dtype}")
        raw = t.reshape(-1).view(torch.uint8).numpy().tobytes()
        return _NAMES[t.dtype], list(t.shape), raw
    arr = np.ascontiguousarray(value)
    return str(arr.dtype), list(arr.shape), arr.tobytes()


def _tensor_from(raw: bytes, name: str, shape: list[int]) -> torch.Tensor:
    """A CPU tensor of dtype ``name`` over a copy of ``raw`` (bytes
    reinterpreted through a uint8 view: a bf16 payload reads back as
    ``torch.bfloat16`` without ``ml_dtypes``). An unknown name raises
    ``TypeError`` (the entry quarantines)."""
    if name not in _DTYPES:
        raise TypeError(f"unsupported payload dtype {name!r}")
    flat = torch.from_numpy(np.frombuffer(raw, np.uint8).copy())
    try:
        return flat.view(_DTYPES[name]).reshape(shape)
    except RuntimeError as e:  # size/shape disagreement: a bad entry
        raise ValueError(str(e)) from None


class DiskStore:
    """Content-addressed on-disk KV block store (tier 2).

    Layout: ``<root>/<fingerprint>/<chain[:2]>/<chain>.kvb`` — the
    fingerprint namespaces by model/config so incompatible KV can never
    rehydrate. Entries are written to a temp name then ``os.replace``d
    (atomic on POSIX): a crashed writer leaves a ``.tmp`` orphan, never
    a torn entry. Every read verifies magic, version, fingerprint,
    chain, token content, and the payload sha; ANY failure quarantines
    the file (moved aside, counted) and reads as a miss — a corrupt
    entry costs one re-prefill, not a wrong transcript."""

    def __init__(self, root: str, fingerprint: str):
        self.root = root
        self.fingerprint = fingerprint
        self.dir = os.path.join(root, fingerprint)
        self.quarantine_dir = os.path.join(self.dir, "quarantine")
        os.makedirs(self.dir, exist_ok=True)
        # Serializes the replace-and-count section of put() across
        # THREADS sharing this instance; concurrent PROCESSES (fleet
        # replicas sharing one store dir) are already safe — each
        # writes a unique temp name and the replaces are atomic, so
        # the last identical copy wins and every instance's resident
        # count stays consistent with its own scan.
        self._put_lock = lockdep_mod.make_lock("DiskStore._put_lock")
        self._tmp_seq = itertools.count()
        self._resident = self._scan()

    def _scan(self) -> int:
        n = 0
        for sub in os.listdir(self.dir):
            p = os.path.join(self.dir, sub)
            if len(sub) == 2 and os.path.isdir(p):
                n += sum(1 for f in os.listdir(p) if f.endswith(".kvb"))
        return n

    @property
    def resident_entries(self) -> int:
        return self._resident

    def _path(self, chain: str) -> str:
        return os.path.join(self.dir, chain[:2], f"{chain}.kvb")

    def has(self, chain: str) -> bool:
        return os.path.exists(self._path(chain))

    def put(self, chain: str, tokens, payload: dict | None) -> bool:
        """Write one entry (idempotent: content-addressed, an existing
        entry is left alone). Returns True when a new entry landed."""
        path = self._path(chain)
        if os.path.exists(path):
            return False
        blobs: list[bytes] = []
        arrays = []
        if payload is not None:
            for name in sorted(payload):
                dtype, shape, raw = _payload_array(payload[name])
                arrays.append(
                    {
                        "name": name,
                        "dtype": dtype,
                        "shape": shape,
                        "nbytes": len(raw),
                    }
                )
                blobs.append(raw)
        body = b"".join(blobs)
        header = json.dumps(
            {
                "fp": self.fingerprint,
                "chain": chain,
                "tokens": [
                    t if isinstance(t, (int, str)) else str(t)
                    for t in tokens
                ],
                "payload": payload is not None,
                "arrays": arrays,
                "sha": hashlib.sha256(body).hexdigest(),
            },
            separators=(",", ":"),
        ).encode("utf-8")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        # The temp name is unique per (process, thread, call): two
        # concurrent writers of the SAME chain — two fleet replicas
        # writing through one store, or two threads of one engine —
        # must never interleave bytes into one temp file. Both finish
        # a complete, identical entry and both os.replace atomically;
        # the second replace installs identical content over the
        # first, so the store ends with exactly one valid entry and
        # no torn/quarantinable state.
        tmp = (
            f"{path}.{os.getpid()}.{threading.get_ident()}"
            f".{next(self._tmp_seq)}.tmp"
        )
        with open(tmp, "wb") as f:
            f.write(_MAGIC)
            f.write(bytes([_VERSION]))
            f.write(len(header).to_bytes(4, "little"))
            f.write(header)
            f.write(body)
        with self._put_lock:
            # Lost the race to a sibling thread: its entry already
            # landed and was counted — replacing with identical bytes
            # is harmless, but counting twice would drift the resident
            # ledger off the on-disk scan.
            existed = os.path.exists(path)
            os.replace(tmp, path)
            if existed:
                return False
            self._resident += 1
        return True

    def _quarantine(self, chain: str, reason: str) -> None:
        """Move a bad entry aside (never delete — it is evidence) and
        count it; the store keeps serving everything else."""
        path = self._path(chain)
        try:
            os.makedirs(self.quarantine_dir, exist_ok=True)
            os.replace(
                path, os.path.join(self.quarantine_dir, f"{chain}.kvb")
            )
            with self._put_lock:
                self._resident = max(0, self._resident - 1)
        except OSError:
            pass
        stats.store_corrupt += 1
        with self._put_lock:
            resident = self._resident
        obs_mod.emit(
            obs_mod.SwapEvent(
                op="quarantine",
                tier="disk",
                blocks=1,
                disk_resident=resident,
            )
        )

    def get(self, chain: str, tokens=None) -> tuple[tuple, dict | None] | None:
        """Read + fully verify one entry; ``tokens`` (when given) must
        match the stored block content. None = miss (absent or
        quarantined just now)."""
        path = self._path(chain)
        if not os.path.exists(path):
            return None
        try:
            with open(path, "rb") as f:
                if f.read(len(_MAGIC)) != _MAGIC:
                    raise ValueError("bad magic")
                version = f.read(1)
                if version != bytes([_VERSION]):
                    raise ValueError(f"unsupported version {version!r}")
                hlen = int.from_bytes(f.read(4), "little")
                if not 0 < hlen <= 1 << 24:
                    raise ValueError("implausible header length")
                header = json.loads(f.read(hlen).decode("utf-8"))
                if header.get("fp") != self.fingerprint:
                    raise ValueError("fingerprint mismatch")
                if header.get("chain") != chain:
                    raise ValueError("chain mismatch")
                stored = tuple(header.get("tokens", ()))
                if tokens is not None and stored != tuple(tokens):
                    raise ValueError("token content mismatch")
                body = f.read()
            if hashlib.sha256(body).hexdigest() != header.get("sha"):
                raise ValueError("payload sha mismatch")
            if not header.get("payload"):
                return stored, None
            payload: dict = {}
            off = 0
            for spec in header["arrays"]:
                raw = body[off : off + spec["nbytes"]]
                if len(raw) != spec["nbytes"]:
                    raise ValueError("truncated payload")
                payload[spec["name"]] = _tensor_from(
                    raw, spec["dtype"], spec["shape"]
                )
                off += spec["nbytes"]
            if off != len(body):
                raise ValueError("trailing payload bytes")
            return stored, payload
        except (ValueError, KeyError, TypeError, json.JSONDecodeError, OSError) as e:
            self._quarantine(chain, str(e))
            return None


# -- the composed store -----------------------------------------------------


@dataclass
class TierHit:
    """One lower-tier block a tiered lookup matched, promotable into
    the admission being set up."""

    chain: str
    tokens: tuple
    source: str  # "host" | "disk"
    block: HostBlock | None = None  # host hits carry the entry


@dataclass
class _PendingStore:
    chain: str
    tokens: tuple
    payload: object  # dict | lazy materializer | None


# Outstanding LAZY payloads (each pinning one gathered device array)
# are bounded: past this many, the OLDEST resolve eagerly — their
# async copies landed long ago, so the fetch is a free host read, and
# the device memory demotion exists to relieve actually releases
# while pressure is still on.
_LAZY_RESOLVE_AFTER = 32


class TieredStore:
    """Tier 1 + tier 2 behind one interface; owns the swap stats and
    SwapEvent emission so the scheduler and the mock engine share one
    state machine (and one telemetry schema)."""

    def __init__(
        self,
        host: HostTier | None,
        disk: DiskStore | None,
        *,
        stats: TierStats | None = None,
    ):
        from collections import deque

        self.host = host
        self.disk = disk
        self.stats = stats if stats is not None else globals()["stats"]
        # Disk write-through queue, keyed by chain (content-addressed:
        # one pending write per block). File I/O happens at settle().
        self._pending: dict[str, _PendingStore] = {}
        # Holders (HostBlock / _PendingStore) whose payload is still a
        # lazy device-array materializer, oldest first.
        self._lazy = deque()

    def _note_lazy(self, holder) -> None:
        self._lazy.append(holder)
        while len(self._lazy) > _LAZY_RESOLVE_AFTER:
            h = self._lazy.popleft()
            if callable(h.payload):
                h.payload = h.payload()

    @property
    def host_resident(self) -> int:
        return self.host.resident_blocks if self.host is not None else 0

    @property
    def disk_resident(self) -> int:
        return self.disk.resident_entries if self.disk is not None else 0

    def _emit(self, op: str, tier: str, blocks: int, tokens: int, slot: int = -1) -> None:
        obs_mod.emit(
            obs_mod.SwapEvent(
                op=op,
                tier=tier,
                blocks=blocks,
                tokens=tokens,
                slot=slot,
                host_resident=self.host_resident,
                disk_resident=self.disk_resident,
            )
        )

    def _spill(self, evicted: list[HostBlock]) -> None:
        """Host LRU overflow: queue for disk write-through when a store
        is armed (terminal state: spilled; the file lands at settle —
        I/O never rides the serving path), else drop (freed). The
        evicted block is the LRU — its demotion copy resolved long ago,
        so materializing here is a free host read, and resolving now
        releases the gathered device array."""
        for b in evicted:
            if self.disk is not None:
                t0 = time.monotonic()
                payload = HostTier.materialize(b)
                self.host.note_spilled()
                self.stats.spilled_blocks += 1
                self.stats.swap_out_s += time.monotonic() - t0
                self.enqueue_store(b.chain, b.tokens, payload)
                self._emit("spill", "disk", 1, b.n_tokens)
            else:
                self.host.note_freed()
                self.stats.host_freed_blocks += 1
                self._emit("free", "host", 1, b.n_tokens)

    def demote(self, chain: str, tokens, payload, slot: int = -1) -> None:
        """One LRU-evicted radix block enters the lower tiers. Spill
        wall accumulates inside ``_spill`` — the demote window here is
        measured BEFORE spilling so ``swap_out_s`` never counts the
        same seconds twice."""
        t0 = time.monotonic()
        self.stats.demoted_blocks += 1
        self.stats.demoted_tokens += len(tokens)
        evicted: list[HostBlock] = []
        if self.host is not None:
            evicted = self.host.put(chain, tokens, payload)
            blk = self.host._blocks.get(chain)
            # blk is None when the block alone exceeds the host budget
            # (put's over-budget branch evicted it straight into
            # ``evicted``) — it spills/frees below like any other LRU
            # victim instead of being tracked as resident.
            if blk is not None and callable(payload):
                self._note_lazy(blk)
            self._emit("demote", "host", 1, len(tokens), slot)
        elif self.disk is not None:
            # Disk-only tiering: queue the write (the payload stays a
            # lazy handle — the gather was dispatched microseconds ago
            # and resolving it HERE would be a genuine host sync on
            # the serving path; settle resolves it off the hot path).
            self.enqueue_store(chain, tokens, payload)
            self._emit("demote", "disk", 1, len(tokens), slot)
        dt = time.monotonic() - t0
        self.stats.swap_out_s += dt
        if obs_mod.config().enabled:
            obs_mod.hot.swap_latency("out").observe(dt)
        if evicted:
            self._spill(evicted)

    def lookup_chain(self, chain: str, tokens) -> TierHit | None:
        """Host first (cheaper, warmer), then the disk tier — existence
        only; payload reads happen at promotion (``materialize``). A
        block queued for write-through but not yet flushed counts as
        disk-resident (the pending entry serves it)."""
        if self.host is not None:
            b = self.host.get(chain)
            if b is not None:
                return TierHit(
                    chain=chain, tokens=tuple(tokens), source="host", block=b
                )
        if self.disk is not None and (
            chain in self._pending or self.disk.has(chain)
        ):
            return TierHit(chain=chain, tokens=tuple(tokens), source="disk")
        return None

    def record_lookup(self, hits: list[TierHit]) -> None:
        self.stats.record_lookup(
            sum(1 for h in hits if h.source == "host"),
            sum(1 for h in hits if h.source == "disk"),
        )

    def materialize(self, hit: TierHit) -> tuple[bool, dict | None]:
        """Resolve a hit's payload for promotion. ``(False, None)``
        means the promotion LOST THE RACE (entry evicted, quarantined,
        or content mismatch since lookup) — the caller falls back to
        recomputing the block via plain prefill."""
        if hit.source == "host":
            b = (
                self.host.get(hit.chain) if self.host is not None else None
            )
            if b is None:
                self.stats.recomputed_blocks += 1
                return False, None
            return True, HostTier.materialize(b)
        p = self._pending.get(hit.chain)
        if p is not None:
            if callable(p.payload):
                p.payload = p.payload()
            return True, p.payload
        entry = self.disk.get(hit.chain, hit.tokens) if self.disk else None
        if entry is None:
            self.stats.recomputed_blocks += 1
            return False, None
        return True, entry[1]

    def consume(self, hit: TierHit, slot: int = -1, wall_s: float = 0.0) -> None:
        """The hit's KV landed in the device pool: finalize its state.
        Host entries leave the tier (terminal: promoted); disk entries
        STAY — the store is the persistent tier, and this block's next
        reader may be a restarted process."""
        n = len(hit.tokens)
        self.stats.swap_in_s += wall_s
        if hit.source == "host":
            self.host.take_promoted(hit.chain)
            self.stats.promoted_blocks += 1
            self.stats.promoted_tokens += n
            self._emit("promote", "host", 1, n, slot)
        else:
            self.stats.rehydrated_blocks += 1
            self.stats.rehydrated_tokens += n
            self._emit("rehydrate", "disk", 1, n, slot)
        if obs_mod.config().enabled and wall_s > 0.0:
            obs_mod.hot.swap_latency("in").observe(wall_s)

    def needs_store(self, chain: str) -> bool:
        """Would ``enqueue_store`` actually queue this chain? Callers
        whose payload fetch is EXPENSIVE (the scheduler's device
        gather) check this first so an already-stored/already-queued
        block never pays a discarded gather."""
        return (
            self.disk is not None
            and chain not in self._pending
            and not self.disk.has(chain)
        )

    def enqueue_store(self, chain: str, tokens, payload) -> None:
        """Queue one block for disk write-through (content-addressed:
        already-stored and already-queued chains are no-ops). Flushed by
        ``settle()`` at drain end — and, when ``flush_blocks`` arms the
        write-through threshold, every N queued blocks mid-drain (the
        fleet-handoff publication window). Threshold flushes write only
        ALREADY-RESOLVED payloads, so file I/O rides the serving path
        but a device sync never does."""
        if (
            self.disk is None
            or chain in self._pending
            or self.disk.has(chain)
        ):
            return
        entry = _PendingStore(chain, tuple(tokens), payload)
        self._pending[chain] = entry
        if callable(payload):
            self._note_lazy(entry)
        threshold = _config.flush_blocks
        if threshold > 0 and len(self._pending) >= threshold:
            self._flush_pending(force=False)

    def _flush_pending(self, force: bool = True) -> int:
        """Write queued blocks through to the disk store. ``force``
        (settle / handoff publication — the sanctioned sync points)
        resolves lazy payloads; a threshold flush (``force=False``)
        writes only blocks whose payload is already a plain value and
        leaves unresolved lazies queued — the serving path never pays a
        device sync for write-through. Returns entries written."""
        wrote = 0
        wrote_tokens = 0
        t0 = time.monotonic()
        pending = self._pending
        self._pending = {}
        if force:
            self._lazy.clear()
        for chain, p in pending.items():
            if not force and callable(p.payload):
                # Unresolved lazy: stays queued (and stays in _lazy —
                # the bounded resolve keeps draining it off-threshold).
                self._pending[chain] = p
                continue
            payload = p.payload() if callable(p.payload) else p.payload
            if self.disk is not None and self.disk.put(
                p.chain, p.tokens, payload
            ):
                wrote += 1
                wrote_tokens += len(p.tokens)
        if wrote:
            self.stats.store_writes += wrote
            self.stats.swap_out_s += time.monotonic() - t0
            self._emit("store", "disk", wrote, wrote_tokens)
        return wrote

    def settle(self) -> int:
        """Flush pending disk writes + resolve lazy host payloads (the
        sanctioned drain-end point: every async device→host copy
        started this drain has long resolved). Returns entries
        written."""
        wrote = self._flush_pending(force=True)
        if self.host is not None:
            for b in list(self.host._blocks.values()):
                HostTier.materialize(b)
        return wrote

    def check_invariants(self) -> None:
        if self.host is not None:
            self.host.check_invariants()
        if self.disk is not None:
            # One-sided on purpose: the store dir may be SHARED across
            # fleet replicas (that is its point — overlapping prefixes
            # rehydrate fleet-wide), so entries legitimately appear
            # that this instance never counted. Tracking MORE than the
            # scan finds is the local bookkeeping bug (double count /
            # phantom entry) this check exists to catch.
            resident = self.disk._scan()
            if resident < self.disk.resident_entries:
                raise RuntimeError(
                    f"disk store count drift: {self.disk.resident_entries} "
                    f"tracked vs {resident} on disk"
                )


class _SlotPayload(dict):
    """A demoted block's payload whose tensors are views of one arena
    slot (a dict subclass, so the arena can watch its lifetime)."""


class DemotionArena:
    """Reused pinned host buffers for the batcher's demotion copies.

    A demoted block's K/V (and an int8 pool's scales) copy device→host
    with ``non_blocking=True``, which is only safe into page-locked
    memory: a pageable destination may be read before the copy lands.
    Fresh page-locked memory is slow to obtain (the host must fault in
    and lock new pages), so the slots come from ONE pinned buffer,
    allocated on the first demotion and reused: ``n_slots`` blocks of
    ``slot_bytes``, sized by the owner from the tier's byte budget. A
    slot returns to the free list when its payload dict is collected
    (the block was promoted, spilled and written, or freed). Every
    write into a slot is a device→host copy on the current stream and
    every device read of one (a promotion) is a host→device copy on the
    same stream, so stream order keeps a reused slot's old reader ahead
    of its new writer; host reads wait on the copy's event first. When
    every slot is held, a block takes a fresh pinned buffer of its own
    (``fresh`` counts them)."""

    ALIGN = 256

    def __init__(self, slot_bytes: int, n_slots: int):
        self.slot_bytes = self._aligned(max(1, int(slot_bytes)))
        self.n_slots = max(0, int(n_slots))
        self._buf: torch.Tensor | None = None
        self._free: list[int] = []
        self.fresh = 0

    @classmethod
    def _aligned(cls, n: int) -> int:
        return -(-n // cls.ALIGN) * cls.ALIGN

    @property
    def nbytes(self) -> int:
        return 0 if self._buf is None else self._buf.numel()

    def payload(self, like: dict) -> dict:
        """A payload dict shaped and typed as ``like`` (name → tensor),
        its tensors views of one pinned slot."""
        if self._buf is None and self.n_slots:
            self._buf = torch.empty(
                self.slot_bytes * self.n_slots, dtype=torch.uint8, pin_memory=True
            )
            self._free = list(range(self.n_slots - 1, -1, -1))
        out = _SlotPayload()
        if self._free:
            i = self._free.pop()
            base = self._buf[i * self.slot_bytes : (i + 1) * self.slot_bytes]
            weakref.finalize(out, self._free.append, i)
        else:
            base = torch.empty(self.slot_bytes, dtype=torch.uint8, pin_memory=True)
            self.fresh += 1
        off = 0
        for name in sorted(like):
            t = like[name]
            n = t.numel() * t.element_size()
            if off + n > base.numel():
                raise ValueError("demotion payload larger than an arena slot")
            out[name] = base[off : off + n].view(t.dtype).view(t.shape)
            off += self._aligned(n)
        return out


def build_for(block_bytes: int, fingerprint_parts: tuple) -> TieredStore | None:
    """A TieredStore per the process config, or None when tiering is
    off. ``block_bytes`` is the host-budget unit (bytes one demoted
    block occupies — pool layout for real engines, nominal for the
    mock); ``fingerprint_parts`` namespace the disk store."""
    cfg = _config
    if not cfg.enabled:
        return None
    host = (
        HostTier(cfg.host_mb << 20, block_bytes) if cfg.host_mb > 0 else None
    )
    disk = (
        DiskStore(cfg.store_dir, fingerprint(*fingerprint_parts))
        if cfg.store_dir
        else None
    )
    if host is None and disk is None:
        return None
    return TieredStore(host, disk)
