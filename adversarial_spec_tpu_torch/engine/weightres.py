"""Opponent-pool weight residency: LRU weight paging over one mesh.

The PyTorch port's copy of ``adversarial_spec_tpu/engine/weightres.py``.

A debate round fans one document out to N *different* opponent models,
but HBM holds few full-precision weight sets: before this module the
engine's only answer to pressure was dropping the LRU model entirely
and re-materializing it from checkpoint on its next turn — the full
conversion/restore cost, once per swap, every round, exactly on the
paper's core workload (parallel multi-model critique). This module is
the kvtier demote/promote pattern applied to PARAMS:

- **Demote** — an evicted model's (typically quantized — int8/int4
  weigh 2-4x less than bf16) shards move to a byte-budgeted host-RAM
  tier instead of being freed; the device→host copies are started
  asynchronously at evict time. The model's batcher (page pool, prefix
  cache) is dropped with the device weights — batcher state is HBM too,
  and an unbounded per-model batcher cache is a leak in a long-lived
  serve daemon.
- **Promote** — a host-resident model re-activates with one
  ``device_put`` of the saved shards into their ORIGINAL shardings
  (the committed-sharding discipline: promoted params present the same
  jit signature as the originals, so re-promotion compiles nothing),
  dispatched asynchronously so the transfer overlaps the CURRENT
  model's decode via the engine's prefetch thread.
- **Coalesce** — the engine serves a round's same-model requests as one
  group and orders groups RESIDENT-FIRST, and the serve daemon's stride
  scheduler pulls same-model units out of a tenant's queue into the
  running dispatch, so a swap happens only after the resident models'
  work is exhausted — a swap is a declared, traced event
  (:class:`~adversarial_spec_tpu_torch.obs.events.WeightEvent`,
  ``advspec_weight_resident_models``,
  ``advspec_weight_swap_seconds{direction}``), never an inferred one.

The ledger here is the state machine (every model admitted to the
device tier ends in EXACTLY ONE of resident / host / freed — the
conservation invariant ``check_invariants`` raises on) and is
deliberately jax-free and clock-free: payloads are opaque holders the
TPU engine fills with host arrays (``None`` for the mock engine, which
drives the same machine deterministically with synthetic byte counts
and synthetic walls), and every wall second is PASSED IN by the caller,
so mock residency telemetry pins byte-identically on CPU.

Process-wide config + stats follow the ``procconfig`` pattern shared
with ``interleave``/``spec``/``prefix_cache``/``kvtier``: the CLI arms
per round (``--weight-res/--no-weight-res``, ``--weight-host-mb``; env
``ADVSPEC_WEIGHT_RES`` / ``ADVSPEC_WEIGHT_HOST_MB``) and snapshots into
``perf.weights``.
"""

from __future__ import annotations

import os
import threading
from dataclasses import dataclass

from adversarial_spec_tpu_torch import obs as obs_mod
from adversarial_spec_tpu_torch.engine import procconfig
from adversarial_spec_tpu_torch.resilience import lockdep as lockdep_mod

DEFAULT_HOST_MB = 2048

# -- config + stats ---------------------------------------------------------


@dataclass
class WeightResConfig:
    """Process-wide knobs, set once per CLI round (or by tests)."""

    # Master switch: off = evictions FREE the weights (naive
    # evict-reload — the bench's control arm), on = evictions demote to
    # the host tier and re-activation promotes.
    enabled: bool = True
    # Host-RAM budget in MiB for demoted weight shards (0 disables the
    # host tier; demotion then degrades to free).
    host_mb: int = DEFAULT_HOST_MB


def env_enabled() -> bool:
    """The process default for the master switch (``ADVSPEC_WEIGHT_RES``)."""
    return os.environ.get("ADVSPEC_WEIGHT_RES", "1") != "0"


def env_host_mb() -> int:
    """The process default host budget (``ADVSPEC_WEIGHT_HOST_MB``)."""
    try:
        return max(
            0, int(os.environ.get("ADVSPEC_WEIGHT_HOST_MB", DEFAULT_HOST_MB))
        )
    except ValueError:
        return DEFAULT_HOST_MB


@dataclass
class WeightStats(procconfig.StatsBase):
    """Process-wide residency counters, aggregated across every engine
    (and the mock's deterministic accounting).

    ``load_s`` is the cost residency exists to avoid (full checkpoint
    materializations); ``promote_s`` the cost it pays instead — the
    bench headline compares ``load_s + promote_s`` resident-vs-thrash.
    ``promotions_overlapped`` counts promotions that rode another
    model's decode (the prefetch thread), so the swap-overlap fraction
    is ``promotions_overlapped / promotions``.
    """

    loads: int = 0  # full (cold) materializations
    load_s: float = 0.0
    demotions: int = 0  # device -> host
    demote_s: float = 0.0
    promotions: int = 0  # host -> device re-activations
    promote_s: float = 0.0
    promotions_overlapped: int = 0  # promotions riding another's decode
    freed_models: int = 0  # evictions that freed instead of demoting
    swap_faults: int = 0  # promotions aborted by a fault mid-swap
    coalesced_groups: int = 0  # chat rounds reordered resident-first
    coalesced_units: int = 0  # serve units pulled ahead to dodge a swap
    preload_hints: int = 0  # warm-replica residency hints (autoscale)

    def snapshot(self) -> dict:
        out = self.as_dict()
        out["weight_load_wall_s"] = round(self.load_s + self.promote_s, 6)
        out["swap_overlap_fraction"] = (
            round(self.promotions_overlapped / self.promotions, 4)
            if self.promotions
            else 0.0
        )
        out["reload_avoided_rate"] = (
            round(self.promotions / (self.promotions + self.loads), 4)
            if (self.promotions + self.loads)
            else 0.0
        )
        return out


_state = procconfig.ProcState(
    WeightResConfig(enabled=env_enabled(), host_mb=env_host_mb()),
    WeightStats(),
    coerce={"host_mb": lambda v: max(0, int(v))},
)
_config = _state.config
stats = _state.stats


def config() -> WeightResConfig:
    return _state.config


def configure(
    enabled: bool | None = None, host_mb: int | None = None
) -> WeightResConfig:
    return _state.configure(enabled=enabled, host_mb=host_mb)


def reset_stats() -> None:
    _state.reset_stats()


def snapshot() -> dict:
    """Stats + config, the ``perf.weights`` payload."""
    return _state.snapshot()


def paging_armed() -> bool:
    """True when evictions demote to host RAM instead of freeing."""
    return _config.enabled and _config.host_mb > 0


def preload_hint(models) -> int:
    """Residency preload hint for a replica being WARMED before ring
    admission (fleet/autoscale.py): the hottest models from the serve
    scheduler's model mix, in hotness order. Deliberately advisory —
    the ledger's one admission surgery still runs on first serve, so
    conservation invariants are untouched; the hint's value is that
    the warming replica builds its engines (and, on the TPU engine, its
    checkpoints materialize) while the replica is NOT routable, moving
    the cold-load wall off the first routed request. Counted so the
    elasticity drills can assert warming actually happened. Returns
    the hint count recorded."""
    n = len(list(models))
    if n:
        stats.preload_hints += n
    return n


def mock_budget_bytes() -> int | None:
    """The mock engine's residency trigger: it drives the ledger only
    under an EXPLICIT ``ADVSPEC_HBM_BUDGET_BYTES`` (the bench and tests
    arm it); without one the simulation is off and mock event streams
    stay byte-identical to their pre-residency pins."""
    env = os.environ.get("ADVSPEC_HBM_BUDGET_BYTES")
    if not env:
        return None
    try:
        return int(env)
    except ValueError:
        return None


# -- the residency ledger ---------------------------------------------------

RESIDENT = "resident"
HOST = "host"


@dataclass
class ModelEntry:
    """One model's residency record. ``payload`` is opaque to the
    ledger: the TPU engine stores a host-weights holder (np shards +
    shardings + spec/config/tokenizer), the mock stores ``None``."""

    alias: str
    state: str  # RESIDENT | HOST
    bytes_device: int = 0
    bytes_host: int = 0
    payload: object = None
    last_used: int = 0
    pins: int = 0


class WeightLedger:
    """The weight-residency state machine (one per engine instance;
    stats aggregate into the process-wide module counters).

    Conservation invariant (the chaos drill's contract): every model
    ever demoted ends in EXACTLY ONE of re-promoted / still host-
    resident / freed — an aborted promotion leaves the host entry
    untouched (the engine commits the transition only AFTER the device
    transfer is dispatched), so a fault mid-swap costs one retry, never
    a lost or double-counted model.

    Every ``_entries`` transition funnels through ONE surgery
    (:meth:`_retire_model`) plus the one admission path
    (:meth:`_admit_model`) — graftlint's fourth GL-LIFECYCLE machine
    enforces exactly that shape statically.
    """

    def __init__(self, stats_obj: WeightStats | None = None):
        self._entries: dict[str, ModelEntry] = {}
        # Pins taken before the model finished loading (the engine pins
        # FIRST so a concurrent eviction can never victimize a model
        # that is about to serve); merged into the entry at admission.
        self._pre_pins: dict[str, int] = {}
        self._clock = 0
        self._lock = lockdep_mod.make_lock("WeightLedger._lock")
        self.stats = stats_obj if stats_obj is not None else stats
        # Conservation counters (lifetime).
        self.admitted = 0  # loads + promotions into the device tier
        self.demoted = 0
        self.promoted = 0  # host entries re-admitted to the device
        self.freed_host = 0  # host entries dropped (budget/clear)
        self.freed_resident = 0  # device entries freed without demoting

    # -- queries ------------------------------------------------------

    def state(self, alias: str) -> str | None:
        with self._lock:
            e = self._entries.get(alias)
            return e.state if e is not None else None

    def is_resident(self, alias: str) -> bool:
        return self.state(alias) == RESIDENT

    def is_host(self, alias: str) -> bool:
        return self.state(alias) == HOST

    def peek_host(self, alias: str) -> ModelEntry | None:
        """The host entry a promotion will materialize from (left in
        place — the transition commits via :meth:`promote_model` only
        after the device transfer is dispatched, so an aborted swap
        leaves the tier intact)."""
        with self._lock:
            e = self._entries.get(alias)
            return e if e is not None and e.state == HOST else None

    def resident_aliases(self) -> list[str]:
        with self._lock:
            return [
                a for a, e in self._entries.items() if e.state == RESIDENT
            ]

    def host_aliases(self) -> list[str]:
        with self._lock:
            return [a for a, e in self._entries.items() if e.state == HOST]

    @property
    def resident_models(self) -> int:
        with self._lock:
            return sum(
                1 for e in self._entries.values() if e.state == RESIDENT
            )

    @property
    def host_models(self) -> int:
        with self._lock:
            return sum(1 for e in self._entries.values() if e.state == HOST)

    @property
    def host_bytes(self) -> int:
        with self._lock:
            return self._host_bytes_locked()

    def _host_bytes_locked(self) -> int:
        """Caller must hold ``_lock`` (plain Lock — not re-entrant)."""
        return sum(
            e.bytes_host for e in self._entries.values() if e.state == HOST
        )

    def lru_resident_alias(self) -> str | None:
        """The least-recently-used unpinned resident model (the next
        eviction victim), or None when everything resident is pinned."""
        with self._lock:
            cands = [
                e
                for e in self._entries.values()
                if e.state == RESIDENT and e.pins == 0
            ]
            if not cands:
                return None
            return min(cands, key=lambda e: e.last_used).alias

    def resident_first(self, aliases: list[str]) -> list[str]:
        """Stable resident-first order for one round's model groups —
        THE coalescing policy both engines share (a swap is allowed
        only after the resident models' queued work is exhausted).
        Counts the reorder into ``coalesced_groups`` when it changed
        anything; groups decode independently, so reordering cannot
        change any row's greedy tokens."""
        if len(aliases) <= 1:
            return list(aliases)
        order = sorted(
            range(len(aliases)),
            key=lambda i: (not self.is_resident(aliases[i]), i),
        )
        if order != list(range(len(aliases))):
            self.stats.coalesced_groups += 1
        return [aliases[i] for i in order]

    def touch(self, alias: str) -> None:
        with self._lock:
            e = self._entries.get(alias)
            if e is not None:
                self._clock += 1
                e.last_used = self._clock

    # -- pins (graftlint refcount pair: acquire_weights=release_weights)

    def acquire_weights(self, alias: str) -> None:
        """Pin a model against eviction for the duration of its serve
        (mid-decode weights must never be a demotion victim). Balanced
        by :meth:`release_weights` on every path (try/finally at the
        call site — GL-REFCOUNT enforces the shape)."""
        with self._lock:
            e = self._entries.get(alias)
            if e is not None:
                e.pins += 1
            else:
                self._pre_pins[alias] = self._pre_pins.get(alias, 0) + 1

    def release_weights(self, alias: str) -> None:
        with self._lock:
            e = self._entries.get(alias)
            if e is not None and e.pins > 0:
                e.pins -= 1
                return
            if self._pre_pins.get(alias):
                self._pre_pins[alias] -= 1
                if not self._pre_pins[alias]:
                    del self._pre_pins[alias]

    def pinned(self, alias: str) -> bool:
        with self._lock:
            e = self._entries.get(alias)
            if e is not None and e.pins > 0:
                return True
            return bool(self._pre_pins.get(alias))

    # -- transitions --------------------------------------------------

    def _emit(self, op: str, alias: str, nbytes: int, wall_s: float) -> None:
        if not obs_mod.config().enabled:
            return
        obs_mod.hot.weight_resident.set(self.resident_models)
        obs_mod.emit(
            obs_mod.WeightEvent(
                op=op,
                alias=alias,
                nbytes=nbytes,
                wall_s=wall_s,
                resident=self.resident_models,
                host=self.host_models,
            )
        )

    def _admit_model(
        self, alias: str, bytes_device: int, payload: object = None
    ) -> ModelEntry:
        """The ONE admission path into the device tier (load and
        promote both land here). Merges any pin taken before the load
        finished."""
        self._clock += 1
        pins = self._pre_pins.pop(alias, 0)
        entry = ModelEntry(
            alias=alias,
            state=RESIDENT,
            bytes_device=bytes_device,
            payload=payload,
            last_used=self._clock,
            pins=pins,
        )
        self._entries[alias] = entry
        self.admitted += 1
        return entry

    def _retire_model(self, alias: str, dest: str) -> ModelEntry | None:
        """THE release surgery: the only code that takes an entry out
        of its current state. ``dest``: ``host`` (demotion — the caller
        already attached the host payload via :meth:`demote_model`),
        ``promoted`` (host entry re-admitted by ``promote_model``),
        ``freed`` (dropped from either state). Conservation counters
        update here and nowhere else."""
        entry = self._entries.get(alias)
        if entry is None:
            return None
        if dest == HOST:
            entry.state = HOST
            entry.bytes_device = 0
            self.demoted += 1
            return entry
        popped = self._entries.pop(alias)
        if dest == "promoted":
            self.promoted += 1
        elif popped.state == HOST:
            self.freed_host += 1
        else:
            self.freed_resident += 1
        return popped

    def admit_load(
        self, alias: str, bytes_device: int, wall_s: float = 0.0
    ) -> None:
        """A cold materialization finished: the model is resident.

        Two racing loads of one alias both publish (the engine's
        ``_models`` dict tolerates the overwrite); the SECOND admission
        retires the first through the surgery so conservation stays
        exact — one admission resident, one freed, never two counted
        against one entry."""
        with self._lock:
            prior = self._entries.get(alias)
            popped = (
                self._retire_model(alias, "freed")
                if prior is not None
                else None
            )
            entry = self._admit_model(alias, bytes_device)
            if popped is not None:
                entry.pins += popped.pins
        self.stats.loads += 1
        self.stats.load_s += wall_s
        self._emit("load", alias, bytes_device, wall_s)
        if obs_mod.config().enabled and wall_s > 0.0:
            obs_mod.hot.weight_swap_latency("load").observe(wall_s)

    def demote_model(
        self,
        alias: str,
        payload: object,
        bytes_host: int,
        wall_s: float = 0.0,
        host_budget_bytes: int | None = None,
    ) -> list[str]:
        """Resident → host: the eviction that keeps the shards. Returns
        the aliases of host-tier LRU victims freed to fit the budget
        (oldest first; the demoted model itself is freed when it alone
        exceeds the budget)."""
        freed: list[str] = []
        with self._lock:
            entry = self._retire_model(alias, HOST)
            if entry is None:
                return freed
            entry.payload = payload
            entry.bytes_host = bytes_host
            budget = (
                host_budget_bytes
                if host_budget_bytes is not None
                else _config.host_mb << 20
            )
            while self._host_bytes_locked() > budget:
                victims = [
                    e
                    for e in self._entries.values()
                    if e.state == HOST
                ]
                if not victims:
                    break
                lru = min(victims, key=lambda e: e.last_used)
                self._retire_model(lru.alias, "freed")
                freed.append(lru.alias)
        self.stats.demotions += 1
        self.stats.demote_s += wall_s
        self._emit("demote", alias, bytes_host, wall_s)
        if obs_mod.config().enabled and wall_s > 0.0:
            obs_mod.hot.weight_swap_latency("out").observe(wall_s)
        for victim in freed:
            self.stats.freed_models += 1
            self._emit("free", victim, 0, 0.0)
        return freed

    def promote_model(
        self,
        alias: str,
        bytes_device: int,
        wall_s: float = 0.0,
        overlapped: bool = False,
    ) -> None:
        """Host → resident, called AFTER the device transfer was
        dispatched (a fault before this call leaves the host entry
        untouched — the aborted-swap contract)."""
        with self._lock:
            prior = self._entries.get(alias)
            # Two racing promotions both pass peek_host before either
            # commits: the loser finds the alias already RESIDENT and
            # must retire that admission as freed, not count a second
            # promotion against the single demotion.
            dest = (
                "promoted"
                if prior is None or prior.state == HOST
                else "freed"
            )
            popped = self._retire_model(alias, dest)
            pins = popped.pins if popped is not None else 0
            entry = self._admit_model(alias, bytes_device)
            entry.pins += pins
        self.stats.promotions += 1
        self.stats.promote_s += wall_s
        if overlapped:
            self.stats.promotions_overlapped += 1
        self._emit("promote", alias, bytes_device, wall_s)
        if obs_mod.config().enabled and wall_s > 0.0:
            obs_mod.hot.weight_swap_latency("in").observe(wall_s)

    def free_model(self, alias: str) -> None:
        """Either state → freed (eviction with paging off, host budget
        overflow handled by demote, or explicit teardown)."""
        with self._lock:
            popped = self._retire_model(alias, "freed")
        if popped is not None:
            self.stats.freed_models += 1
            self._emit("free", alias, 0, 0.0)

    def note_swap_fault(self, alias: str) -> None:
        """A promotion aborted mid-swap: the host entry is untouched
        (conservation holds), the fault is counted and declared."""
        self.stats.swap_faults += 1
        self._emit("swap_fault", alias, 0, 0.0)

    def clear(self) -> None:
        """Engine teardown: free everything through the surgery."""
        with self._lock:
            for alias in list(self._entries):
                self._retire_model(alias, "freed")

    def check_invariants(self) -> None:
        """Raise RuntimeError on bookkeeping drift: state vocabulary,
        pin sanity, and conservation (every demotion accounted host /
        promoted / freed; every admission accounted resident / demoted /
        freed)."""
        with self._lock:
            resident = host = 0
            for alias, e in self._entries.items():
                if e.alias != alias:
                    raise RuntimeError(
                        f"weight ledger key {alias} holds entry {e.alias}"
                    )
                if e.state == RESIDENT:
                    resident += 1
                elif e.state == HOST:
                    host += 1
                else:
                    raise RuntimeError(
                        f"weight ledger entry {alias} in unknown state "
                        f"{e.state!r}"
                    )
                if e.pins < 0:
                    raise RuntimeError(
                        f"weight ledger entry {alias} has negative pins"
                    )
            if self.demoted != host + self.promoted + self.freed_host:
                raise RuntimeError(
                    f"weight ledger demotion conservation violated: "
                    f"{self.demoted} demoted != {host} host + "
                    f"{self.promoted} promoted + {self.freed_host} freed"
                )
            if self.admitted != (
                resident + self.demoted + self.freed_resident
            ):
                raise RuntimeError(
                    f"weight ledger admission conservation violated: "
                    f"{self.admitted} admitted != {resident} resident + "
                    f"{self.demoted} demoted + "
                    f"{self.freed_resident} freed"
                )
