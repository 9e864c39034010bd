"""Cross-replica paged-KV handoff ledger: prefill → ship → adopt.

The PyTorch port's copy of ``adversarial_spec_tpu/fleet/handoff.py``.

Disaggregated serving splits one request across two replicas: a
PREFILL-role replica runs admission + prefill and publishes the
produced KV blocks to the shared content-addressed store
(engine/kvtier.py demote-to-disk path), then a DECODE-role replica
adopts them — its first step starts from a tier hit instead of a
re-prefill. Between those two halves sits a race the fleet must never
lose *incorrectly*: the store write may be partial (prefill replica
SIGKILLed mid-publish), the shipped blocks may be quarantined or
evicted before the decode side promotes them, or the prefill replica
may simply die. Every one of those degrades to a LOCAL prefill on the
decode replica with byte-identical transcripts — the handoff is a
latency optimization, never a correctness dependency.

This module owns the bookkeeping for that contract as a one-way
lifecycle machine (graftlint ``handoff_lifecycle`` pins it):

    PLANNED → PREFILLING → PUBLISHED → {adopted | degraded | abandoned}

A handoff is born through the ``begin`` mutator and leaves through
exactly one of three exits — ``_finish_adopt`` (the decode replica
confirmed the shipped blocks in the store), ``_degrade`` (lost the
race: store miss, partial publish, replica death — decode side
re-prefills locally) or ``_abandon`` (the plan never produced blocks).
All three funnel into the ONE surgery, ``_publish_blocks``, the only
writer of the terminal-outcome ledger: fleet stats, the
``advspec_kv_handoff_total{outcome}`` counter and the handoff-latency
histogram all update in that single place, so a handoff can neither
be double-counted nor vanish between states.
"""

from __future__ import annotations

import dataclasses
import time

from adversarial_spec_tpu_torch import fleet as fleet_mod
from adversarial_spec_tpu_torch import obs as obs_mod

# Handoff states (one-way; terminal outcomes are lowercase because
# they double as the {outcome} metric label).
PLANNED = "PLANNED"
PREFILLING = "PREFILLING"
PUBLISHED = "PUBLISHED"

ADOPTED = "adopted"
DEGRADED = "degraded"
ABANDONED = "abandoned"

OUTCOMES = (ADOPTED, DEGRADED, ABANDONED)


@dataclasses.dataclass
class HandoffRecord:
    """One in-flight handoff: which key ships from where to where."""

    key: str
    prefill_replica: str
    decode_replica: str
    state: str = PLANNED
    chains: list = dataclasses.field(default_factory=list)
    blocks: int = 0
    reason: str = ""
    started_t: float = 0.0
    wall_s: float = 0.0


class HandoffLedger:
    """Tracks every cross-replica KV handoff from plan to outcome.

    The terminal ledger ``_outcomes`` is lifecycle-OWNED: written only
    by the ``_publish_blocks`` surgery (and ``__init__``); the router's
    orchestration moves records through the non-terminal states via
    the ``note_*`` helpers, which mutate the record, never the ledger.
    """

    def __init__(self, stats=None, clock=time.monotonic):
        self._clock = clock
        self._stats = stats
        # In-flight handoffs by affinity key (born via ``begin``).
        self._active: dict[str, HandoffRecord] = {}
        # Terminal outcome per key — written ONLY by the
        # _publish_blocks surgery (GL-LIFECYCLE handoff machine).
        self._outcomes: dict[str, str] = {}

    # -- reads -------------------------------------------------------------

    def active(self, key: str) -> HandoffRecord | None:
        return self._active.get(key)

    def outcome(self, key: str) -> str | None:
        return self._outcomes.get(key)

    def seen(self, key: str) -> bool:
        """Whether ``key`` already has a handoff in flight or decided —
        a debate's later rounds reuse the first round's shipped KV via
        the ordinary prefix path, so they never re-handoff."""
        return key in self._active or key in self._outcomes

    def snapshot(self) -> dict:
        counts = {o: 0 for o in OUTCOMES}
        for outcome in self._outcomes.values():
            counts[outcome] = counts.get(outcome, 0) + 1
        return {"active": len(self._active), **counts}

    # -- mutator (record birth) --------------------------------------------

    def begin(
        self, key: str, prefill_replica: str, decode_replica: str
    ) -> HandoffRecord:
        """Plan one handoff: ``key``'s prefill runs on
        ``prefill_replica``, its decode on ``decode_replica``."""
        rec = HandoffRecord(
            key=key,
            prefill_replica=prefill_replica,
            decode_replica=decode_replica,
            started_t=self._clock(),
        )
        self._active[key] = rec
        stats = self._stats if self._stats is not None else fleet_mod.stats
        stats.handoff_attempts += 1
        return rec

    # -- non-terminal transitions (record fields, not the ledger) ----------

    def note_prefilling(self, key: str) -> None:
        rec = self._active.get(key)
        if rec is not None:
            rec.state = PREFILLING

    def note_published(self, key: str, chains, blocks: int) -> None:
        rec = self._active.get(key)
        if rec is not None:
            rec.state = PUBLISHED
            rec.chains = list(chains)
            rec.blocks = int(blocks)

    # -- lifecycle surgery + exits -----------------------------------------

    def _publish_blocks(
        self, key: str, outcome: str, reason: str = ""
    ) -> HandoffRecord | None:
        """THE handoff surgery: every exit funnels here. Pops the
        in-flight record, writes the terminal outcome (the ONLY write
        to ``_outcomes``), and updates stats + telemetry exactly once.
        Idempotent: a key that already reached an outcome is a no-op
        (the first decision stands — zero double-counting)."""
        rec = self._active.pop(key, None)
        if rec is None or key in self._outcomes:
            return None
        self._outcomes[key] = outcome
        rec.state = outcome
        rec.reason = reason
        rec.wall_s = max(0.0, self._clock() - rec.started_t)
        stats = self._stats if self._stats is not None else fleet_mod.stats
        if outcome == ADOPTED:
            stats.handoff_adopted += 1
        elif outcome == DEGRADED:
            stats.handoff_degraded += 1
        else:
            stats.handoff_abandoned += 1
        if rec.blocks:
            stats.handoff_shipped_blocks += rec.blocks
        if obs_mod.config().enabled:
            obs_mod.hot.handoff(outcome).inc()
            obs_mod.hot.handoff_latency.observe(rec.wall_s)
        return rec

    def _finish_adopt(self, key: str) -> HandoffRecord | None:
        """Exit: the decode replica confirmed the shipped chains in the
        shared store — its first step is a tier hit."""
        return self._publish_blocks(key, ADOPTED)

    def _degrade(self, key: str, reason: str = "") -> HandoffRecord | None:
        """Exit: the handoff lost the race (store miss, partial
        publish, prefill-replica death) — the decode replica prefills
        locally; transcripts stay byte-identical."""
        return self._publish_blocks(key, DEGRADED, reason)

    def _abandon(self, key: str, reason: str = "") -> HandoffRecord | None:
        """Exit: the plan never produced publishable blocks (nothing
        shipped, nothing to adopt)."""
        return self._publish_blocks(key, ABANDONED, reason)
