"""Tiered-KV config and telemetry, and content addressing of prefix blocks.

Counterpart of ``adversarial_spec_tpu/engine/kvtier.py``. The tiers
themselves (host-RAM demotion, the persistent disk store) are not ported
yet: neither the port's batcher nor its mock engine attaches any. What is
here:

- ``chain_hash``, which ``engine/prefix_cache.py`` stamps on blocks when
  lower tiers are attached;
- the reference's config and stats, constant here, so that
  ``perf.kv_tier`` has the reference's keys. The reference arms tier 1 by
  default; the port reports the tiers off (``enabled: False``, every
  counter zero), and the CLI refuses every flag and env var that would
  arm them, so a round never claims a tier it does not have.
"""

from __future__ import annotations

import hashlib
from dataclasses import asdict, dataclass

from adversarial_spec_tpu_torch.engine import procconfig

DEFAULT_HOST_MB = 256


@dataclass
class TierConfig:
    """The reference's knobs, at the only values the port serves."""

    enabled: bool = False
    host_mb: int = DEFAULT_HOST_MB
    store_dir: str = ""
    flush_blocks: int = 0


@dataclass
class TierStats(procconfig.StatsBase):
    """The reference's tier counters (all stay zero in the port)."""

    tier_lookups: int = 0
    host_hits: int = 0
    disk_hits: int = 0
    demoted_blocks: int = 0
    demoted_tokens: int = 0
    promoted_blocks: int = 0
    promoted_tokens: int = 0
    rehydrated_blocks: int = 0
    rehydrated_tokens: int = 0
    recomputed_blocks: int = 0
    spilled_blocks: int = 0
    host_freed_blocks: int = 0
    store_writes: int = 0
    store_corrupt: int = 0
    swap_in_s: float = 0.0
    swap_out_s: float = 0.0

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


def snapshot() -> dict:
    """The ``perf.kv_tier`` payload: the reference's keys, every counter
    zero and the tiers off."""
    return {**TierStats().snapshot(), **asdict(TierConfig())}


def chain_hash(parent: str, tokens) -> str:
    """Content address of one radix block: the chain ``(parent chain,
    block tokens)`` — the same identity the trie realizes through dict
    hashing, made stable across processes. Tokens may be ints or
    strings; both serialize through ``str``."""
    h = hashlib.sha256()
    h.update(parent.encode("ascii"))
    h.update(b"\x00")
    for t in tokens:
        h.update(str(t).encode("utf-8"))
        h.update(b"\x1f")
    return h.hexdigest()
