"""Content addressing of prefix-cache blocks.

Counterpart of ``chain_hash`` in ``adversarial_spec_tpu/engine/kvtier.py``,
which ``engine/prefix_cache.py`` stamps on blocks when lower tiers are
attached. The tiers themselves (host RAM demotion, the disk store) are not
ported yet: the port's batcher attaches none.
"""

from __future__ import annotations

import hashlib


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
