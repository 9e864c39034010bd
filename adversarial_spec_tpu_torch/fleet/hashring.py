"""Consistent-hash ring: affinity keys → replicas, stable under churn.

The PyTorch port's copy of ``adversarial_spec_tpu/fleet/hashring.py``.

The routing problem prefix affinity sets: every round of one debate
must land on the SAME replica (that's where its prefix KV lives), and
when a replica joins or leaves, only the debates that hashed to the
affected arc may move — a modulo hash would reshuffle (N−1)/N of all
keys on every membership change and cold every replica's cache at
once.

Classic ring with virtual nodes: each replica owns ``vnodes`` points
on a 2^64 ring (sha256 of ``"<replica>#<k>"``), a key routes to the
first point clockwise from its own hash, and ``preference()`` keeps
walking to produce the failover order — the same order every caller
computes, with no coordination. Everything is deterministic (sha256,
no process randomness), so tests and the chaos harness can predict the
primary replica for a key.

Roles (fleet disaggregation): a node may carry a role tag
(``"prefill"`` / ``"decode"``; ``""`` = any). ``preference(role=...)``
walks the SAME ring but skips foreign-role owners, so a role filter
never perturbs the walk order of the nodes it keeps — membership
change inside a role pool still moves ~1/N of that pool's keys, and
only to the newcomer, exactly the un-roled guarantee scoped per pool.
Untagged nodes serve every role (the symmetric-fleet degenerate case).
"""

from __future__ import annotations

import bisect
import hashlib

DEFAULT_VNODES = 64


def _point(data: str) -> int:
    """A stable 64-bit ring position for a string."""
    return int.from_bytes(
        hashlib.sha256(data.encode("utf-8")).digest()[:8], "big"
    )


class HashRing:
    """Replica ids on a consistent-hash ring with virtual nodes."""

    def __init__(self, nodes=(), vnodes: int = DEFAULT_VNODES):
        self.vnodes = max(1, int(vnodes))
        self._points: list[int] = []  # sorted ring positions
        self._owner: dict[int, str] = {}  # position -> replica id
        self._nodes: set[str] = set()
        self._roles: dict[str, str] = {}  # node -> role ("" = any)
        for n in nodes:
            self.add(n)

    def __len__(self) -> int:
        return len(self._nodes)

    def __contains__(self, node: str) -> bool:
        return node in self._nodes

    @property
    def nodes(self) -> set[str]:
        return set(self._nodes)

    def role_of(self, node: str) -> str:
        """The node's role tag ("" = untagged, serves any role)."""
        return self._roles.get(node, "")

    def role_nodes(self, role: str) -> set[str]:
        """Nodes eligible for ``role``: tagged with it, or untagged."""
        return {
            n for n in self._nodes if self._roles.get(n, "") in ("", role)
        }

    def add(self, node: str, role: str = "") -> None:
        if node in self._nodes:
            return
        self._nodes.add(node)
        if role:
            self._roles[node] = role
        for k in range(self.vnodes):
            p = _point(f"{node}#{k}")
            # sha256 collisions between distinct vnode labels are not a
            # practical concern; first owner keeps the point.
            if p not in self._owner:
                self._owner[p] = node
                bisect.insort(self._points, p)

    def remove(self, node: str) -> None:
        if node not in self._nodes:
            return
        self._nodes.discard(node)
        self._roles.pop(node, None)
        dead = [p for p, n in self._owner.items() if n == node]
        for p in dead:
            del self._owner[p]
        dead_set = set(dead)
        self._points = [p for p in self._points if p not in dead_set]

    def primary(self, key: str, role: str | None = None) -> str | None:
        """The replica owning ``key`` (None on an empty ring / empty
        role pool)."""
        pref = self.preference(key, limit=1, role=role)
        return pref[0] if pref else None

    def preference(
        self,
        key: str,
        limit: int | None = None,
        role: str | None = None,
    ) -> list[str]:
        """Distinct replicas in ring-walk order from ``key``'s hash —
        element 0 is the affinity primary, the rest the deterministic
        failover order every caller agrees on. ``role`` filters the
        walk to that role's pool (tagged-with-it or untagged nodes)
        WITHOUT perturbing the kept nodes' relative order — the role
        pool behaves as its own consistent ring."""
        if not self._points:
            return []
        eligible = (
            self._nodes if role is None else self.role_nodes(role)
        )
        if not eligible:
            return []
        limit = (
            len(eligible) if limit is None else min(limit, len(eligible))
        )
        out: list[str] = []
        seen: set[str] = set()
        start = bisect.bisect_left(self._points, _point(key))
        for i in range(len(self._points)):
            owner = self._owner[self._points[(start + i) % len(self._points)]]
            if owner not in seen and owner in eligible:
                seen.add(owner)
                out.append(owner)
                if len(out) >= limit:
                    break
        return out
