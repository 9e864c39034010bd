"""First-class fault injection — chaos testing as a supported mode.

The PyTorch port's copy of ``adversarial_spec_tpu/resilience/injector.py``.

The test suite used to simulate failures by monkeypatching ``generate``;
that covers the debate seam but cannot reach inside a live scheduler
drain, and it is not something an operator can switch on. This module
puts permanent, near-zero-cost hooks at the four seams where TPU serving
actually breaks:

==================  =====================================================
seam                fires just before
==================  =====================================================
``generate``        a model group's decode dispatch (engine/tpu.py)
``scheduler_chunk`` each ContinuousBatcher decode chunk
``kv_alloc``        page reservation at admission (engine/scheduler.py)
``kv_swap``         each tier-block promotion into an admission's pages
                    (engine/scheduler.py — the tiered-KV swap path)
``weight_swap``     each weight promotion of a host-demoted model back
                    into HBM (engine/tpu.py) — a fault here aborts the
                    swap with the host entry untouched: only the
                    admission waiting on the swap degrades, the
                    residency ledger stays conservation-clean, and the
                    aborted swap is a declared WeightEvent
                    (``tools/chaos_run.py --weight-swap`` is the drill)
``checkpoint_load`` parameter materialization (engine/tpu.py)
``crash``           each round-journal fsync append (debate/journal.py)
                    — the write-ahead durability path: a fault here is
                    a record that never became durable, and the round
                    must survive it (journal failure is contained, the
                    kill-chaos harness proves the stronger SIGKILL
                    variant)
``replica``         each fleet group dispatch (fleet/router.py) — a
                    fault here is a replica-level failure the
                    per-(replica, model) breakers absorb: the request
                    re-routes, the pair's circuit counts the hit, and
                    no process dies (the SIGKILL variant lives in
                    ``tools/chaos_run.py --replica-kill``)
==================  =====================================================

Configure with ``--chaos`` on the CLI or ``ADVSPEC_CHAOS`` in the
environment. Spec grammar (comma-separated rules)::

    kind@seam[:p=0.5][:after=N][:times=N][:slot=K]

    oom@scheduler_chunk:after=1:times=1:slot=1
    device_lost@generate:p=0.25
    bug@kv_alloc:times=1

``after=N`` skips the first N hits of the seam; ``times=N`` caps total
fires (0 = unlimited); ``p`` is the per-hit fire probability (seeded via
``ADVSPEC_CHAOS_SEED`` / ``--chaos-seed`` for reproducible chaos);
``slot`` targets a scheduler slot for eviction (scheduler seams only).

Injected exceptions are ``InjectedFault`` — they carry their ``FaultKind``
as an attribute (exact classification) *and* the matching status-code
marker in their message, so they exercise the same string paths real
XLA/PJRT faults take.
"""

from __future__ import annotations

import os
import random
import threading
from dataclasses import dataclass, field

from adversarial_spec_tpu_torch.resilience import lockdep as lockdep_mod
from adversarial_spec_tpu_torch.resilience.faults import FaultKind

SEAMS = (
    "generate",
    "scheduler_chunk",
    "kv_alloc",
    "kv_swap",
    "weight_swap",
    "checkpoint_load",
    "crash",
    "replica",
)

# Marker text per kind: mirrors what PJRT/XLA put in real messages so the
# textual classify() path agrees with the attribute path.
_KIND_MESSAGES = {
    FaultKind.OOM: "RESOURCE_EXHAUSTED: injected OOM",
    FaultKind.DEVICE_LOST: "UNAVAILABLE: injected device loss",
    FaultKind.PREEMPTED: "ABORTED: injected preemption",
    FaultKind.TIMEOUT: "DEADLINE_EXCEEDED: injected timeout",
    # The serve layer's typed-refusal shape (serve/sched.py stamps
    # "shed (<reason>):") so the textual classify() path agrees.
    FaultKind.SHED: "shed (injected): synthetic load-shed refusal",
    FaultKind.BUG: "injected programming error",
}


class InjectedFault(RuntimeError):
    """A synthetic fault raised at a chaos seam."""

    def __init__(self, kind: FaultKind, seam: str, slot: int | None = None):
        super().__init__(f"{_KIND_MESSAGES[kind]} at seam {seam!r} (chaos)")
        self.fault_kind = kind
        self.seam = seam
        self.slot = slot


@dataclass
class FaultRule:
    """One armed fault: what to raise, where, and when."""

    kind: FaultKind
    seam: str
    p: float = 1.0  # per-hit fire probability
    after: int = 0  # skip the first N hits of this seam
    times: int = 0  # max total fires (0 = unlimited)
    slot: int | None = None  # scheduler slot to evict (scheduler seams)
    hits: int = field(default=0, compare=False)
    fires: int = field(default=0, compare=False)

    def __post_init__(self) -> None:
        if self.seam not in SEAMS:
            raise ValueError(
                f"unknown chaos seam {self.seam!r}; known: {', '.join(SEAMS)}"
            )


def parse_chaos_spec(spec: str) -> list[FaultRule]:
    """``kind@seam[:opt=val]...`` (comma-separated) → rules.

    Raises ValueError with an actionable message on any malformed piece —
    a typo'd chaos flag must fail loudly, not silently not inject.
    """
    rules = []
    for part in (p.strip() for p in spec.split(",")):
        if not part:
            continue
        head, _, opts = part.partition(":")
        kind_s, sep, seam = head.partition("@")
        if not sep or not seam:
            raise ValueError(
                f"bad chaos rule {part!r}: expected kind@seam[:opt=val]"
            )
        try:
            kind = FaultKind(kind_s.strip().lower())
        except ValueError:
            known = ", ".join(k.value for k in FaultKind)
            raise ValueError(
                f"unknown fault kind {kind_s!r}; known: {known}"
            ) from None
        kw: dict = {}
        if opts:
            for opt in opts.split(":"):
                key, sep, val = opt.partition("=")
                if not sep:
                    raise ValueError(f"bad chaos option {opt!r} in {part!r}")
                key = key.strip()
                try:
                    if key == "p":
                        kw["p"] = float(val)
                    elif key in ("after", "times", "slot"):
                        kw[key] = int(val)
                    else:
                        raise ValueError
                except ValueError:
                    raise ValueError(
                        f"bad chaos option {opt!r} in {part!r} "
                        "(known: p=<float>, after=<int>, times=<int>, "
                        "slot=<int>)"
                    ) from None
        rules.append(FaultRule(kind=kind, seam=seam.strip(), **kw))
    return rules


class FaultInjector:
    """Holds armed rules; ``check(seam)`` raises when one fires."""

    def __init__(self, rules=(), seed: int | None = None):
        self.rules: list[FaultRule] = list(rules)
        self._rng = random.Random(seed)
        self._lock = lockdep_mod.make_lock("FaultInjector._lock")
        self.fired: dict[str, int] = {}  # "<seam>.<kind>" -> fire count
        self.seam_hits: dict[str, int] = {}  # seam -> hook invocations

    @property
    def enabled(self) -> bool:
        return bool(self.rules)

    def check(self, seam: str, slot: int | None = None) -> None:
        """Raise InjectedFault if an armed rule for ``seam`` fires."""
        with self._lock:
            self.seam_hits[seam] = self.seam_hits.get(seam, 0) + 1
            for rule in self.rules:
                if rule.seam != seam:
                    continue
                rule.hits += 1
                if rule.hits <= rule.after:
                    continue
                if rule.times and rule.fires >= rule.times:
                    continue
                if rule.p < 1.0 and self._rng.random() >= rule.p:
                    continue
                rule.fires += 1
                key = f"{seam}.{rule.kind.value}"
                self.fired[key] = self.fired.get(key, 0) + 1
                raise InjectedFault(
                    rule.kind, seam, slot=rule.slot if rule.slot is not None else slot
                )


# -- active injector -------------------------------------------------------

_active: FaultInjector | None = None
_active_lock = lockdep_mod.make_lock("injector._active_lock")


def active() -> FaultInjector:
    """The process injector; first use materializes ``ADVSPEC_CHAOS``."""
    global _active
    with _active_lock:
        if _active is None:
            spec = os.environ.get("ADVSPEC_CHAOS", "")
            seed_env = os.environ.get("ADVSPEC_CHAOS_SEED")
            _active = FaultInjector(
                parse_chaos_spec(spec) if spec else (),
                seed=int(seed_env) if seed_env else None,
            )
        return _active


def install(injector: FaultInjector | None) -> None:
    """Replace the process injector (CLI ``--chaos``; tests)."""
    global _active
    with _active_lock:
        _active = injector


def reset() -> None:
    """Test hook: drop the injector (next ``active()`` re-reads env)."""
    install(None)


def fire(seam: str, slot: int | None = None) -> None:
    """The hook call sites use. Near-free when chaos is off: one global
    read and one attribute check."""
    inj = active()
    if inj.rules:
        inj.check(seam, slot)
