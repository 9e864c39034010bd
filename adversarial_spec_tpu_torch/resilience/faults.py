"""Structured fault taxonomy + the single ``classify()`` used everywhere.

The PyTorch port's copy of ``adversarial_spec_tpu/resilience/faults.py``.

Before this module, transiency was decided by string-marker lists copied
per call site (engine/tpu.py kept its own tuple); now every seam —
engine chat, scheduler slot eviction, breaker accounting — speaks one
vocabulary:

=============  ==========  =================================================
kind           transient   typical producers
=============  ==========  =================================================
OOM            yes         RESOURCE_EXHAUSTED, HBM exhaustion mid-decode
DEVICE_LOST    yes         UNAVAILABLE, dead ICI tunnel, OUT_OF_RANGE
PREEMPTED      yes         PREEMPTED/ABORTED (maintenance, spot reclaim)
TIMEOUT        yes         DEADLINE_EXCEEDED, wall-clock budget expiry
SHED           no          serve-daemon POLICY refusals (quota/drain load
                           shed) — the model did nothing wrong: never
                           retried, never fed to its circuit breaker
BUG            no          everything else — retrying a TypeError is noise
=============  ==========  =================================================

Transient faults are retried (debate backoff, scheduler retry-once);
BUG is surfaced immediately. SHED is the serving layer speaking, not
the model: ``run_round`` resolves it as an error WITHOUT recording a
breaker failure (a drain storm must not open every opponent's circuit
— found by the SIGTERM drain drill). Injected faults
(resilience/injector.py) carry their kind as an attribute so
classification is exact, not textual.

The module also owns the process-wide fault counters: every classified
fault is ``record()``-ed under ``<seam>.<kind>`` and the CLI drains
``snapshot()`` into the Tracer counters / ``--json`` report.
"""

from __future__ import annotations

import re
import threading
from enum import Enum

from adversarial_spec_tpu_torch import obs as obs_mod
from adversarial_spec_tpu_torch.resilience import lockdep as lockdep_mod


class FaultKind(str, Enum):
    """What failed, independent of which layer noticed."""

    OOM = "oom"
    DEVICE_LOST = "device_lost"
    PREEMPTED = "preempted"
    TIMEOUT = "timeout"
    SHED = "shed"
    BUG = "bug"

    @property
    def transient(self) -> bool:
        """Whether a retry has any chance of succeeding. A SHED is a
        deliberate policy answer — retrying into a draining/over-quota
        daemon is noise, the client's retry_after_s is the contract."""
        return self not in (FaultKind.BUG, FaultKind.SHED)


# Ordered, lowercase substring markers: first matching kind wins. OOM is
# checked first ("resource_exhausted" messages often also say the device
# was unavailable while dying); BUG is the no-match default.
_MARKERS: tuple[tuple[FaultKind, tuple[str, ...]], ...] = (
    # Serve-layer policy refusals first: their messages are ours
    # (serve/sched.py stamps "shed (<reason>):" / "drained:") and must
    # never be mistaken for a device fault by the later markers.
    (FaultKind.SHED, ("shed (", "drained:")),
    (
        FaultKind.OOM,
        ("resource_exhausted", "out of memory", "outofmemory"),
    ),
    (FaultKind.PREEMPTED, ("preempted", "preemption", "aborted")),
    (
        FaultKind.DEVICE_LOST,
        ("unavailable", "device lost", "data_loss", "out_of_range"),
    ),
    (FaultKind.TIMEOUT, ("deadline_exceeded", "timed out", "timeout")),
)

# "OOM" only as an uppercase standalone token: a lowercase substring
# match would classify any message containing room/zoom/bloom as a
# transient OOM and burn retries on permanent bugs.
_OOM_TOKEN = re.compile(r"\bOOM\b")


def classify_message(msg: str) -> FaultKind:
    """Classify from an error STRING (e.g. a ``Completion.error`` that
    crossed the engine boundary and lost its exception object)."""
    if _OOM_TOKEN.search(msg):
        return FaultKind.OOM
    low = msg.lower()
    for kind, markers in _MARKERS:
        if any(m in low for m in markers):
            return kind
    return FaultKind.BUG


def classify(exc: BaseException) -> FaultKind:
    """One classification for every seam.

    Injected faults carry ``fault_kind`` and classify exactly; known
    Python types short-circuit; everything else falls back to the
    message markers (XLA/PJRT surface gRPC-style status codes in text).
    """
    kind = getattr(exc, "fault_kind", None)
    if isinstance(kind, FaultKind):
        return kind
    if isinstance(exc, TimeoutError):
        return FaultKind.TIMEOUT
    if isinstance(exc, MemoryError):
        return FaultKind.OOM
    return classify_message(f"{type(exc).__name__}: {exc}")


def is_transient(exc: BaseException) -> bool:
    return classify(exc).transient


# -- process-wide fault counters ------------------------------------------
# Keyed "<seam>.<kind>" (e.g. "scheduler_chunk.oom"). A module-level
# registry rather than plumbing a Tracer through every engine layer: the
# engine/scheduler sit several calls below the CLI's tracer, and faults
# are rare enough that a lock per event is free.

_lock = lockdep_mod.make_lock("faults._lock")
_counts: dict[str, int] = {}


def record(kind: FaultKind, seam: str) -> None:
    with _lock:
        key = f"{seam}.{kind.value}"
        _counts[key] = _counts.get(key, 0) + 1
    # Mirror into the observability registry: every classified fault is
    # a labeled counter too (the Prometheus-facing shape of the same
    # fact; the scheduler adds eviction-context FaultEvents separately).
    if obs_mod.config().enabled:
        obs_mod.hot.fault(seam, kind.value).inc()


def snapshot() -> dict[str, int]:
    with _lock:
        return dict(_counts)


def reset() -> None:
    with _lock:
        _counts.clear()
