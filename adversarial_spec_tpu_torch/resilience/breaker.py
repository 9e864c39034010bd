"""Per-model circuit breakers: skip persistently failing opponents.

The PyTorch port's copy of ``adversarial_spec_tpu/resilience/breaker.py``.

The reference retries every failing model 3x with backoff *every round*
(models.py:46-47) — fine for HTTP 429s, wasteful for a TPU opponent whose
checkpoint server is down or whose mesh OOMs deterministically: each
round burns the full retry budget re-proving the same failure. A breaker
remembers.

State machine (classic three-state):

    CLOSED --[threshold consecutive failures]--> OPEN
    OPEN   --[cooldown elapsed]---------------> HALF_OPEN (one probe)
    HALF_OPEN --[probe succeeds]--------------> CLOSED
    HALF_OPEN --[probe fails]-----------------> OPEN (cooldown restarts)

``debate.core.run_round`` consults ``allow(model)`` before grouping
requests: a model whose breaker is open is degraded immediately (an
errored ModelResponse, zero engine calls, zero retry budget) and
re-admitted via the half-open probe after ``cooldown_s``. Transitions are
counted for the Tracer / ``--json`` report.

The default registry is process-global (the CLI configures it from
``--breaker-*`` flags); tests build their own with a fake clock.
"""

from __future__ import annotations

import os
import threading
import time

from adversarial_spec_tpu_torch import obs as obs_mod
from adversarial_spec_tpu_torch.resilience import lockdep as lockdep_mod
from adversarial_spec_tpu_torch.resilience.faults import FaultKind

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"

# A half-open probe that fails with a NON-TRANSIENT fault (FaultKind.BUG
# — a deterministic error no amount of waiting clears) re-opens HARD:
# the cooldown scales by this factor, so the registry stops burning one
# failed probe per cooldown on a model that cannot recover by itself,
# while still re-probing eventually (a redeploy does fix bugs).
HARD_OPEN_FACTOR = 8.0


def replica_key(replica: str, model: str) -> str:
    """The breaker key for one (replica, model) pair — the fleet
    router's generalization of the per-model breaker: replica r0
    failing a model must not ban the model on r1, and a model failing
    everywhere still opens each pair (plus the debate layer's bare
    per-model breaker). The registry is keyed by opaque strings, so
    pairs and bare models coexist in one registry."""
    return f"{replica}::{model}"


class CircuitBreaker:
    """Breaker for ONE model. Not thread-safe on its own — the registry
    serializes access (one lock for all breakers keeps the hot path to a
    single acquire)."""

    def __init__(
        self,
        *,
        threshold: int = 3,
        cooldown_s: float = 30.0,
        clock=time.monotonic,
        name: str = "",
    ):
        self.threshold = max(1, int(threshold))
        self.cooldown_s = float(cooldown_s)
        self._clock = clock
        self.name = name  # model id, for transition events
        self.state = CLOSED
        self.failures = 0  # consecutive failures while closed
        self.opened_at: float | None = None
        self.last_fault: FaultKind | None = None
        # Set when a half-open probe failed NON-transiently: the next
        # re-probe waits HARD_OPEN_FACTOR cooldowns (see module note).
        self.hard_open = False
        self._probe_inflight = False
        self._probe_started = 0.0
        # Monotonic per-target-state transition counts (telemetry source
        # of truth) plus a bounded (from, to) log for debugging flaps.
        self.transition_counts: dict[str, int] = {}
        self.transitions: list[tuple[str, str]] = []

    def _set(self, state: str) -> None:
        if state != self.state:
            self.transition_counts[state] = (
                self.transition_counts.get(state, 0) + 1
            )
            self.transitions.append((self.state, state))
            del self.transitions[:-64]
            # Transitions are EVENTS now, not just counters: the flight
            # recorder shows when a model tripped relative to the steps
            # around it (docs/resilience.md).
            obs_mod.emit(
                obs_mod.BreakerEvent(
                    model=self.name, frm=self.state, to=state
                )
            )
            if obs_mod.config().enabled:
                obs_mod.hot.breaker(state).inc()
            self.state = state

    def effective_cooldown(self) -> float:
        """The wait before the next half-open probe: the configured
        cooldown, scaled up when the LAST probe failed non-transiently
        (a BUG does not heal by waiting — probe rarely, not never)."""
        return self.cooldown_s * (HARD_OPEN_FACTOR if self.hard_open else 1.0)

    def allow(self) -> bool:
        """May this model be queried right now? Transitions OPEN →
        HALF_OPEN when the cooldown has elapsed; in HALF_OPEN exactly one
        probe is outstanding at a time."""
        if self.state == CLOSED:
            return True
        if self.state == OPEN:
            if self._clock() - (self.opened_at or 0.0) >= self.effective_cooldown():
                self._set(HALF_OPEN)
                self._probe_inflight = True
                self._probe_started = self._clock()
                return True
            return False
        # HALF_OPEN: one probe at a time — but a probe whose outcome was
        # never recorded (caller crashed mid-round) must not ban the
        # model forever, so a probe older than the cooldown is presumed
        # lost and a new one is admitted.
        if self._probe_inflight:
            if self._clock() - self._probe_started < self.cooldown_s:
                return False
        self._probe_inflight = True
        self._probe_started = self._clock()
        return True

    def record_success(self) -> None:
        self._probe_inflight = False
        self.failures = 0
        self.last_fault = None
        self.hard_open = False
        self._set(CLOSED)

    def record_failure(self, kind: FaultKind = FaultKind.BUG) -> None:
        self._probe_inflight = False
        self.last_fault = kind
        if self.state == HALF_OPEN:
            # Failed probe: straight back to OPEN, cooldown restarts.
            # A TRANSIENT probe fault (OOM, preemption, timeout) may
            # clear by itself, so the normal cooldown re-probes; a
            # NON-transient one (FaultKind.BUG — deterministic) opens
            # HARD: re-probing every cooldown would burn one failed
            # request per cycle proving the same bug, so the next probe
            # waits HARD_OPEN_FACTOR cooldowns instead.
            self.hard_open = not kind.transient
            self.opened_at = self._clock()
            self.failures = 0
            self._set(OPEN)
            return
        self.failures += 1
        if self.failures >= self.threshold:
            self.opened_at = self._clock()
            self.failures = 0
            self._set(OPEN)


class BreakerRegistry:
    """All models' breakers + shared policy knobs."""

    def __init__(
        self,
        *,
        threshold: int = 3,
        cooldown_s: float = 30.0,
        clock=time.monotonic,
        enabled: bool = True,
    ):
        self.threshold = threshold
        self.cooldown_s = cooldown_s
        self.enabled = enabled
        self._clock = clock
        self._lock = lockdep_mod.make_lock("BreakerRegistry._lock")
        self._breakers: dict[str, CircuitBreaker] = {}

    def configure(
        self,
        *,
        threshold: int | None = None,
        cooldown_s: float | None = None,
        enabled: bool | None = None,
    ) -> None:
        """Retune policy; applies to existing breakers too (operators
        adjust a live process via the CLI flags)."""
        with self._lock:
            if threshold is not None:
                self.threshold = max(1, int(threshold))
            if cooldown_s is not None:
                self.cooldown_s = float(cooldown_s)
            if enabled is not None:
                self.enabled = bool(enabled)
            for b in self._breakers.values():
                b.threshold = self.threshold
                b.cooldown_s = self.cooldown_s

    def breaker(self, model: str) -> CircuitBreaker:
        with self._lock:
            b = self._breakers.get(model)
            if b is None:
                b = CircuitBreaker(
                    threshold=self.threshold,
                    cooldown_s=self.cooldown_s,
                    clock=self._clock,
                    name=model,
                )
                self._breakers[model] = b
            return b

    def allow(self, model: str) -> bool:
        if not self.enabled:
            return True
        b = self.breaker(model)
        with self._lock:
            return b.allow()

    def record(self, model: str, ok: bool, kind: FaultKind | None = None) -> None:
        if not self.enabled:
            return
        b = self.breaker(model)
        with self._lock:
            if ok:
                b.record_success()
            else:
                b.record_failure(kind or FaultKind.BUG)

    def cooldown_remaining(self, model: str) -> float:
        b = self.breaker(model)
        with self._lock:
            if b.state != OPEN or b.opened_at is None:
                return 0.0
            return max(
                0.0,
                b.effective_cooldown() - (self._clock() - b.opened_at),
            )

    def states(self) -> dict[str, dict]:
        """Per-model snapshot for the ``--json`` resilience report."""
        with self._lock:
            return {
                model: {
                    "state": b.state,
                    "consecutive_failures": b.failures,
                    "last_fault": b.last_fault.value if b.last_fault else None,
                }
                for model, b in self._breakers.items()
            }

    def counters(self) -> dict[str, float]:
        """Aggregate transition counts, Tracer-counter shaped. Backed by
        the monotonic per-breaker counters, not the bounded debug log —
        a model flapping hundreds of times must not undercount."""
        out: dict[str, float] = {}
        with self._lock:
            for b in self._breakers.values():
                for to, n in b.transition_counts.items():
                    key = f"breaker.to_{to}"
                    out[key] = out.get(key, 0.0) + n
        return out

    # -- cross-process persistence (session resume) ------------------------
    # The CLI runs ONE round per process; without persistence every round
    # would restart with fresh (closed) breakers and the skip policy
    # would never fire in the shipped deployment. The snapshot rides on
    # SessionState and is restored on --resume. opened_at is a monotonic
    # timestamp, meaningless across processes, so OPEN circuits persist
    # their REMAINING cooldown instead.

    def snapshot_for_resume(self) -> dict:
        with self._lock:
            out = {}
            for model, b in self._breakers.items():
                if b.state == CLOSED and b.failures == 0:
                    continue  # default state: nothing worth persisting
                remaining = 0.0
                if b.state in (OPEN, HALF_OPEN) and b.opened_at is not None:
                    remaining = max(
                        0.0,
                        b.effective_cooldown() - (self._clock() - b.opened_at),
                    )
                out[model] = {
                    # A probe that never reported is presumed lost: a
                    # HALF_OPEN circuit resumes as OPEN with no cooldown
                    # left, so the next round re-probes immediately.
                    "state": OPEN if b.state == HALF_OPEN else b.state,
                    "failures": b.failures,
                    "cooldown_remaining": remaining,
                    "hard": b.hard_open,
                    "last_fault": b.last_fault.value if b.last_fault else None,
                }
            return out

    def restore(self, snapshot: dict) -> None:
        for model, data in (snapshot or {}).items():
            b = self.breaker(model)
            with self._lock:
                b.failures = int(data.get("failures", 0))
                last = data.get("last_fault")
                b.last_fault = FaultKind(last) if last else None
                b.hard_open = bool(data.get("hard", False))
                if data.get("state") == OPEN:
                    # Not a transition (no counter): resumed state.
                    b.state = OPEN
                    remaining = float(data.get("cooldown_remaining", 0.0))
                    b.opened_at = self._clock() - (
                        b.effective_cooldown() - remaining
                    )


# -- default process registry ---------------------------------------------

_default: BreakerRegistry | None = None
_default_lock = lockdep_mod.make_lock("breaker._default_lock")


def default_registry() -> BreakerRegistry:
    """The process-wide registry (env-tunable defaults; CLI flags win)."""
    global _default
    with _default_lock:
        if _default is None:
            _default = BreakerRegistry(
                threshold=int(os.environ.get("ADVSPEC_BREAKER_THRESHOLD", 3)),
                cooldown_s=float(
                    os.environ.get("ADVSPEC_BREAKER_COOLDOWN", 30.0)
                ),
            )
        return _default


def reset_default_registry() -> None:
    """Test hook: drop all breaker state."""
    global _default
    with _default_lock:
        _default = None
