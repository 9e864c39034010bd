"""``advspec serve`` — the overload-safe persistent serving daemon.

One CLI invocation has always been one debate round; this package is
the layer between the engine core and its many users: a long-lived
process (``serve`` / ``python -m adversarial_spec_tpu_torch.serve``)
that runs MANY concurrent debates against the shared per-model
batchers, over a line-delimited JSON request/stream transport on a
local unix socket (the per-token transport of the streaming layer).
The robustness core, in dependency order:

- **admission control** (serve/sched.py ``try_admit``): bounded
  per-tenant queues and an estimated-token-backlog cap; past either,
  an arrival storm degrades to TYPED, retry-after-carrying refusals
  (serve/protocol.py ``SHED_REASONS``) instead of latency collapse.
- **fair-share scheduling** (serve/sched.py ``ServeScheduler``): a
  stride/deficit scheduler interleaves opponent requests from
  concurrent debates into the shared engine by per-tenant token
  accounting — quotas enforced at admission and dispatch, passes
  debited with the ACTUAL tokens each completion paid (``Usage``).
- **priority tiers**: interactive vs batch-critique classes. An
  interactive arrival that out-waits its grace while a batch unit
  occupies the engine triggers policy-driven preemption — the running
  batch request's stream consumer returns False, the batcher releases
  its slot through the SAME ``_release_slot`` surgery early-cancel
  uses (partial KV salvaged into the prefix cache), and the unit
  re-queues for re-admission. Sustained overload enters a declared
  **brownout** (speculation γ lowered, batch tier paused) before any
  interactive shed.
- **graceful drain**: SIGTERM (or the ``drain`` op) stops admissions,
  lets in-flight debates finish or journal-commit (the round journal
  makes a drain-deadline kill lossless), sheds the queue with typed
  ``draining`` refusals, and exits 0 with a drain report.

The port's copy of ``adversarial_spec_tpu/serve``: the same state
machine, wire protocol and drain contract. Where it meets the port's
engine: the one pump thread (serve/gate.py) is the only thread that
calls ``GpuEngine`` (all CUDA work, the first-use kernel build
included), preemption releases the batcher's slot through its
``_release_slot`` surgery, and brownout retunes the speculation γ the
engine re-reads at its next dispatch. With the fleet armed, the gate
wraps the process ``FleetEngine`` and the pump thread drives its replicas.

Process-wide config + stats follow the ``procconfig`` pattern shared
with ``interleave``/``spec``/``kvtier``/``fleet``; the daemon arms the
config ONCE at startup (it deliberately does not run the CLI's
per-invocation reset cascade mid-serve — see obs/trace.py's daemon
scopes). Imports no jax and no torch: the mock-engine daemon pins the
whole state machine on CPU.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

from adversarial_spec_tpu_torch.engine import procconfig

DEFAULT_QUEUE_DEPTH = 8
DEFAULT_BACKLOG_TOKENS = 65536
DEFAULT_DRAIN_DEADLINE_S = 5.0
DEFAULT_BROWNOUT_GAMMA = 2
# Brownout hysteresis: enter when the estimated backlog crosses
# enter_fraction * max_backlog_tokens, exit below exit_fraction — the
# declared degradation step BEFORE any interactive shed (a hard shed
# needs the full cap).
DEFAULT_BROWNOUT_ENTER_FRACTION = 0.75
DEFAULT_BROWNOUT_EXIT_FRACTION = 0.5


def _env_int(name: str, default: int, floor: int = 0) -> int:
    try:
        return max(floor, int(os.environ.get(name, default)))
    except ValueError:
        return default


def _env_float(name: str, default: float, floor: float = 0.0) -> float:
    try:
        return max(floor, float(os.environ.get(name, default)))
    except ValueError:
        return default


def env_queue_depth() -> int:
    """Per-tenant outstanding-debate cap (``ADVSPEC_SERVE_QUEUE_DEPTH``)."""
    return _env_int("ADVSPEC_SERVE_QUEUE_DEPTH", DEFAULT_QUEUE_DEPTH, 1)


def env_backlog_tokens() -> int:
    """Estimated-token-backlog cap (``ADVSPEC_SERVE_BACKLOG_TOKENS``)."""
    return _env_int(
        "ADVSPEC_SERVE_BACKLOG_TOKENS", DEFAULT_BACKLOG_TOKENS, 1
    )


def env_quota_tokens() -> int:
    """Per-tenant token quota, 0 = unlimited
    (``ADVSPEC_SERVE_QUOTA_TOKENS``; refillable via the ``refill``
    protocol op)."""
    return _env_int("ADVSPEC_SERVE_QUOTA_TOKENS", 0)


def env_drain_deadline_s() -> float:
    """Graceful-drain deadline before queued work is shed
    (``ADVSPEC_SERVE_DRAIN_DEADLINE_S``)."""
    return _env_float(
        "ADVSPEC_SERVE_DRAIN_DEADLINE_S", DEFAULT_DRAIN_DEADLINE_S
    )


def env_ttft_slo_ms() -> float:
    """Interactive-tier TTFT SLO budget in milliseconds — the
    preemption policy's trigger (``ADVSPEC_SERVE_TTFT_SLO_MS``; 0 =
    preempt the moment an interactive unit waits behind batch)."""
    return _env_float("ADVSPEC_SERVE_TTFT_SLO_MS", 0.0)


@dataclass
class ServeConfig:
    """Process-wide knobs, armed once at daemon startup (or by tests)."""

    # Admission: per-tenant outstanding-debate cap and the estimated
    # token backlog past which NEW admissions shed (typed, retry-after).
    max_queue_depth: int = DEFAULT_QUEUE_DEPTH
    max_backlog_tokens: int = DEFAULT_BACKLOG_TOKENS
    # Per-tenant token quota (0 = unlimited). Enforced at admission
    # (whole debates) and at dispatch (per opponent unit: exhaustion
    # mid-round sheds the REMAINING opponents, the round still
    # commits); debited with actual Usage tokens on completion.
    tenant_quota_tokens: int = 0
    # Graceful drain: how long SIGTERM waits for in-flight debates
    # before shedding the queue and cancelling running units.
    drain_deadline_s: float = DEFAULT_DRAIN_DEADLINE_S
    # Brownout (declared degradation before interactive shed).
    brownout_enter_fraction: float = DEFAULT_BROWNOUT_ENTER_FRACTION
    brownout_exit_fraction: float = DEFAULT_BROWNOUT_EXIT_FRACTION
    brownout_gamma: int = DEFAULT_BROWNOUT_GAMMA
    # Preemption policy: an interactive unit that has waited this long
    # while a batch unit holds the engine preempts it (0 = immediately).
    # When interactive_ttft_slo_ms is set, the grace defaults to half
    # the SLO budget — preempt BEFORE the breach, not after.
    preempt_grace_s: float = 0.0
    interactive_ttft_slo_ms: float = 0.0
    # Same-model opponent units batched into one engine chat dispatch
    # (N rows of one batched decode on the real engine).
    max_dispatch_batch: int = 4
    # Debate round drivers running concurrently (worker threads).
    max_debates_in_flight: int = 32


@dataclass
class ServeStats(procconfig.StatsBase):
    """Process-wide serving counters, aggregated since daemon start.

    The shed-not-collapse ledger the overload chaos drill audits:
    ``accepted_debates`` must equal ``completed_debates`` (+ the
    journal-resumable remainder a drain left) and every refusal is in
    ``shed_debates`` — nothing is ever silently dropped.
    ``units_preempted`` counts batch units cancelled for tier pressure
    (each re-queues: ``units_readmitted``); ``shed_fraction`` is the
    headline BENCH_serve pins at the kx-capacity point."""

    accepted_debates: int = 0
    completed_debates: int = 0
    shed_debates: int = 0
    units_dispatched: int = 0
    units_completed: int = 0
    units_shed: int = 0
    units_preempted: int = 0
    units_readmitted: int = 0
    units_drained: int = 0
    brownout_entries: int = 0
    brownout_exits: int = 0
    tokens_charged: int = 0
    preempted_partial_tokens: int = 0

    def snapshot(self) -> dict:
        out = self.as_dict()
        offered = self.accepted_debates + self.shed_debates
        out["shed_fraction"] = (
            round(self.shed_debates / offered, 4) if offered else 0.0
        )
        return out


_state = procconfig.ProcState(
    ServeConfig(
        max_queue_depth=env_queue_depth(),
        max_backlog_tokens=env_backlog_tokens(),
        tenant_quota_tokens=env_quota_tokens(),
        drain_deadline_s=env_drain_deadline_s(),
        interactive_ttft_slo_ms=env_ttft_slo_ms(),
    ),
    ServeStats(),
    coerce={
        "max_queue_depth": lambda v: max(1, int(v)),
        "max_backlog_tokens": lambda v: max(1, int(v)),
        "tenant_quota_tokens": lambda v: max(0, int(v)),
        "drain_deadline_s": lambda v: max(0.0, float(v)),
        "brownout_gamma": lambda v: max(1, int(v)),
        "max_dispatch_batch": lambda v: max(1, int(v)),
        "max_debates_in_flight": lambda v: max(1, int(v)),
    },
)
_config = _state.config
stats = _state.stats


def config() -> ServeConfig:
    return _state.config


def configure(
    max_queue_depth: int | None = None,
    max_backlog_tokens: int | None = None,
    tenant_quota_tokens: int | None = None,
    drain_deadline_s: float | None = None,
    brownout_enter_fraction: float | None = None,
    brownout_exit_fraction: float | None = None,
    brownout_gamma: int | None = None,
    preempt_grace_s: float | None = None,
    interactive_ttft_slo_ms: float | None = None,
    max_dispatch_batch: int | None = None,
    max_debates_in_flight: int | None = None,
) -> ServeConfig:
    return _state.configure(
        max_queue_depth=max_queue_depth,
        max_backlog_tokens=max_backlog_tokens,
        tenant_quota_tokens=tenant_quota_tokens,
        drain_deadline_s=drain_deadline_s,
        brownout_enter_fraction=brownout_enter_fraction,
        brownout_exit_fraction=brownout_exit_fraction,
        brownout_gamma=brownout_gamma,
        preempt_grace_s=preempt_grace_s,
        interactive_ttft_slo_ms=interactive_ttft_slo_ms,
        max_dispatch_batch=max_dispatch_batch,
        max_debates_in_flight=max_debates_in_flight,
    )


def reset_stats() -> None:
    _state.reset_stats()


def snapshot() -> dict:
    """Stats + config, the ``perf.serve`` / daemon ``stats`` payload."""
    return _state.snapshot()
