"""Fleet layer: replicated engines behind a prefix-affinity router.

The PyTorch port's copy of ``adversarial_spec_tpu/fleet``: the same ring,
router, failover, handoff ledger, autoscaler, wire protocol and
``perf.fleet`` payload. A replica's engine is the port's (``MockEngine``
for ``mock://``, ``GpuEngine`` for ``tpu://``; in-process replicas on one
card share it, each with its own weights, batchers and prefix cache).
``GpuEngine`` has no disaggregated ``prefill``, as the reference's
``TpuEngine`` has none, so a ``tpu://`` handoff degrades as
``prefill_error`` and the decode replica prefills locally.

One engine process is a single point of failure — a dead process loses
every in-flight round and all device/host KV residency. This package
puts N engine replicas behind a router that

- **routes by prefix affinity** (fleet/hashring.py): the debate's
  affinity key consistent-hashes onto a replica, so every round of the
  same debate lands where its prefix KV already lives, and a membership
  change moves only ~1/N of the keyspace;
- **fails over on health + breakers** (fleet/router.py): per-replica
  heartbeats and per-(replica, model) circuit breakers
  (resilience/breaker.py ``replica_key``) drain a slow or dead replica
  — queued and in-flight requests re-route to the next replica on the
  ring;
- **recovers through the shared store**: replicas share the
  content-addressed disk store, so a failed-over request rehydrates its
  prefix KV on the new replica instead of re-prefilling, and the
  round journal keeps already-completed opponents from re-issuing.

Replicas come in two transports (fleet/replica.py): ``inproc`` wraps a
fresh engine instance in this process (deterministic, tier-1-testable),
``worker`` runs one per subprocess (``python -m
adversarial_spec_tpu_torch.fleet.worker``) — the SIGKILL-able topology the
replica-kill drill drives.

Process-wide config + stats follow the ``procconfig`` pattern shared
with ``interleave``/``spec``/``kvtier``: the CLI arms per round
(``--fleet``, ``--fleet-replicas``; env ``ADVSPEC_FLEET`` /
``ADVSPEC_FLEET_REPLICAS`` / ``ADVSPEC_FLEET_TRANSPORT``) and snapshots
into ``perf.fleet``. Imports no jax and no torch — the mock fleet runs
entirely on CPU.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

from adversarial_spec_tpu_torch.engine import procconfig

DEFAULT_REPLICAS = 2
TRANSPORTS = ("inproc", "worker")

# Elasticity defaults (fleet/autoscale.py). The fractions are of the
# PER-REPLICA backlog capacity (serve's max_backlog_tokens): scale-out
# arms at 0.6 — deliberately BELOW the serve brownout-enter fraction
# (0.75) so capacity is already being added when brownout would start
# shedding batch admissions; scale-in arms only when backlog would fit
# comfortably in one fewer replica. Streaks + cooldown are the
# hysteresis pair: a decision needs N consecutive ticks AND a quiet
# period since the last membership change, so an oscillating load
# trace cannot flap the ring.
DEFAULT_MIN_REPLICAS = 1
DEFAULT_MAX_REPLICAS = 4
DEFAULT_SCALE_OUT_FRACTION = 0.6
DEFAULT_SCALE_IN_FRACTION = 0.15
DEFAULT_SCALE_OUT_TICKS = 2
DEFAULT_SCALE_IN_TICKS = 5
DEFAULT_SCALE_COOLDOWN_S = 5.0
DEFAULT_SCALE_INTERVAL_S = 0.25
DEFAULT_SPAWN_RETRIES = 3

# Disaggregation defaults (fleet/handoff.py + role-aware routing).
# ``prefill_replicas`` > 0 splits the fleet: that many founders carry
# the "prefill" role, the rest "decode", and admissions whose estimated
# prefill exceeds ``handoff_threshold_tokens`` run admission+prefill on
# a prefill replica, publish the produced blocks to the shared store,
# and decode on a decode replica that adopts them from a tier hit.
# 0 keeps the symmetric (un-roled) fleet. The per-role min/max bound
# the role-aware autoscaler.
DEFAULT_PREFILL_REPLICAS = 0
DEFAULT_HANDOFF_THRESHOLD_TOKENS = 256
DEFAULT_MIN_PREFILL_REPLICAS = 1
DEFAULT_MAX_PREFILL_REPLICAS = 2


def env_enabled() -> bool:
    """The process default for the master switch (``ADVSPEC_FLEET``).
    Default OFF: a single engine stays the shipped topology until the
    operator opts a process into the fleet."""
    return os.environ.get("ADVSPEC_FLEET", "0") == "1"


def env_replicas() -> int:
    """The process default replica count (``ADVSPEC_FLEET_REPLICAS``)."""
    try:
        return max(1, int(os.environ.get("ADVSPEC_FLEET_REPLICAS", DEFAULT_REPLICAS)))
    except ValueError:
        return DEFAULT_REPLICAS


def env_transport() -> str:
    """The process default transport (``ADVSPEC_FLEET_TRANSPORT``)."""
    t = os.environ.get("ADVSPEC_FLEET_TRANSPORT", "inproc")
    return t if t in TRANSPORTS else "inproc"


def env_autoscale() -> bool:
    """The process default for elasticity (``ADVSPEC_FLEET_AUTOSCALE``).
    Default OFF: membership stays fixed until the operator opts in."""
    return os.environ.get("ADVSPEC_FLEET_AUTOSCALE", "0") == "1"


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


def env_min_replicas() -> int:
    """The elastic floor (``ADVSPEC_FLEET_MIN``)."""
    return _env_int("ADVSPEC_FLEET_MIN", DEFAULT_MIN_REPLICAS, floor=1)


def env_max_replicas() -> int:
    """The elastic ceiling (``ADVSPEC_FLEET_MAX``)."""
    return _env_int("ADVSPEC_FLEET_MAX", DEFAULT_MAX_REPLICAS, floor=1)


def env_scale_cooldown_s() -> float:
    """Post-membership-change quiet period
    (``ADVSPEC_FLEET_SCALE_COOLDOWN_S``)."""
    return _env_float(
        "ADVSPEC_FLEET_SCALE_COOLDOWN_S", DEFAULT_SCALE_COOLDOWN_S
    )


def env_scale_interval_s() -> float:
    """Autoscaler tick period (``ADVSPEC_FLEET_SCALE_INTERVAL_S``)."""
    return _env_float(
        "ADVSPEC_FLEET_SCALE_INTERVAL_S", DEFAULT_SCALE_INTERVAL_S
    )


def env_prefill_replicas() -> int:
    """Prefill-role founder count (``ADVSPEC_FLEET_PREFILL_REPLICAS``;
    0 = symmetric fleet, no disaggregation)."""
    return _env_int(
        "ADVSPEC_FLEET_PREFILL_REPLICAS", DEFAULT_PREFILL_REPLICAS
    )


def env_handoff_threshold_tokens() -> int:
    """Estimated-prefill-token threshold above which an admission
    routes prefill-first (``ADVSPEC_FLEET_HANDOFF_THRESHOLD``)."""
    return _env_int(
        "ADVSPEC_FLEET_HANDOFF_THRESHOLD",
        DEFAULT_HANDOFF_THRESHOLD_TOKENS,
    )


@dataclass
class FleetConfig:
    """Process-wide knobs, set once per CLI round (or by tests)."""

    enabled: bool = False
    replicas: int = DEFAULT_REPLICAS
    # "inproc" (fresh engine instances in this process) or "worker"
    # (one subprocess per replica — SIGKILL-able, the chaos topology).
    transport: str = "inproc"
    # Per-request transport deadline for worker replicas, seconds: a
    # worker that stays silent this long is treated as dead and its
    # in-flight requests fail over (0 = wait forever).
    request_timeout_s: float = 30.0
    # Elasticity (fleet/autoscale.py): backlog-driven membership. The
    # autoscaler only runs when the serve daemon owns a scheduler to
    # read pressure from; these knobs shape its decisions everywhere
    # (daemon loop, chaos drills, bench arms).
    autoscale: bool = False
    min_replicas: int = DEFAULT_MIN_REPLICAS
    max_replicas: int = DEFAULT_MAX_REPLICAS
    scale_out_fraction: float = DEFAULT_SCALE_OUT_FRACTION
    scale_in_fraction: float = DEFAULT_SCALE_IN_FRACTION
    scale_out_ticks: int = DEFAULT_SCALE_OUT_TICKS
    scale_in_ticks: int = DEFAULT_SCALE_IN_TICKS
    scale_cooldown_s: float = DEFAULT_SCALE_COOLDOWN_S
    scale_interval_s: float = DEFAULT_SCALE_INTERVAL_S
    # Bounded spawn retry (fleet/replica.py spawn_replica): attempts
    # past the first before a typed SpawnFailed aborts the scale-out.
    spawn_retries: int = DEFAULT_SPAWN_RETRIES
    # Disaggregation (fleet/handoff.py): founders carrying the
    # "prefill" role (0 = symmetric fleet), the estimated-prefill
    # threshold that routes an admission prefill-first, and the
    # per-role membership bounds the role-aware autoscaler honors.
    prefill_replicas: int = DEFAULT_PREFILL_REPLICAS
    handoff_threshold_tokens: int = DEFAULT_HANDOFF_THRESHOLD_TOKENS
    min_prefill_replicas: int = DEFAULT_MIN_PREFILL_REPLICAS
    max_prefill_replicas: int = DEFAULT_MAX_PREFILL_REPLICAS


def _coerce_transport(value) -> str:
    v = str(value)
    if v not in TRANSPORTS:
        # Fail AT THE KNOB (the γ precedent): a typo'd transport must
        # not silently fall back to inproc mid-deployment.
        raise ValueError(
            f"unknown fleet transport {v!r}; known: {', '.join(TRANSPORTS)}"
        )
    return v


@dataclass
class FleetStats(procconfig.StatsBase):
    """Process-wide fleet counters, aggregated across every router the
    process builds (one per config generation).

    ``affinity_hits`` counts requests served by the ring's PRIMARY
    choice for their key; ``routed_requests − affinity_hits`` is the
    hop traffic (breaker-open skips + failover re-routes), so
    ``affinity_hit_rate`` is the headline the fleet bench compares
    against random routing. ``reissued_requests`` counts requests that
    were re-routed after their replica died mid-flight — the work a
    replica loss costs; ``duplicated_completions`` counts completions
    that arrived for an already-resolved request and MUST stay zero
    (the lose-a-replica-lose-nothing invariant the chaos harness
    pins)."""

    routed_requests: int = 0
    affinity_hits: int = 0
    failover_hops: int = 0
    breaker_skips: int = 0
    reissued_requests: int = 0
    completed_requests: int = 0
    duplicated_completions: int = 0
    replicas_spawned: int = 0
    replicas_retired: int = 0
    heartbeats: int = 0
    heartbeat_failures: int = 0
    # Elasticity (fleet/autoscale.py): membership changes that
    # completed, spawn attempts that exhausted their bounded retry
    # (``SpawnFailed`` — each one also enters cooldown, so the counter
    # bounds how hot a broken spawn path can loop), and decisions the
    # hysteresis/cooldown pair suppressed (the anti-flap ledger the
    # oscillating-load test pins).
    scale_outs: int = 0
    scale_ins: int = 0
    spawn_failures: int = 0
    flaps_suppressed: int = 0
    # Disaggregation (fleet/handoff.py): cross-replica KV handoffs by
    # terminal outcome. ``handoff_adopted`` = the decode replica's
    # first step started from a tier hit on the shipped blocks;
    # ``handoff_degraded`` = the lost-race fallback (store miss,
    # quarantine, partial publish) re-prefilled locally —
    # byte-identical transcript, just slower; ``handoff_abandoned`` =
    # the prefill side died before publication. ``handoff_shipped_
    # blocks`` counts blocks made durable for a handoff.
    handoff_attempts: int = 0
    handoff_adopted: int = 0
    handoff_degraded: int = 0
    handoff_abandoned: int = 0
    handoff_shipped_blocks: int = 0

    def snapshot(self) -> dict:
        out = self.as_dict()
        out["affinity_hit_rate"] = (
            round(self.affinity_hits / self.routed_requests, 4)
            if self.routed_requests
            else 0.0
        )
        out["handoff_hit_rate"] = (
            round(self.handoff_adopted / self.handoff_attempts, 4)
            if self.handoff_attempts
            else 0.0
        )
        return out


_state = procconfig.ProcState(
    FleetConfig(
        enabled=env_enabled(),
        replicas=env_replicas(),
        transport=env_transport(),
        autoscale=env_autoscale(),
        min_replicas=env_min_replicas(),
        max_replicas=env_max_replicas(),
        scale_cooldown_s=env_scale_cooldown_s(),
        scale_interval_s=env_scale_interval_s(),
        prefill_replicas=env_prefill_replicas(),
        handoff_threshold_tokens=env_handoff_threshold_tokens(),
    ),
    FleetStats(),
    coerce={
        "replicas": lambda v: max(1, int(v)),
        "transport": _coerce_transport,
        "min_replicas": lambda v: max(1, int(v)),
        "max_replicas": lambda v: max(1, int(v)),
        "scale_out_ticks": lambda v: max(1, int(v)),
        "scale_in_ticks": lambda v: max(1, int(v)),
        "scale_cooldown_s": lambda v: max(0.0, float(v)),
        "scale_interval_s": lambda v: max(0.0, float(v)),
        "spawn_retries": lambda v: max(0, int(v)),
        "prefill_replicas": lambda v: max(0, int(v)),
        "handoff_threshold_tokens": lambda v: max(0, int(v)),
        "min_prefill_replicas": lambda v: max(1, int(v)),
        "max_prefill_replicas": lambda v: max(1, int(v)),
    },
)
_config = _state.config
stats = _state.stats


def config() -> FleetConfig:
    return _state.config


def configure(
    enabled: bool | None = None,
    replicas: int | None = None,
    transport: str | None = None,
    request_timeout_s: float | None = None,
    autoscale: bool | None = None,
    min_replicas: int | None = None,
    max_replicas: int | None = None,
    scale_out_fraction: float | None = None,
    scale_in_fraction: float | None = None,
    scale_out_ticks: int | None = None,
    scale_in_ticks: int | None = None,
    scale_cooldown_s: float | None = None,
    scale_interval_s: float | None = None,
    spawn_retries: int | None = None,
    prefill_replicas: int | None = None,
    handoff_threshold_tokens: int | None = None,
    min_prefill_replicas: int | None = None,
    max_prefill_replicas: int | None = None,
) -> FleetConfig:
    return _state.configure(
        enabled=enabled,
        replicas=replicas,
        transport=transport,
        request_timeout_s=request_timeout_s,
        autoscale=autoscale,
        min_replicas=min_replicas,
        max_replicas=max_replicas,
        scale_out_fraction=scale_out_fraction,
        scale_in_fraction=scale_in_fraction,
        scale_out_ticks=scale_out_ticks,
        scale_in_ticks=scale_in_ticks,
        scale_cooldown_s=scale_cooldown_s,
        scale_interval_s=scale_interval_s,
        spawn_retries=spawn_retries,
        prefill_replicas=prefill_replicas,
        handoff_threshold_tokens=handoff_threshold_tokens,
        min_prefill_replicas=min_prefill_replicas,
        max_prefill_replicas=max_prefill_replicas,
    )


def reset_stats() -> None:
    _state.reset_stats()


def snapshot() -> dict:
    """Stats + config, the ``perf.fleet`` payload."""
    return _state.snapshot()


def armed() -> bool:
    """True when requests should route through the fleet: >= 2 replicas
    (a 1-replica fleet is just an engine with extra steps, served by
    the plain dispatch path) — OR an elastic fleet whose CEILING admits
    a second replica, because an autoscaled fleet may legitimately
    start at one replica and grow."""
    if not _config.enabled:
        return False
    if _config.autoscale and _config.max_replicas >= 2:
        return True
    return _config.replicas >= 2


def disagg_armed() -> bool:
    """True when the fleet is split into prefill/decode roles: a
    routable fleet with at least one prefill-role founder AND at least
    one decode replica left over."""
    return (
        armed()
        and _config.prefill_replicas > 0
        and _config.replicas > _config.prefill_replicas
    )


# -- the process fleet engine ----------------------------------------------
# Built lazily on first armed dispatch, rebuilt when the knobs that
# shape the topology change (the GpuEngine batcher_key precedent), and
# torn down explicitly by tests / the worker-transport harnesses.

_engine = None
_engine_key = None


def _topology_key():
    """(founder count, rebuild key) for the current config. Elastic
    founders start inside [floor, ceiling] — typically AT the floor,
    growing on demand (the bench's elastic arm). The prefill-role
    founder count shapes the topology too: flipping disaggregation on
    or off rebuilds the fleet with the roles re-tagged."""
    n = _config.replicas
    if _config.autoscale:
        n = max(_config.min_replicas, min(n, _config.max_replicas))
    return n, (
        n,
        _config.autoscale,
        _config.transport,
        _config.request_timeout_s,
        _config.prefill_replicas,
    )


def fleet_engine():
    """The process-wide FleetEngine for the current config (lazy; a
    config change retires the old fleet and builds a fresh one)."""
    global _engine, _engine_key
    n, key = _topology_key()
    if _engine is not None and _engine_key != key:
        _engine.shutdown()
        _engine = None
    if _engine is None:
        from adversarial_spec_tpu_torch.fleet.router import FleetEngine

        _engine = FleetEngine(
            replicas=n,
            transport=_config.transport,
            request_timeout_s=_config.request_timeout_s,
            prefill_replicas=_config.prefill_replicas,
        )
        _engine_key = key
    return _engine


def install_engine(engine) -> None:
    """Replace the process fleet engine with a caller-built topology
    (harnesses and tests that need explicit worker envs / log dirs /
    kill triggers). The installed engine serves until the topology
    knobs change or ``shutdown_fleet`` runs."""
    global _engine, _engine_key
    if _engine is not None and _engine is not engine:
        _engine.shutdown()
    _engine = engine
    _engine_key = _topology_key()[1]


def shutdown_fleet() -> None:
    """Tear down the process fleet (tests; worker harness cleanup)."""
    global _engine, _engine_key
    if _engine is not None:
        _engine.shutdown()
    _engine = None
    _engine_key = None
