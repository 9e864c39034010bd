"""Observability subsystem: metrics registry + flight recorder + retrace watch.

The PyTorch port's copy of ``adversarial_spec_tpu/obs/__init__.py``.

Before it every subsystem kept private counters; this package is the
shared substrate (the north-star metric — per-round wall / tokens/sec/chip
— needs ONE place the next perf PRs read from):

- ``metrics`` — the process-wide :class:`MetricsRegistry` (counters,
  gauges, fixed-bucket histograms; ``snapshot()`` + ``render_prometheus()``).
- ``recorder`` — the process-wide :class:`FlightRecorder` ring of typed
  events (Step/Request/Fault/Breaker/Cache/Compile/Spec/Swap/Span);
  dumped as JSONL on demand (``--events-out``) and automatically on
  fault/timeout eviction and per-request SLO breach.
- ``retrace`` — the :class:`RetraceWatch` counting jit compiles per
  program and flagging unexpected recompiles in the report.
- ``trace`` — causal trace/span ids (one trace per debate round, one
  span per opponent request) every event carries, minted by the debate
  layer and propagated down to the device-step emit sites.

Process-wide config + reset semantics follow the established
``resilience.faults`` / ``prefix_cache`` / ``interleave`` pattern: the
CLI arms per round (``--events-out``, ``--metrics-out``,
``--flight-recorder-size``), stats reset per invocation, engines keep
live handles. Pure stdlib, imports no jax and nothing from engine/ or
resilience/ (they all import obs; cycles are impossible this way).

The one hot-path concession: every emit goes through module-level
``emit()`` / ``record_sync()`` which check ``enabled`` first — when obs
is off the serving path pays a single attribute load per site.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass

from adversarial_spec_tpu_torch.obs import trace  # noqa: F401 (re-export)
from adversarial_spec_tpu_torch.obs.events import (  # noqa: F401 (re-export)
    BreakerEvent,
    CacheEvent,
    CancelEvent,
    CompileEvent,
    EVENT_FIELDS,
    FaultEvent,
    FlightRecorder,
    JournalEvent,
    RecoveryEvent,
    ReplicaEvent,
    RequestEvent,
    RouteEvent,
    LockEvent,
    ScaleEvent,
    ServeEvent,
    SpanEvent,
    SpecEvent,
    StepEvent,
    SwapEvent,
    WeightEvent,
    atomic_write_text,
    validate_event,
)
from adversarial_spec_tpu_torch.obs.metrics import (  # noqa: F401 (re-export)
    LATENCY_BUCKETS_S,
    RATIO_BUCKETS,
    MetricsRegistry,
)
from adversarial_spec_tpu_torch.obs.retrace import RetraceWatch

DEFAULT_RECORDER_SIZE = 512


@dataclass
class ObsConfig:
    """Process-wide knobs, set once per CLI round (or by tests)."""

    enabled: bool = True
    recorder_size: int = DEFAULT_RECORDER_SIZE
    # Where the end-of-round event JSONL lands. Armed by --events-out;
    # fault/timeout auto-dumps write to a sibling path derived from it
    # (``<stem>.<trigger>.jsonl``) so the final dump can never clobber
    # the fault-time snapshot (no path = no auto-dump).
    events_out: str | None = None
    dump_on_fault: bool = True
    # Per-request SLO budgets (0 = disabled). A request breaching its
    # budget arms ONE automatic flight-recorder dump scoped to its
    # trace (same sibling-file discipline as fault dumps), so slow
    # requests self-capture in production: ``slo_ttft_ms`` bounds the
    # request's own prefill wall through its first sampled token,
    # ``slo_round_s`` its full service wall (prefill + decode).
    slo_ttft_ms: float = 0.0
    slo_round_s: float = 0.0
    # Arrival capture (``ADVSPEC_OBS_ARRIVALS``): stamp admission-edge
    # events (RequestEvent/ServeEvent ``arrival_s``) with a monotonic
    # offset from the obs epoch so tools/load_replay.py can reconstruct
    # arrival processes. DEFAULT OFF: real walls on mock events would
    # break the byte-determinism pins every mock dump carries.
    arrivals: bool = False


def env_enabled() -> bool:
    """The process default for the master switch (``ADVSPEC_OBS``)."""
    return os.environ.get("ADVSPEC_OBS", "1") != "0"


def env_recorder_size() -> int:
    """The process default ring size (``ADVSPEC_FLIGHT_RECORDER_SIZE``)."""
    try:
        n = int(
            os.environ.get(
                "ADVSPEC_FLIGHT_RECORDER_SIZE", DEFAULT_RECORDER_SIZE
            )
        )
    except ValueError:
        n = DEFAULT_RECORDER_SIZE
    return max(1, n)


def _env_float(name: str) -> float:
    try:
        return max(0.0, float(os.environ.get(name, "0") or "0"))
    except ValueError:
        return 0.0


def env_slo_ttft_ms() -> float:
    """Process default per-request TTFT budget (``ADVSPEC_SLO_TTFT_MS``,
    milliseconds; 0 = disabled)."""
    return _env_float("ADVSPEC_SLO_TTFT_MS")


def env_slo_round_s() -> float:
    """Process default per-request service budget
    (``ADVSPEC_SLO_ROUND_S``, seconds; 0 = disabled)."""
    return _env_float("ADVSPEC_SLO_ROUND_S")


def env_arrivals() -> bool:
    """Process default for arrival capture (``ADVSPEC_OBS_ARRIVALS``;
    default OFF — the mock byte-determinism pins depend on it)."""
    return os.environ.get("ADVSPEC_OBS_ARRIVALS", "0") == "1"


_config = ObsConfig(
    enabled=env_enabled(),
    recorder_size=env_recorder_size(),
    events_out=os.environ.get("ADVSPEC_EVENTS_OUT") or None,
    slo_ttft_ms=env_slo_ttft_ms(),
    slo_round_s=env_slo_round_s(),
    arrivals=env_arrivals(),
)
# The arrival epoch: ``arrival_s`` offsets are monotonic seconds since
# this point, re-based by reset_stats() so one CLI invocation (or one
# replay run) starts its arrival clock at ~0.
_arrival_t0 = time.monotonic()
# (kind, span_id) pairs that already fired their SLO capture — the
# exactly-once-per-breaching-request guard; cleared by reset_stats().
_slo_fired: set[tuple[str, str]] = set()

metrics = MetricsRegistry()
recorder = FlightRecorder(
    size=_config.recorder_size, enabled=_config.enabled
)
# Route through emit() (defined below; resolved at call time) so
# CompileEvents pick up the ambient trace/span like every other event.
retrace = RetraceWatch(emit=lambda ev: emit(ev))


class HotMetrics:
    """Cached handles into the fixed serving-path metric catalog.

    The registry returns the same object for the same name+labels and
    ``reset()`` zeroes in place, so handles cached once at import stay
    live for the life of the process — hot emit sites (the drive loops,
    the mock's per-request accounting) pay one attribute load per
    observation instead of a lock acquire + label-key build per call.
    Label-dynamic families (sync reasons, fault seam/kind, breaker
    target states) get small per-label dicts, filled on first use.
    """

    __slots__ = (
        "ttft",
        "step_wall",
        "inter_token",
        "prefill_chunk",
        "pool_util",
        "hit_ratio",
        "req_finished",
        "req_evicted",
        "req_timeout",
        "mock_chat_requests",
        "spec_tokens_per_step",
        "spec_acceptance",
        "cancel_tokens_saved",
        "journal_fsync",
        "fleet_replicas_alive",
        "fleet_replicas_desired",
        "fleet_affinity_ratio",
        "serve_backlog",
        "serve_queue_wait",
        "weight_resident",
        "handoff_latency",
        "_m",
        "_sync",
        "_fault",
        "_breaker",
        "_tier_hit",
        "_swap",
        "_cancel",
        "_route",
        "_replica_op",
        "_fleet_scale",
        "_serve_op",
        "_serve_shed",
        "_weight_swap",
        "_handoff",
        "_lock_hold",
        "_lock_wait",
    )

    def __init__(self, m: MetricsRegistry) -> None:
        self._m = m
        self.ttft = m.histogram(
            "advspec_ttft_seconds",
            help="admission prefill through first sampled token",
        )
        self.step_wall = m.histogram(
            "advspec_step_wall_seconds",
            help="drive-loop iteration wall (dispatch+fetch)",
        )
        self.inter_token = m.histogram(
            "advspec_inter_token_seconds",
            help="step wall / decode-chunk budget",
        )
        self.prefill_chunk = m.histogram(
            "advspec_prefill_chunk_wall_seconds",
            help="standalone (stalled) admission prefill chunk wall",
        )
        self.pool_util = m.gauge(
            "advspec_page_pool_utilization",
            help="fraction of KV pages allocated",
        )
        self.hit_ratio = m.gauge(
            "advspec_prefix_cache_hit_ratio",
            help="prefix-cache lookup hit ratio (this round)",
        )
        self.req_finished = m.counter(
            "advspec_requests_total",
            help="resolved requests by outcome",
            outcome="finished",
        )
        self.req_evicted = m.counter(
            "advspec_requests_total", outcome="evicted"
        )
        self.req_timeout = m.counter(
            "advspec_requests_total", outcome="timeout"
        )
        self.mock_chat_requests = m.counter(
            "advspec_engine_chat_requests_total",
            help="chat requests by serving engine",
            engine="mock",
        )
        # Speculative decoding (engine/scheduler.py spec steps and the
        # mock's deterministic acceptance model): tokens each row
        # emitted per verify step (1 = a fully rejected draft, γ+1 = a
        # fully accepted one), and per-request acceptance rate at
        # completion.
        self.spec_tokens_per_step = m.histogram(
            "advspec_spec_tokens_per_step",
            help="tokens emitted per row per speculative verify step",
            buckets=(1.0, 2.0, 3.0, 4.0, 6.0, 8.0, 12.0, 16.0, 32.0),
        )
        self.spec_acceptance = m.histogram(
            "advspec_spec_acceptance_ratio",
            help="per-request accepted/drafted ratio at completion",
            buckets=RATIO_BUCKETS,
        )
        # Streaming early-convergence cancellation (engine/streaming.py):
        # budget tokens each cancelled request never decoded — the
        # capacity the cancellation converted back into served traffic.
        self.cancel_tokens_saved = m.histogram(
            "advspec_cancel_tokens_saved",
            help="decode-budget tokens saved per cancelled request",
            buckets=(
                8.0, 16.0, 32.0, 64.0, 128.0, 256.0, 512.0, 1024.0,
                2048.0, 4096.0,
            ),
        )
        # Round-journal durability tax (debate/journal.py): the wall of
        # each fsync'd record append — the price of crash-safe rounds,
        # kept visible so a slow disk shows up as a fat tail here
        # instead of as mystery round latency.
        self.journal_fsync = m.histogram(
            "advspec_journal_fsync_seconds",
            help="round-journal fsync'd append wall",
        )
        # Fleet topology (fleet/router.py): routable replica count and
        # the round's affinity hit ratio (requests the ring's PRIMARY
        # choice actually served — failover and breaker-open hops
        # lower it, which is exactly what the gauge is for).
        self.fleet_replicas_alive = m.gauge(
            "advspec_fleet_replicas_alive",
            help="routable engine replicas in the fleet ring",
        )
        self.fleet_affinity_ratio = m.gauge(
            "advspec_fleet_affinity_hit_ratio",
            help="requests served by their affinity-primary replica "
            "(this round)",
        )
        # Elastic fleet (fleet/autoscale.py): the autoscaler's target
        # population next to the actual ring population
        # (fleet_replicas_alive above) — a persistent desired > actual
        # gap is a spawn-failure loop, visible without reading events.
        self.fleet_replicas_desired = m.gauge(
            "advspec_fleet_replicas_desired",
            help="autoscaler target replica count (actual is "
            "advspec_fleet_replicas_alive)",
        )
        # Serve daemon (adversarial_spec_tpu/serve): the scheduler's
        # estimated token backlog (the admission-control pressure
        # signal) and per-unit queue wait (admission -> dispatch — the
        # fairness the stride scheduler is accountable for).
        self.serve_backlog = m.gauge(
            "advspec_serve_backlog_tokens",
            help="serve scheduler estimated token backlog",
        )
        self.serve_queue_wait = m.histogram(
            "advspec_serve_queue_wait_seconds",
            help="opponent-unit wait from admission to dispatch",
        )
        # Weight residency (engine/weightres.py): how many opponent
        # models are device-resident right now — the "one debate pool
        # per TPU" unit-economics gauge.
        self.weight_resident = m.gauge(
            "advspec_weight_resident_models",
            help="opponent models resident in device HBM",
        )
        # Cross-replica KV handoff (fleet/handoff.py): prefill-publish
        # through decode-adoption wall — the disaggregation tax a
        # handoff pays instead of a local re-prefill.
        self.handoff_latency = m.histogram(
            "advspec_kv_handoff_seconds",
            help="cross-replica KV handoff wall (prefill publish "
            "through decode adoption)",
        )
        self._sync: dict = {}
        self._fault: dict = {}
        self._breaker: dict = {}
        self._tier_hit: dict = {}
        self._swap: dict = {}
        self._cancel: dict = {}
        self._route: dict = {}
        self._replica_op: dict = {}
        self._fleet_scale: dict = {}
        self._serve_op: dict = {}
        self._serve_shed: dict = {}
        self._weight_swap: dict = {}
        self._handoff: dict = {}
        self._lock_hold: dict = {}
        self._lock_wait: dict = {}

    def sync(self, reason: str):
        c = self._sync.get(reason)
        if c is None:
            c = self._sync[reason] = self._m.counter(
                "advspec_host_syncs_total",
                help="sanctioned host syncs by reason",
                reason=reason,
            )
        return c

    def fault(self, seam: str, kind: str):
        c = self._fault.get((seam, kind))
        if c is None:
            c = self._fault[(seam, kind)] = self._m.counter(
                "advspec_faults_total",
                help="classified faults by seam and kind",
                seam=seam,
                kind=kind,
            )
        return c

    def breaker(self, to: str):
        c = self._breaker.get(to)
        if c is None:
            c = self._breaker[to] = self._m.counter(
                "advspec_breaker_transitions_total",
                help="circuit-breaker transitions by target state",
                to=to,
            )
        return c

    def tier_hit_ratio(self, tier: str):
        """Per-tier KV hit-ratio gauge (engine/kvtier.py lookups)."""
        g = self._tier_hit.get(tier)
        if g is None:
            g = self._tier_hit[tier] = self._m.gauge(
                "advspec_kv_tier_hit_ratio",
                help="tiered-KV lookup hit ratio by tier (this round)",
                tier=tier,
            )
        return g

    def cancel(self, reason: str):
        """Mid-decode cancellation counter by reason (early_converge
        from the debate layer's marker scanner; other consumers may
        name their own)."""
        c = self._cancel.get(reason)
        if c is None:
            c = self._cancel[reason] = self._m.counter(
                "advspec_cancelled_total",
                help="mid-decode request cancellations by reason",
                reason=reason,
            )
        return c

    def route(self, reason: str):
        """Fleet routing decisions by reason (affinity = the ring's
        primary choice; breaker_open/failover = a re-route hop)."""
        c = self._route.get(reason)
        if c is None:
            c = self._route[reason] = self._m.counter(
                "advspec_fleet_routes_total",
                help="fleet routing decisions by reason",
                reason=reason,
            )
        return c

    def replica_op(self, op: str):
        """Fleet replica lifecycle transitions by op (fleet/router.py
        state machine: spawn/ready/heartbeat_miss/retire/shutdown)."""
        c = self._replica_op.get(op)
        if c is None:
            c = self._replica_op[op] = self._m.counter(
                "advspec_fleet_replica_events_total",
                help="fleet replica lifecycle transitions by op",
                op=op,
            )
        return c

    def fleet_scale(self, direction: str, reason: str):
        """Autoscaler membership changes by direction and trigger
        (fleet/autoscale.py: out/backlog, out/brownout, in/idle,
        out/spawn_failed for an aborted scale-out…)."""
        c = self._fleet_scale.get((direction, reason))
        if c is None:
            c = self._fleet_scale[(direction, reason)] = self._m.counter(
                "advspec_fleet_scale_total",
                help="autoscaler membership changes by direction and "
                "trigger",
                direction=direction,
                reason=reason,
            )
        return c

    def serve_op(self, op: str):
        """Serve-daemon lifecycle transitions by op (serve/sched.py
        state machine: accepted/queued/running/finished/shed/preempted/
        drained plus brownout_enter/brownout_exit)."""
        c = self._serve_op.get(op)
        if c is None:
            c = self._serve_op[op] = self._m.counter(
                "advspec_serve_requests_total",
                help="serve-daemon request lifecycle transitions by op",
                op=op,
            )
        return c

    def serve_shed(self, reason: str):
        """Typed load-shed rejections by reason (serve/protocol.py
        SHED_REASONS) — the shed-not-collapse ledger the overload
        chaos drill audits."""
        c = self._serve_shed.get(reason)
        if c is None:
            c = self._serve_shed[reason] = self._m.counter(
                "advspec_serve_shed_total",
                help="serve-daemon typed load-shed rejections by reason",
                reason=reason,
            )
        return c

    def lock_hold(self, lock: str):
        """Per-lock hold-wall histogram (resilience/lockdep.py
        TrackedLock release path) — a critical section that grew past
        its budget shows up as a fat column here before it shows up as
        contention anywhere else."""
        h = self._lock_hold.get(lock)
        if h is None:
            h = self._lock_hold[lock] = self._m.histogram(
                "advspec_lock_hold_seconds",
                help="tracked-lock hold wall by lock (lockdep)",
                lock=lock,
            )
        return h

    def lock_wait(self, lock: str):
        """Per-lock acquisition-wait histogram (TrackedLock acquire
        path): the contention ledger — waits fatten here long before a
        stall is user-visible, and the deadlock-hammer drill pins the
        families exist."""
        h = self._lock_wait.get(lock)
        if h is None:
            h = self._lock_wait[lock] = self._m.histogram(
                "advspec_lock_wait_seconds",
                help="tracked-lock acquisition wait wall by lock (lockdep)",
                lock=lock,
            )
        return h

    def weight_swap_latency(self, direction: str):
        """Weight-residency swap wall histogram by direction (load:
        cold materialization; in: host→device promotion; out:
        device→host demotion) — residency thrash shows up here as a
        fat ``load`` column that should have been ``in``."""
        h = self._weight_swap.get(direction)
        if h is None:
            h = self._weight_swap[direction] = self._m.histogram(
                "advspec_weight_swap_seconds",
                help="weight residency swap wall by direction",
                direction=direction,
            )
        return h

    def handoff(self, outcome: str):
        """Cross-replica KV handoffs by terminal outcome
        (fleet/handoff.py state machine: adopted = the decode replica's
        first step started from a tier hit; degraded = the lost-race
        fallback re-prefilled locally; abandoned = the handoff died
        before publication)."""
        c = self._handoff.get(outcome)
        if c is None:
            c = self._handoff[outcome] = self._m.counter(
                "advspec_kv_handoff_total",
                help="cross-replica KV handoffs by outcome",
                outcome=outcome,
            )
        return c

    def swap_latency(self, direction: str):
        """KV swap wall histogram by direction (in: promote/rehydrate
        toward the device; out: demote/spill/store away from it)."""
        h = self._swap.get(direction)
        if h is None:
            h = self._swap[direction] = self._m.histogram(
                "advspec_kv_swap_seconds",
                help="KV tier swap wall by direction",
                direction=direction,
            )
        return h


hot = HotMetrics(metrics)


def config() -> ObsConfig:
    return _config


def configure(
    enabled: bool | None = None,
    recorder_size: int | None = None,
    events_out: str | None = None,
    dump_on_fault: bool | None = None,
    slo_ttft_ms: float | None = None,
    slo_round_s: float | None = None,
    arrivals: bool | None = None,
) -> ObsConfig:
    if enabled is not None:
        _config.enabled = bool(enabled)
        recorder.enabled = _config.enabled
    if recorder_size is not None:
        _config.recorder_size = max(1, int(recorder_size))
        recorder.resize(_config.recorder_size)
    if events_out is not None:
        _config.events_out = events_out or None
    if dump_on_fault is not None:
        _config.dump_on_fault = bool(dump_on_fault)
    if slo_ttft_ms is not None:
        _config.slo_ttft_ms = max(0.0, float(slo_ttft_ms))
    if slo_round_s is not None:
        _config.slo_round_s = max(0.0, float(slo_round_s))
    if arrivals is not None:
        _config.arrivals = bool(arrivals)
    return _config


def reset_stats() -> None:
    """Per-invocation reset (one CLI invocation = one round): metrics
    zero in place, the ring clears, the retrace watch starts fresh, and
    the trace-id counter + ambient context + fired-SLO set clear (trace
    state must never leak across CLI invocations). The arrival epoch
    re-bases so a replay run's ``arrival_s`` offsets start at ~0."""
    global _arrival_t0
    metrics.reset()
    recorder.clear()
    retrace.reset()
    trace.reset()
    _slo_fired.clear()
    _arrival_t0 = time.monotonic()


def arrival_now() -> float:
    """The monotonic arrival offset to stamp on an admission-edge event
    RIGHT NOW: seconds since the obs epoch (last reset_stats()), or 0.0
    when arrival capture is unarmed — the default, which keeps mock
    event dumps byte-deterministic. Emit sites call this once at
    admission and thread the value into the event they emit."""
    if _config.enabled and _config.arrivals:
        return time.monotonic() - _arrival_t0
    return 0.0


def emit(ev) -> None:
    """Append one event to the flight recorder (no-op when disabled).
    Events whose ``trace_id``/``span_id`` are empty are stamped from
    the ambient trace context (obs/trace.py): emit sites that know
    their request stamp explicitly; everything else (prefix-cache,
    tier, retrace emits) inherits the request being served."""
    if _config.enabled:
        amb = trace.ambient
        if not ev.trace_id:
            ev.trace_id = amb.trace
        if not ev.span_id:
            ev.span_id = amb.span
        recorder.append(ev)


trace_scope = trace.scope  # re-export: the emitters' stamping scope


def record_sync(reason: str) -> None:
    """Count one sanctioned host sync, labeled by WHY (the runtime
    mirror of GL-SYNC's static triage: every sync the linter sanctions
    shows up here by reason, so an operator sees which sanctioned point
    dominates)."""
    if _config.enabled:
        hot.sync(reason).inc()


def autodump_path(trigger: str) -> str | None:
    """Where an auto-dump for ``trigger`` lands: a sibling of the armed
    ``events_out`` (``ev.jsonl`` -> ``ev.fault.jsonl``). A distinct file
    so the end-of-round dump can never overwrite the fault-time ring
    snapshot — on a long round that survives an early fault, the fault
    events may have aged out of the ring by final dump."""
    base = _config.events_out
    if not base:
        return None
    root, ext = os.path.splitext(base)
    return f"{root}.{trigger}{ext or '.jsonl'}"


def autodump(trigger: str, trace_id: str | None = None) -> str | None:
    """Fault/timeout/SLO auto-dump: write the ring NOW (the drive loop
    may be about to unwind) to the trigger's sibling of ``events_out``.
    ``trace_id`` scopes the dump to one round's causal story (the SLO
    capture path). Returns the path written, or None when no
    destination is armed."""
    path = autodump_path(trigger)
    if not (_config.enabled and _config.dump_on_fault and path):
        return None
    metrics.counter(
        "advspec_flight_recorder_dumps_total",
        help="flight-recorder dumps by trigger",
        trigger=trigger,
    ).inc()
    recorder.dump_jsonl(path, trace_id=trace_id)
    return path


def slo_check(kind: str, span_id: str, wall_s: float) -> str | None:
    """Check one request's measured wall against its SLO budget and, on
    a breach, self-capture: count it and arm ONE flight-recorder dump
    scoped to the request's trace (sibling file ``<stem>.slo_<kind>``,
    the fault-dump discipline). ``kind`` is ``"ttft"`` (budget
    ``slo_ttft_ms``, milliseconds) or ``"round"`` (``slo_round_s``,
    seconds — the per-opponent service wall the source paper's
    convergence protocol makes the user-facing cost unit). Fires at
    most once per (kind, request) — the breach metric and the dump
    alike — so a persistent offender cannot flood the disk. Returns
    the dump path when a capture was written, else None."""
    if not _config.enabled or not span_id:
        return None
    budget = (
        _config.slo_ttft_ms / 1000.0
        if kind == "ttft"
        else _config.slo_round_s
    )
    if budget <= 0.0 or wall_s <= budget:
        return None
    key = (kind, span_id)
    if key in _slo_fired:
        return None
    _slo_fired.add(key)
    metrics.counter(
        "advspec_slo_breaches_total",
        help="per-request SLO budget breaches by kind",
        kind=kind,
    ).inc()
    return autodump(f"slo_{kind}", trace_id=trace.trace_of(span_id))


def slo_breaches() -> dict[str, int]:
    """Breach counts by kind this round (the ``perf.obs.slo`` view)."""
    out: dict[str, int] = {}
    for kind, _ in _slo_fired:
        out[kind] = out.get(kind, 0) + 1
    return dict(sorted(out.items()))


def dump_events(path: str) -> int:
    """On-demand dump (--events-out at end of round). Atomic tmp+rename
    like every obs file write — a tailing reader never sees half a
    dump."""
    return recorder.dump_jsonl(path)


def write_metrics(path: str) -> None:
    """Write the Prometheus text exposition (--metrics-out) atomically
    (tmp+rename, DiskStore's discipline): a scraper hitting the file
    mid-round must read the previous complete exposition, never a torn
    one."""
    atomic_write_text(path, metrics.render_prometheus())


def snapshot() -> dict:
    """The ``perf.obs`` payload: recorder occupancy, event mix, sync
    reasons, and the retrace watch's compile report."""
    syncs = {}
    for key, value in metrics.snapshot().items():
        if key.startswith("advspec_host_syncs_total{"):
            reason = key.split('reason="', 1)[1].rstrip('"}')
            syncs[reason] = value
    return {
        "enabled": _config.enabled,
        "recorder": {
            "size": _config.recorder_size,
            "recorded": recorder.seq,
            "buffered": len(recorder),
            "dropped": recorder.dropped,
        },
        "events_by_type": recorder.counts_by_type(),
        "host_syncs": syncs,
        "retrace": retrace.snapshot(),
        "slo": {
            "ttft_ms": _config.slo_ttft_ms,
            "round_s": _config.slo_round_s,
            "breaches": slo_breaches(),
        },
    }
