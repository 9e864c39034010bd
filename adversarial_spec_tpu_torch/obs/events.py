"""Flight recorder: a bounded ring buffer of typed structured events.

The PyTorch port's copy of ``adversarial_spec_tpu/obs/events.py``.

When a round misbehaves (a fault eviction, a pipeline stall, an
unexpected retrace) the metrics registry says THAT something happened;
the flight recorder says WHAT the batcher was doing step by step.
Design constraints, in order:

- **Cheap when idle.** ``append`` stores a dataclass in a
  ``deque(maxlen=N)`` — no formatting, no I/O. Formatting happens only
  at dump time. Since the serve daemon made multi-threaded emitters
  real (thread-per-debate round drivers emitting SpanEvents
  concurrently), ``append`` takes one uncontended lock so ``seq`` and
  ``dropped`` stay exact; the obs-overhead bench budget absorbs it
  (BENCH_obs.json sat at 0.57% of a 3% budget before the lock).
- **Bounded.** The ring holds the LAST ``size`` events; older ones are
  dropped and counted (``dropped``), never grown over.
- **Deterministic.** Events carry a monotonic ``seq`` and NO wall-clock
  timestamps; float fields hold either synthetic deterministic seconds
  (mock engine) or real walls (TPU scheduler), rounded at dump time. A
  mock round's JSONL is byte-identical across runs.

Event vocabulary (the schema ``tools/obs_dump.py`` validates):

- ``StepEvent`` — one drive-loop dispatch: slot occupancy, the riding
  admission, prefill/decode token counts, pipeline depth, sync reason.
- ``RequestEvent`` — lifecycle transitions
  queued → admitted → prefill → decode → finished / evicted / timeout.
- ``FaultEvent`` — a classified fault with eviction context (slot id,
  pages freed, whether the request was requeued).
- ``BreakerEvent`` — a circuit-breaker state transition.
- ``CacheEvent`` — prefix-cache lookup / insert / evict.
- ``CompileEvent`` — the retrace watch saw a jit compile.
- ``SpecEvent`` — one row's speculative draft/verify outcome.
- ``SwapEvent`` — one KV-tier transition (demote/promote/rehydrate/
  spill/store/free/quarantine) with post-op per-tier residency.
- ``CancelEvent`` — one streaming early-convergence cancellation
  (tokens emitted before the cancel, budget tokens saved).
- ``SpanEvent`` — a causal-trace stage boundary (begin/end, or
  ``cancelled`` closing a request envelope mid-decode) with the
  stage's measured wall on the end record.
- ``JournalEvent`` — one durable round-journal append (record type,
  fsync wall) or journal-serve decision (debate/journal.py).
- ``RecoveryEvent`` — one journal replay at round start: how many
  opponents were served from durable records vs re-issued.
- ``ReplicaEvent`` — one fleet-replica lifecycle transition
  (spawn/ready/heartbeat_miss/retire/shutdown) with the post-op alive
  count (fleet/router.py).
- ``RouteEvent`` — one fleet routing decision: which replica a request
  landed on, the affinity key it hashed, and the failover hop count
  (0 = the ring's primary choice).
- ``WeightEvent`` — one weight-residency transition
  (engine/weightres.py): a model loaded cold, demoted to the host
  tier, promoted back, freed, or a promotion aborted by a fault —
  with the post-op resident/host model counts so residency thrash is
  visible in the timeline, not inferred from round latency.
- ``ServeEvent`` — one serve-daemon lifecycle/pressure transition
  (adversarial_spec_tpu/serve): a debate accepted/shed at admission, an
  opponent unit queued/running/finished/preempted/drained, a brownout
  entry/exit — with the tenant, tier, and post-op backlog so the
  timeline shows WHO was being served and WHO was shed when pressure
  hit.
- ``ScaleEvent`` — one autoscaler membership transition
  (fleet/autoscale.py): a replica provisioned/warming/serving/
  draining/retired, or a spawn that exhausted its retries — with the
  desired and alive counts and the backlog that drove the decision,
  so the timeline shows capacity FOLLOWING pressure, not just
  pressure building.

Causal tracing (obs/trace.py): EVERY event additionally carries
``trace_id`` (the debate round that caused it) and ``span_id`` (the
opponent request), stamped explicitly where the emitter knows its
request and from the ambient trace context otherwise (``obs.emit``
fills empty fields). Both default to "" so events emitted outside any
round (tests, tools) stay valid.
"""

from __future__ import annotations

import dataclasses
import json
import threading
from collections import deque
from dataclasses import dataclass, field


@dataclass(slots=True)
class StepEvent:
    TYPE = "step"
    kind: str = "decode"  # fused | decode | prefill | spec | fused_spec
    n_live: int = 0  # resident rows decoding this step
    admission_slot: int = -1  # slot of the riding admission (-1: none)
    prefill_tokens: int = 0  # prompt tokens advanced this step
    decode_chunk: int = 0  # decode-chunk budget per live row
    pipeline_depth: int = 0  # steps in flight after this dispatch
    sync_reason: str = ""  # why the host synced this step ("" = no sync)
    trace_id: str = ""  # round the step served (ambient)
    span_id: str = ""  # riding admission's request ("" = batch-level)


@dataclass(slots=True)
class RequestEvent:
    TYPE = "request"
    req_id: int = -1
    state: str = "queued"  # queued|admitted|prefill|decode|finished|evicted|timeout
    slot: int = -1
    tokens: int = 0  # tokens relevant to this transition
    cached_tokens: int = 0
    # Monotonic arrival offset (seconds since obs reset) recorded at
    # admission when ADVSPEC_OBS_ARRIVALS is armed (obs.arrival_now());
    # 0.0 otherwise — the default keeps mock dumps byte-deterministic,
    # armed dumps feed tools/load_replay.py's trace reconstruction.
    arrival_s: float = 0.0
    trace_id: str = ""
    span_id: str = ""


@dataclass(slots=True)
class FaultEvent:
    TYPE = "fault"
    seam: str = ""
    kind: str = ""
    slot: int = -1
    req_id: int = -1
    pages_freed: int = 0
    requeued: bool = False
    error: str = ""
    trace_id: str = ""  # the injured request's round
    span_id: str = ""  # the injured request itself


@dataclass(slots=True)
class BreakerEvent:
    TYPE = "breaker"
    model: str = ""
    frm: str = ""
    to: str = ""
    trace_id: str = ""
    span_id: str = ""


@dataclass(slots=True)
class CacheEvent:
    TYPE = "cache"
    op: str = "lookup"  # lookup | insert | evict
    matched_tokens: int = 0
    blocks: int = 0
    pages: int = 0
    hit: bool = False
    trace_id: str = ""  # admission that drove the op (ambient)
    span_id: str = ""


@dataclass(slots=True)
class CompileEvent:
    TYPE = "compile"
    program: str = ""
    key: str = ""
    n_compiles: int = 0
    unexpected: bool = False
    trace_id: str = ""  # request whose dispatch compiled (ambient)
    span_id: str = ""


@dataclass(slots=True)
class SpecEvent:
    """One row's speculative draft/verify outcome (CacheEvent-style:
    per-observation, the recorder's bounded ring keeps the recent ones).
    ``drafted`` counts positions ELIGIBLE to commit (the budget/page
    clamped draft width), so accepted/drafted is a true acceptance rate;
    ``emitted`` includes the bonus/rejection token; ``rolled_back_pages``
    is the draft tail the host released after the accept fetch."""

    TYPE = "spec"
    slot: int = -1
    req_id: int = -1
    drafted: int = 0
    accepted: int = 0
    emitted: int = 0
    rolled_back_pages: int = 0
    trace_id: str = ""
    span_id: str = ""


@dataclass(slots=True)
class SwapEvent:
    """One KV-tier state transition (engine/kvtier.py). ``op`` names
    the edge of the tier state machine (demote: device→host; promote:
    host→device; rehydrate: disk→device; spill: host LRU→disk; store:
    insert write-through→disk; free: host LRU drop; quarantine: corrupt
    disk entry moved aside; ship: prefill-side handoff publication to
    the shared store; prefetch: decode-side hint probe ahead of
    adoption). ``host_resident``/``disk_resident`` are the per-tier
    block counts AFTER the op — tools/obs_dump.py's occupancy timeline
    reads tier residency off these."""

    TYPE = "swap"
    op: str = "demote"
    tier: str = "host"  # tier the op targets
    blocks: int = 0
    tokens: int = 0
    slot: int = -1  # admission slot driving the swap (-1: none)
    host_resident: int = 0
    disk_resident: int = 0
    trace_id: str = ""  # admission that drove the swap (ambient)
    span_id: str = ""


@dataclass(slots=True)
class CancelEvent:
    """One streaming early-convergence cancellation
    (engine/streaming.py): the request's consumer saw everything it
    needed (its verdict marker arrived) and the batcher stopped
    decoding it — a HAPPY-path event, not a fault. ``tokens_emitted``
    is the partial transcript's length at the cancel point;
    ``tokens_saved`` the budget remainder that was never decoded (the
    capacity the freed slot immediately re-admits queued work into)."""

    TYPE = "cancel"
    req_id: int = -1
    slot: int = -1
    reason: str = "early_converge"
    tokens_emitted: int = 0
    tokens_saved: int = 0
    trace_id: str = ""
    span_id: str = ""


@dataclass(slots=True)
class SpanEvent:
    """A causal-trace stage boundary (obs/trace.py id model). ``begin``
    marks entry into a stage (``wall_s`` 0), ``end`` carries the
    stage's measured wall — synthetic deterministic seconds from the
    mock engine, real walls from the scheduler, exactly the float
    convention every other event follows. The per-request stage
    vocabulary the scheduler and mock both emit (``queued`` →
    ``prefill`` → ``decode`` under a ``request`` envelope whose end
    wall is the request's SERVICE time, prefill + decode — the
    decomposition ``tools/trace_view.py`` CHECKS, not just renders)
    plus the debate layer's ``round``/``opponent`` spans."""

    TYPE = "span"
    name: str = ""  # request|queued|prefill|decode|round|opponent|...
    phase: str = "begin"  # begin | end | cancelled (request envelopes)
    req_id: int = -1
    slot: int = -1
    wall_s: float = 0.0  # stage duration, set on the end record
    trace_id: str = ""
    span_id: str = ""


@dataclass(slots=True)
class JournalEvent:
    """One crash-safe round-journal operation (debate/journal.py).
    ``append`` is a durable fsync'd record append (``fsync_s`` holds
    the write+fsync wall — the durability tax the journal-fsync
    histogram aggregates); ``serve`` marks one opponent resolved from
    a replayed record with zero engine work."""

    TYPE = "journal"
    op: str = "append"  # append | serve
    rtype: str = ""  # record type (round_start|completion|partial|round_commit)
    round_num: int = 0
    index: int = -1  # opponent index within the round (-1: round-level)
    fsync_s: float = 0.0
    trace_id: str = ""
    span_id: str = ""


@dataclass(slots=True)
class RecoveryEvent:
    """One journal replay at round start (``--resume`` after a crash):
    ``served`` opponents resolved from durable completion records,
    ``reissued`` re-enter the engine, ``records`` journal records were
    readable and ``skipped`` were torn/foreign-version and ignored."""

    TYPE = "recovery"
    round_num: int = 0
    served: int = 0
    reissued: int = 0
    records: int = 0
    skipped: int = 0
    trace_id: str = ""
    span_id: str = ""


@dataclass(slots=True)
class ReplicaEvent:
    """One fleet-replica lifecycle transition (fleet/router.py state
    machine). ``op`` names the edge: spawn (handle created), ready
    (transport answered its first ping), heartbeat_miss (a health
    probe failed), retire (the shared retirement surgery ran — the
    replica left the ring and its in-flight work was re-routed),
    shutdown (orderly fleet teardown). ``alive`` is the routable
    replica count AFTER the op, so the timeline shows capacity
    draining the moment it happens."""

    TYPE = "replica"
    replica: str = ""
    op: str = "spawn"
    reason: str = ""  # retire cause: dead | heartbeat | fault | shutdown
    alive: int = 0  # routable replicas after this op
    trace_id: str = ""
    span_id: str = ""


@dataclass(slots=True)
class RouteEvent:
    """One fleet routing decision (fleet/router.py). ``hop`` counts
    failover re-routes for the request (0 = the consistent-hash ring's
    primary choice for its affinity key); ``reason`` says why THIS
    replica: affinity (primary), breaker_open (primary's per-
    (replica, model) circuit was open), failover (an earlier hop's
    replica died mid-request), random (affinity routing disabled —
    the bench's control arm)."""

    TYPE = "route"
    replica: str = ""
    req_id: int = -1
    key: str = ""  # affinity key the ring hashed
    model: str = ""
    hop: int = 0
    reason: str = "affinity"
    trace_id: str = ""
    span_id: str = ""


@dataclass(slots=True)
class WeightEvent:
    """One weight-residency state transition (engine/weightres.py).
    ``op`` names the edge of the residency state machine (load: cold
    materialization; demote: device→host shard paging; promote:
    host→device re-activation; free: eviction without paging / host
    LRU overflow; swap_fault: a promotion aborted mid-swap — the host
    entry survives untouched). ``resident``/``host`` are the per-tier
    model counts AFTER the op; ``wall_s`` the swap's measured wall
    (synthetic deterministic seconds from the mock engine)."""

    TYPE = "weight"
    op: str = "load"
    alias: str = ""
    nbytes: int = 0
    wall_s: float = 0.0
    resident: int = 0
    host: int = 0
    trace_id: str = ""  # round whose group drove the swap (ambient)
    span_id: str = ""


@dataclass(slots=True)
class ServeEvent:
    """One serve-daemon transition (adversarial_spec_tpu/serve). ``op``
    names the edge of the request lifecycle state machine (accepted →
    queued → running → finished | shed | preempted | drained) or a
    pressure transition (brownout_enter / brownout_exit). ``debate`` is
    the daemon-assigned request id; ``index`` the opponent unit within
    it (-1 = debate-level). ``reason`` carries the typed shed/preempt/
    drain cause (serve/protocol.py SHED_REASONS and ``tier_pressure``
    for policy preemptions); ``backlog_tokens`` is the scheduler's
    estimated token backlog AFTER the op, so the timeline shows
    pressure building and draining."""

    TYPE = "serve"
    op: str = "accepted"
    tenant: str = ""
    tier: str = "interactive"
    debate: str = ""
    index: int = -1
    reason: str = ""
    tokens: int = 0
    backlog_tokens: int = 0
    # Monotonic arrival offset (seconds since obs reset) stamped on the
    # admission-edge ops (accepted/shed) when ADVSPEC_OBS_ARRIVALS is
    # armed; 0.0 otherwise (the byte-determinism default). The replay
    # harness (tools/load_replay.py) reconstructs per-tenant arrival
    # processes from these offsets.
    arrival_s: float = 0.0
    trace_id: str = ""
    span_id: str = ""


@dataclass(slots=True)
class ScaleEvent:
    """One elastic-fleet membership transition (fleet/autoscale.py
    lifecycle machine). ``op`` names the edge the replica crossed
    (provision → warming → serving on scale-out; draining → retired on
    scale-in; spawn_failed when the bounded spawn retry gave up).
    ``direction`` is the scaling decision that caused it ("out"/"in",
    "" for shutdown teardown); ``reason`` the trigger (backlog,
    brownout, idle, spawn_failed, shutdown…). ``desired``/``alive``
    are the autoscaler's target and the routable ring population AFTER
    the op, and ``backlog_tokens`` the scheduler backlog that drove
    the decision — the timeline shows capacity following pressure."""

    TYPE = "scale"
    replica: str = ""
    op: str = "provision"
    direction: str = ""  # out | in | "" (teardown / informational)
    reason: str = ""
    desired: int = 0
    alive: int = 0
    backlog_tokens: int = 0
    trace_id: str = ""
    span_id: str = ""


@dataclass(slots=True)
class LockEvent:
    """One lockdep sanitizer detection (resilience/lockdep.py). ``op``
    is the violation kind; ``lock`` the lock whose acquisition closed
    the cycle, ``held`` the lock held at that moment, and ``edge`` the
    offending acquisition-order edge (``"held->lock"``). The full
    stacks live in the LockOrderViolation the sanitizer records (and
    in the auto-dumped ring's surrounding events) — an event field is
    not the place for a multi-KB traceback."""

    TYPE = "lock"
    op: str = "violation"
    lock: str = ""
    held: str = ""
    edge: str = ""
    trace_id: str = ""
    span_id: str = ""


EVENT_TYPES = (
    StepEvent,
    RequestEvent,
    FaultEvent,
    BreakerEvent,
    CacheEvent,
    CompileEvent,
    SpecEvent,
    SwapEvent,
    CancelEvent,
    SpanEvent,
    JournalEvent,
    RecoveryEvent,
    ReplicaEvent,
    RouteEvent,
    WeightEvent,
    ServeEvent,
    ScaleEvent,
    LockEvent,
)

# ``cancelled`` closes a request envelope mid-decode (streaming early
# convergence): it carries the service wall exactly like ``end``, so
# trace_view's decomposition check covers cancelled requests too.
SPAN_PHASES = ("begin", "end", "cancelled")

SWAP_OPS = (
    "demote",
    "promote",
    "rehydrate",
    "spill",
    "store",
    "free",
    "quarantine",
    "ship",
    "prefetch",
)

# The weight-residency state machine's edges (engine/weightres.py) —
# graftlint's fourth GL-LIFECYCLE machine enforces the code side of
# the same contract (every transition through one ledger surgery).
WEIGHT_OPS = (
    "load",
    "demote",
    "promote",
    "free",
    "swap_fault",
)

REPLICA_OPS = (
    "spawn",
    "ready",
    "heartbeat_miss",
    "retire",
    "shutdown",
)

ROUTE_REASONS = (
    "affinity",
    "breaker_open",
    "failover",
    "random",
    # Disaggregated fleet (fleet/handoff.py): the prefill-role hop of
    # a cross-replica KV handoff — the decode hop that follows it
    # routes with its own reason (affinity within the decode pool).
    "prefill",
)

# The serve-daemon request lifecycle (docs/serving.md state machine)
# plus the brownout pressure transitions. graftlint's third
# GL-LIFECYCLE machine enforces the code side of the same contract:
# every exit op below maps to a path through the scheduler's one
# release surgery.
SERVE_OPS = (
    "accepted",
    "queued",
    "running",
    "finished",
    "shed",
    "preempted",
    "drained",
    "brownout_enter",
    "brownout_exit",
)

SERVE_TIERS = ("interactive", "batch")

# The autoscaler's replica lifecycle (fleet/autoscale.py state
# machine) — graftlint's fifth GL-LIFECYCLE machine enforces the code
# side of the same contract (every exit through one ``_decommission``
# surgery). ``spawn_failed`` is the one non-state edge: a scale-out
# whose bounded spawn retry exhausted before the replica ever existed.
SCALE_OPS = (
    "provision",
    "warming",
    "serving",
    "draining",
    "retired",
    "spawn_failed",
)

SCALE_DIRECTIONS = ("out", "in", "")

# The lockdep sanitizer's detections (resilience/lockdep.py): today
# only order inversions — the op whitelist exists so a future
# hold-too-long / wait-too-long detector extends the vocabulary here
# instead of minting untyped strings.
LOCK_OPS = ("violation",)

REQUEST_STATES = (
    "queued",
    "admitted",
    "prefill",
    "decode",
    "finished",
    "evicted",
    "timeout",
    "cancelled",
)

# type name -> {field name: python type} — the schema contract
# tools/obs_dump.py validates every JSONL line against. Derived from
# the dataclasses so it can never drift from the emitters.
EVENT_FIELDS: dict[str, dict[str, type]] = {
    cls.TYPE: {f.name: f.type for f in dataclasses.fields(cls)}
    for cls in EVENT_TYPES
}
_PY_TYPES = {"int": int, "str": str, "bool": bool, "float": float}


def event_to_dict(seq: int, ev) -> dict:
    """Stable field order: seq, type, then dataclass declaration order."""
    out: dict = {"seq": seq, "type": ev.TYPE}
    for f in dataclasses.fields(ev):
        v = getattr(ev, f.name)
        if isinstance(v, float):
            v = round(v, 6)
        out[f.name] = v
    return out


def validate_event(obj) -> list[str]:
    """Schema-check one decoded JSONL line; returns human-readable
    problems (empty = valid). Shared by the recorder's own tests and
    tools/obs_dump.py."""
    errors: list[str] = []
    if not isinstance(obj, dict):
        return [f"not an object: {obj!r}"]
    etype = obj.get("type")
    if etype not in EVENT_FIELDS:
        return [f"unknown event type {etype!r}"]
    if not isinstance(obj.get("seq"), int):
        errors.append("missing/non-int 'seq'")
    fields = EVENT_FIELDS[etype]
    for name, anno in fields.items():
        if name not in obj:
            errors.append(f"{etype}: missing field {name!r}")
            continue
        py = _PY_TYPES.get(anno if isinstance(anno, str) else anno.__name__)
        v = obj[name]
        if py is bool:
            ok = isinstance(v, bool)
        elif py is int:
            ok = isinstance(v, int) and not isinstance(v, bool)
        elif py is float:
            ok = isinstance(v, (int, float)) and not isinstance(v, bool)
        elif py is str:
            ok = isinstance(v, str)
        else:  # pragma: no cover - schema only uses the four above
            ok = True
        if not ok:
            errors.append(
                f"{etype}: field {name!r} expected {anno}, got {type(v).__name__}"
            )
    for name in obj:
        if name not in fields and name not in ("seq", "type"):
            errors.append(f"{etype}: unknown field {name!r}")
    if etype == "request" and obj.get("state") not in REQUEST_STATES:
        errors.append(f"request: unknown state {obj.get('state')!r}")
    if etype == "swap" and obj.get("op") not in SWAP_OPS:
        errors.append(f"swap: unknown op {obj.get('op')!r}")
    if etype == "span" and obj.get("phase") not in SPAN_PHASES:
        errors.append(f"span: unknown phase {obj.get('phase')!r}")
    if etype == "weight" and obj.get("op") not in WEIGHT_OPS:
        errors.append(f"weight: unknown op {obj.get('op')!r}")
    if etype == "replica" and obj.get("op") not in REPLICA_OPS:
        errors.append(f"replica: unknown op {obj.get('op')!r}")
    if etype == "route" and obj.get("reason") not in ROUTE_REASONS:
        errors.append(f"route: unknown reason {obj.get('reason')!r}")
    if etype == "serve":
        if obj.get("op") not in SERVE_OPS:
            errors.append(f"serve: unknown op {obj.get('op')!r}")
        if obj.get("tier") not in SERVE_TIERS:
            errors.append(f"serve: unknown tier {obj.get('tier')!r}")
    if etype == "scale":
        if obj.get("op") not in SCALE_OPS:
            errors.append(f"scale: unknown op {obj.get('op')!r}")
        if obj.get("direction") not in SCALE_DIRECTIONS:
            errors.append(
                f"scale: unknown direction {obj.get('direction')!r}"
            )
    if etype == "lock" and obj.get("op") not in LOCK_OPS:
        errors.append(f"lock: unknown op {obj.get('op')!r}")
    return errors


def _recorder_lock():
    """The recorder's mutation lock through the lockdep seam
    (resilience/lockdep.py), ``metrics=False``: a histogram observe
    takes the metrics-registry lock, so obs-internal locks must never
    observe themselves. Lazy import — obs loads before resilience in
    some import orders, and the recorder must construct either way."""
    try:
        from adversarial_spec_tpu_torch.resilience import lockdep
    except ImportError:  # pragma: no cover - partial-init fallback
        return threading.Lock()
    return lockdep.make_lock("FlightRecorder._lock", metrics=False)


@dataclass
class FlightRecorder:
    """Bounded ring of (seq, event); the last ``size`` events survive."""

    size: int = 512
    enabled: bool = True
    seq: int = 0  # total events ever appended (monotonic)
    dropped: int = 0  # events pushed out of the ring
    _buf: deque = field(default_factory=deque)
    # Serializes seq/dropped/_buf mutation: the serve daemon's debate
    # threads emit concurrently (buffered + dropped == seq must hold
    # exactly — the chaos fuzz pins it).
    _lock: object = field(default_factory=_recorder_lock)

    def __post_init__(self) -> None:
        self._buf = deque(self._buf, maxlen=self.size)

    def append(self, ev) -> None:
        if not self.enabled:
            return
        with self._lock:
            self.seq += 1
            if len(self._buf) == self._buf.maxlen:
                self.dropped += 1
            self._buf.append((self.seq, ev))

    def __len__(self) -> int:
        return len(self._buf)

    def resize(self, size: int) -> None:
        size = max(1, int(size))
        if size != self.size:
            with self._lock:
                self.size = size
                # Shrinking ages out the oldest events — they are drops
                # like any other (buffered + dropped == seq must hold).
                self.dropped += max(0, len(self._buf) - size)
                self._buf = deque(self._buf, maxlen=size)

    def clear(self) -> None:
        with self._lock:
            self._buf.clear()
            self.seq = 0
            self.dropped = 0

    def events(self, trace_id: str | None = None) -> list[dict]:
        """Buffered events as dicts; ``trace_id`` scopes to one round's
        causal story (the SLO auto-dump's view). Snapshots the ring
        under the lock first — a daemon auto-dump must not race a
        concurrent debate thread's append mid-iteration."""
        with self._lock:
            items = list(self._buf)
        return [
            event_to_dict(seq, ev)
            for seq, ev in items
            if trace_id is None or ev.trace_id == trace_id
        ]

    def counts_by_type(self) -> dict[str, int]:
        with self._lock:
            items = list(self._buf)
        out: dict[str, int] = {}
        for _, ev in items:
            out[ev.TYPE] = out.get(ev.TYPE, 0) + 1
        return dict(sorted(out.items()))

    def to_jsonl(self, trace_id: str | None = None) -> str:
        lines = [
            json.dumps(e, separators=(",", ":"))
            for e in self.events(trace_id)
        ]
        return "\n".join(lines) + ("\n" if lines else "")

    def dump_jsonl(self, path: str, trace_id: str | None = None) -> int:
        """Write the buffered events as JSONL; returns the line count
        written. ``trace_id`` scopes the dump to one round's events
        (SLO-triggered captures). Atomic via the shared tmp+rename
        discipline (DiskStore's): the auto-dump fires mid-fault,
        possibly mid-crash, and a reader must never see a torn file."""
        data = self.to_jsonl(trace_id)
        atomic_write_text(path, data)
        return data.count("\n")


def atomic_write_text(path: str, data: str) -> None:
    """Write ``data`` to ``path`` atomically: a pid-suffixed temp file
    in the same directory, then ``os.replace`` (atomic on POSIX) —
    DiskStore's discipline (engine/kvtier.py). A reader polling the
    path (a Prometheus scraper on --metrics-out, a tail on the events
    JSONL) sees either the old complete file or the new complete file,
    never a torn one; a crashed writer leaves only a ``.tmp`` orphan."""
    import os

    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        with open(tmp, "w", encoding="utf-8") as f:
            f.write(data)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
