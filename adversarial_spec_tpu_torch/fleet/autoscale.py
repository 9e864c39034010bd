"""Elastic fleet: backlog-driven autoscaling with graceful membership
change and lose-nothing scale-in.

The PyTorch port's copy of ``adversarial_spec_tpu/fleet/autoscale.py``.

The :class:`Autoscaler` is a control loop between the serve
scheduler's token-backlog ledger (``ServeScheduler.pressure_snapshot``)
and the fleet router's membership hooks. It owns one lifecycle per
replica it manages::

    provisioning -> warming -> serving -> draining -> retired

with every terminal transition funnelled through ONE surgery,
:meth:`Autoscaler._decommission` (the fifth GL-LIFECYCLE machine —
``tools/graftlint`` enforces that every exit reaches it).

Scale-OUT — warm-before-ring. A new replica is spawned through the
bounded-retry hardening (:func:`fleet.replica.spawn_replica`; a typed
``SpawnFailed`` after the retries exhaust, counted, never a hot loop),
then WARMED — ping, shared-KV-store re-attach (engine construction
re-opens the fleet's DiskStore), and a weight-residency preload of the
hottest models in the scheduler's current mix — and only then admitted
to the hash ring via ``router.admit_replica``. Between spawn and
admission the replica is invisible to every routing path, so no
request ever routes to a cold replica. A replica that dies while
warming is decommissioned WITHOUT ever entering the ring
(:meth:`_abort_warm` closes its transport directly).

Scale-IN — lose-nothing handoff, the reverse order. The victim (the
LEAST-AFFINE routable replica: the one primarily owning the fewest
active debate keys, so the least warm prefix KV leaves with it) is
removed from the ring FIRST (``router.drain_replica`` — transport
stays open), in-flight units drain on it while new work routes to
survivors, then :meth:`_finish_scale_in` retires it through the
router's ``_retire_replica``. A victim that stalls past the drain
deadline is retired mid-batch: the transport close surfaces as
``ReplicaDead`` and the router's partial-merge + remainder re-route
machinery turns the retirement into a PLANNED handoff — exactly-once
``_resolve`` guarantees zero duplicated completions, and partial KV
survives via the shared DiskStore.

Flap control: a scale decision needs ``scale_out_ticks`` /
``scale_in_ticks`` CONSECUTIVE pressure readings (hysteresis) and is
suppressed inside ``scale_cooldown_s`` of the previous membership
change (counted in ``stats.flaps_suppressed``). Membership is clamped
to ``[min_replicas, max_replicas]`` — the floor and ceiling are hard.

Role-aware elasticity (disaggregated fleets): when the managed engine
is role-split (``prefill_replicas > 0``), the tick reads the
scheduler's per-role backlog split instead — prefill-token backlog
sizes the PREFILL pool, the decode remainder sizes the DECODE pool —
each under its own min/max (``min/max_prefill_replicas`` vs the
symmetric ``min/max_replicas``) and its own hysteresis streak. The
decisions run through the same spawn/warm/ring and drain/retire paths;
the per-replica lifecycle machine is reused unchanged.

The loop thread calls exactly :meth:`tick`; the deterministic drills
(``tests/test_torch_autoscale.py``) inject ``clock``/``sleep``/``rng`` and call ``tick()`` directly.
"""

from __future__ import annotations

import threading
import time

from adversarial_spec_tpu_torch import fleet as fleet_mod
from adversarial_spec_tpu_torch import obs as obs_mod
from adversarial_spec_tpu_torch import serve as serve_mod
from adversarial_spec_tpu_torch.fleet.replica import SpawnFailed
from adversarial_spec_tpu_torch.resilience import lockdep as lockdep_mod

# Lifecycle states (one machine per managed replica).
PROVISIONING = "provisioning"
WARMING = "warming"
SERVING = "serving"
DRAINING = "draining"
RETIRED = "retired"

# How many of the hottest models from the scheduler's mix a fresh
# replica preloads before ring admission.
WARM_TOP_K = 4

# Poll cadence while waiting for a drain victim's in-flight count to
# reach zero (the injected ``sleep`` makes this deterministic in tests).
_DRAIN_POLL_S = 0.01


class Autoscaler:
    """Backlog-driven membership controller for one ``FleetEngine``.

    ``pressure`` is any zero-arg callable returning a
    ``pressure_snapshot``-shaped dict; it defaults to the given
    scheduler's. ``clock``/``sleep``/``rng`` are injectable for the
    mock-clock drills.
    """

    def __init__(
        self,
        engine,
        sched=None,
        *,
        pressure=None,
        clock=time.monotonic,
        sleep=time.sleep,
        rng=None,
        stats=None,
    ):
        self._engine = engine
        self._router = engine.router
        self._sched = sched
        if pressure is not None:
            self._pressure = pressure
        elif sched is not None:
            self._pressure = sched.pressure_snapshot
        else:
            self._pressure = None
        self._clock = clock
        self._sleep = sleep
        self._rng = rng
        self.stats = stats if stats is not None else fleet_mod.stats
        # Lifecycle-owned: replica id -> state. Founders enter at
        # SERVING — they were warm before this controller existed.
        self._members: dict[str, str] = {
            rid: SERVING for rid in self._router.alive_ids()
        }
        # Spawned-but-never-ringed handles; _decommission closes these
        # directly (the router never knew them).
        self._pending: dict[str, object] = {}
        self._out_streak = 0
        self._in_streak = 0
        # Per-role streaks (disaggregated fleets): each pool carries
        # its own hysteresis so prefill pressure cannot spend decode's
        # streak or vice versa. The shared cooldown still serializes
        # membership changes across pools.
        self._out_streaks: dict[str, int] = {}
        self._in_streaks: dict[str, int] = {}
        self._last_change_t: float | None = None
        self._last_backlog = 0
        self._desired = max(1, len(self._members))
        self._lock = lockdep_mod.make_rlock("Autoscaler._lock")
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    # -- observers ---------------------------------------------------------

    def capacity_factor(self) -> int:
        """Routable replica count — wired into
        ``ServeScheduler.set_capacity_provider`` so the admission
        ceiling and brownout thresholds stretch with the fleet."""
        return max(1, len(self._router.alive_ids()))

    def member_state(self, rid: str) -> str | None:
        with self._lock:
            return self._members.get(rid)

    def members_snapshot(self) -> dict[str, str]:
        with self._lock:
            return dict(self._members)

    @property
    def desired(self) -> int:
        return self._desired

    # -- lifecycle mutators (GL-LIFECYCLE-sanctioned) ----------------------

    def _begin_provision(self, rid: str) -> None:
        self._members[rid] = PROVISIONING

    def _advance(self, rid: str, state: str) -> None:
        self._members[rid] = state

    # -- THE lifecycle surgery ---------------------------------------------

    def _decommission(self, rid: str, reason: str, direction: str = "") -> None:
        """Every terminal transition funnels here: mark the member
        RETIRED, then either close a never-ringed transport directly
        (aborted warm-up — the router never knew this replica) or
        retire a known replica through the router's own surgery
        (``_retire_replica``: dead-ledger, ring removal, transport
        close, telemetry — one place for both machines)."""
        state = self._members.get(rid)
        if state is None or state == RETIRED:
            return
        self._members[rid] = RETIRED
        pending = self._pending.pop(rid, None)
        if pending is not None:
            try:
                pending.close()
            except Exception:
                pass  # a dead transport may fail its own close
        else:
            self._router._retire_replica(rid, reason)
        self._emit(
            "retired", replica=rid, direction=direction, reason=reason
        )

    # -- lifecycle exits ---------------------------------------------------

    def _abort_warm(self, rid: str, reason: str) -> None:
        """Exit: the scale-out aborted BEFORE ring admission (spawn
        retries exhausted, or the replica died while warming). The
        replica was never routable, so nothing needs re-routing —
        decommission closes whatever transport exists."""
        self._emit(
            "spawn_failed", replica=rid, direction="out", reason=reason
        )
        if obs_mod.config().enabled:
            obs_mod.hot.fleet_scale("out", reason).inc()
        self._decommission(rid, reason, direction="out")

    def _finish_scale_in(self, rid: str) -> None:
        """Exit: the planned scale-in completes. The victim left the
        ring when draining began; if units are still in flight the
        transport close below surfaces as ``ReplicaDead`` and the
        router's remainder machinery re-routes them to survivors —
        the planned handoff, zero duplicated completions."""
        self.stats.scale_ins += 1
        if obs_mod.config().enabled:
            obs_mod.hot.fleet_scale("in", "idle").inc()
        self._decommission(rid, "scale_in", direction="in")

    def shutdown(self) -> None:
        """Exit: stop the loop, then decommission every member still
        mid-transition (provisioning/warming members never entered the
        ring; draining members finish their handoff now). SERVING
        members are left alone — the fleet engine's own shutdown owns
        them."""
        self.stop()
        with self._lock:
            for rid, st in list(self._members.items()):
                if st in (PROVISIONING, WARMING, DRAINING):
                    self._decommission(rid, "shutdown")

    # -- control loop ------------------------------------------------------

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name="advspec-autoscale", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=5.0)
            self._thread = None

    def begin_drain(self) -> None:
        """SIGTERM path: freeze scaling decisions — the daemon's drain
        owns the fleet's fate from here."""
        self._stop.set()

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                self.tick()
            except Exception:
                # The loop must outlive a bad tick (a dead controller
                # is silent un-elasticity); the desired/alive gauge
                # divergence and scale counters surface persistent
                # failure.
                pass
            self._stop.wait(max(fleet_mod.config().scale_interval_s, 0.001))

    # -- the decision ------------------------------------------------------

    def tick(self) -> bool:
        """One scaling decision; True if membership changed. The loop
        thread calls exactly this — the deterministic drills call it
        directly with injected clocks."""
        cfg = fleet_mod.config()
        snap = self._pressure() if self._pressure is not None else {}
        backlog = int(snap.get("backlog_tokens", 0))
        brownout = bool(snap.get("brownout", False))
        draining = bool(snap.get("draining", False))
        with self._lock:
            self._last_backlog = backlog
            self._reconcile()
            if self._disagg():
                return self._tick_disagg(cfg, snap, brownout, draining)
            serving = self._serving_ids()
            n = len(serving)
            per = serve_mod.config().max_backlog_tokens
            want_out = (
                not draining
                and n < cfg.max_replicas
                and (
                    brownout
                    or backlog >= cfg.scale_out_fraction * per * max(n, 1)
                )
            )
            # Scale-in asks: would the backlog still be comfortable on
            # one fewer replica? Measured against the SHRUNK capacity
            # so out/in thresholds cannot overlap (no flapping band).
            want_in = (
                not draining
                and not brownout
                and n > cfg.min_replicas
                and backlog
                <= cfg.scale_in_fraction * per * max(n - 1, 1)
            )
            self._out_streak = self._out_streak + 1 if want_out else 0
            self._in_streak = self._in_streak + 1 if want_in else 0
            decision = None
            if self._out_streak >= cfg.scale_out_ticks and want_out:
                decision = "out"
            elif self._in_streak >= cfg.scale_in_ticks and want_in:
                decision = "in"
            if decision is None:
                self._set_desired(max(n, cfg.min_replicas))
                return False
            now = self._clock()
            if (
                self._last_change_t is not None
                and now - self._last_change_t < cfg.scale_cooldown_s
            ):
                # Hysteresis fired but the cooldown vetoes: a flap the
                # controller refused to make.
                self.stats.flaps_suppressed += 1
                return False
            if decision == "out":
                reason = "brownout" if brownout else "backlog"
                return self._scale_out(snap, n, reason=reason, cfg=cfg)
            return self._scale_in(snap, n, cfg=cfg)

    def _disagg(self) -> bool:
        """Whether the managed fleet is role-split (prefill/decode
        disaggregation) — flips the tick to per-role decisions."""
        return getattr(self._engine, "prefill_replicas", 0) > 0

    def _tick_disagg(self, cfg, snap, brownout: bool, draining: bool) -> bool:
        """Role-aware decision (caller holds the lock): each pool
        reads ITS half of the scheduler's backlog split — prefill-
        token backlog sizes the prefill pool, the decode remainder
        sizes the decode pool — under its own min/max and its own
        hysteresis streak. The winning decision runs through the SAME
        spawn/warm/ring and drain/retire paths as a symmetric fleet;
        the lifecycle machine never learns about roles."""
        per = serve_mod.config().max_backlog_tokens
        pools = (
            (
                "prefill",
                int(snap.get("prefill_backlog_tokens", 0)),
                cfg.min_prefill_replicas,
                cfg.max_prefill_replicas,
            ),
            (
                "decode",
                int(snap.get("decode_backlog_tokens", 0)),
                cfg.min_replicas,
                cfg.max_replicas,
            ),
        )
        n_total = len(self._serving_ids())
        decision = None
        for role, backlog, lo, hi in pools:
            n = len(self._serving_ids(role))
            want_out = (
                not draining
                and n < hi
                and (
                    brownout
                    or backlog >= cfg.scale_out_fraction * per * max(n, 1)
                )
            )
            want_in = (
                not draining
                and not brownout
                and n > lo
                and backlog
                <= cfg.scale_in_fraction * per * max(n - 1, 1)
            )
            self._out_streaks[role] = (
                self._out_streaks.get(role, 0) + 1 if want_out else 0
            )
            self._in_streaks[role] = (
                self._in_streaks.get(role, 0) + 1 if want_in else 0
            )
            if decision is not None:
                continue  # streaks still advance for the other pool
            if self._out_streaks[role] >= cfg.scale_out_ticks and want_out:
                decision = (
                    role, "out", "brownout" if brownout else "backlog"
                )
            elif self._in_streaks[role] >= cfg.scale_in_ticks and want_in:
                decision = (role, "in", "idle")
        if decision is None:
            self._set_desired(
                max(n_total, cfg.min_replicas + cfg.min_prefill_replicas)
            )
            return False
        now = self._clock()
        if (
            self._last_change_t is not None
            and now - self._last_change_t < cfg.scale_cooldown_s
        ):
            self.stats.flaps_suppressed += 1
            return False
        role, direction, reason = decision
        if direction == "out":
            return self._scale_out(
                snap, n_total, reason=reason, cfg=cfg, role=role
            )
        return self._scale_in(snap, n_total, cfg=cfg, role=role)

    def _reconcile(self) -> None:
        """Members the ROUTER retired behind our back (transport
        fault, heartbeat miss) funnel through the surgery too, so the
        two machines never disagree about who is alive."""
        ring = set(self._router.alive_ids())
        for rid, st in list(self._members.items()):
            if st == SERVING and rid not in ring:
                self._decommission(
                    rid, self._router.retired_reason(rid) or "dead"
                )

    def _serving_ids(self, role: str | None = None) -> list[str]:
        ring = set(self._router.alive_ids())
        out = []
        for rid, st in self._members.items():
            if st != SERVING or rid not in ring:
                continue
            if role is not None:
                rep = self._router.replica(rid)
                if getattr(rep, "role", "") != role:
                    continue
            out.append(rid)
        return out

    # -- scale-out: spawn -> warm -> ping -> ring --------------------------

    def _scale_out(
        self, snap: dict, n: int, *, reason: str, cfg, role: str = ""
    ) -> bool:
        rid = self._engine.reserve_replica_id()
        self._set_desired(n + 1)
        self._begin_provision(rid)
        self._emit("provision", replica=rid, direction="out", reason=reason)
        try:
            rep = self._engine.spawn_replica(
                rid,
                role=role,
                retries=cfg.spawn_retries,
                sleep=self._sleep,
                rng=self._rng,
            )
        except SpawnFailed:
            self.stats.spawn_failures += 1
            self._reset_streak("out", role)
            self._last_change_t = self._clock()  # never loop hot
            self._set_desired(n)
            self._abort_warm(rid, "spawn_failed")
            return False
        self._pending[rid] = rep
        self._advance(rid, WARMING)
        self._emit("warming", replica=rid, direction="out", reason=reason)
        try:
            rep.warm(self._hot_models(snap))
            if not rep.ping():
                raise RuntimeError(f"{rid} failed post-warm ping")
        except Exception:
            # Died WHILE warming: never entered the ring, never will.
            self._reset_streak("out", role)
            self._last_change_t = self._clock()
            self._set_desired(n)
            self._abort_warm(rid, "warm_failed")
            return False
        self._pending.pop(rid, None)
        self._router.admit_replica(rep)
        self._advance(rid, SERVING)
        self.stats.scale_outs += 1
        if obs_mod.config().enabled:
            obs_mod.hot.fleet_scale("out", reason).inc()
        self._emit("serving", replica=rid, direction="out", reason=reason)
        self._last_change_t = self._clock()
        self._reset_streak("out", role)
        return True

    def _reset_streak(self, direction: str, role: str = "") -> None:
        if direction == "out":
            self._out_streak = 0
            if role:
                self._out_streaks[role] = 0
        else:
            self._in_streak = 0
            if role:
                self._in_streaks[role] = 0

    def _hot_models(self, snap: dict) -> list[str]:
        """Hottest models in the scheduler's active mix (already
        sorted hottest-first) — the warm-up's residency preload."""
        mix = snap.get("model_mix") or {}
        return list(mix)[:WARM_TOP_K]

    # -- scale-in: un-ring -> drain -> retire ------------------------------

    def _scale_in(self, snap: dict, n: int, *, cfg, role: str = "") -> bool:
        serving = self._serving_ids(role or None)
        floor = (
            cfg.min_prefill_replicas if role == "prefill"
            else cfg.min_replicas
        )
        if len(serving) <= floor:
            return False
        load = self._router.affinity_load(snap.get("active_keys") or [])
        # Least-affine loses; ties break toward the NEWEST replica
        # (its prefix cache had the least time to warm).
        victim = min(
            serving, key=lambda rid: (load.get(rid, 0), -self._rid_index(rid))
        )
        self._set_desired(n - 1)
        self._advance(victim, DRAINING)
        self._emit("draining", replica=victim, direction="in", reason="idle")
        self._router.drain_replica(victim)
        # Out of the ring, transport open: wait for in-flight units to
        # finish on the victim. The cooldown doubles as the drain
        # budget — the next membership change cannot happen sooner
        # anyway. A stalled victim is retired mid-batch and the
        # remainder machinery hands its units to survivors.
        deadline = self._clock() + max(cfg.scale_cooldown_s, _DRAIN_POLL_S)
        while (
            self._router.inflight(victim) > 0 and self._clock() < deadline
        ):
            # Deliberate sleep under the membership lock: membership
            # changes are serialized by design, and nothing on the
            # serving path blocks on this lock (capacity and pressure
            # reads go through lock-free snapshots).
            self._sleep(_DRAIN_POLL_S)  # graftlint: disable=GL-LOCK-BLOCKING -- drain poll; membership changes are intentionally serialized under this lock
        self._finish_scale_in(victim)
        self._last_change_t = self._clock()
        self._reset_streak("in", role)
        return True

    @staticmethod
    def _rid_index(rid: str) -> int:
        try:
            return int(rid.lstrip("r"))
        except ValueError:
            return 0

    # -- telemetry ---------------------------------------------------------

    def _set_desired(self, desired: int) -> None:
        self._desired = desired
        if obs_mod.config().enabled:
            obs_mod.hot.fleet_replicas_desired.set(float(desired))

    def _emit(
        self, op: str, *, replica: str = "", direction: str = "", reason: str = ""
    ) -> None:
        if obs_mod.config().enabled:
            obs_mod.hot.fleet_replicas_desired.set(float(self._desired))
        obs_mod.emit(
            obs_mod.ScaleEvent(
                replica=replica,
                op=op,
                direction=direction,
                reason=reason,
                desired=self._desired,
                alive=len(self._router.alive_ids()),
                backlog_tokens=self._last_backlog,
            )
        )
