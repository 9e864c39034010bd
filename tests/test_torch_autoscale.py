"""The port's autoscaler (``adversarial_spec_tpu_torch/fleet/autoscale.py``)
held to the reference's autoscaler tests (``tests/test_autoscale.py``).

Everything here is deterministic: the drills inject a mock clock, a
recording ``sleep``, and a scripted pressure snapshot, then call
``tick()`` directly — the same entry point the loop thread uses. The
contracts pinned: warm-before-ring scale-out, bounded and typed spawn
retry, lose-nothing scale-in, hysteresis and cooldown, one lifecycle
machine (GL-LIFECYCLE live-fire on the port's source), the serve
coupling, and the mock-clock scale storm (``chaos`` marker), on
in-process replicas of the port's mock engine.
"""

from __future__ import annotations

import json
from pathlib import Path

import pytest

from tests import torch_cli_support as sup

from adversarial_spec_tpu_torch import fleet as fleet_mod
from adversarial_spec_tpu_torch import obs as obs_mod
from adversarial_spec_tpu_torch import serve as serve_mod
from adversarial_spec_tpu_torch.fleet import replica as replica_mod
from adversarial_spec_tpu_torch.fleet.autoscale import (
    DRAINING,
    PROVISIONING,
    RETIRED,
    SERVING,
    WARMING,
    Autoscaler,
)
from adversarial_spec_tpu_torch.fleet.hashring import HashRing
from adversarial_spec_tpu_torch.fleet.replica import ReplicaDead, SpawnFailed
from adversarial_spec_tpu_torch.fleet.router import FleetEngine


@pytest.fixture(autouse=True)
def _port_state(tmp_path, monkeypatch):
    yield from sup.isolate_port(tmp_path, monkeypatch)


class FakeClock:
    def __init__(self, t: float = 0.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


def _pressure(
    backlog=0, brownout=False, draining=False, keys=(), mix=None
):
    """A scripted pressure_snapshot provider (constant)."""
    snap = {
        "backlog_tokens": backlog,
        "brownout": brownout,
        "draining": draining,
        "active_keys": list(keys),
        "model_mix": dict(mix or {}),
    }
    return lambda: dict(snap)


def _elastic_cfg(**kw):
    base = dict(
        enabled=True,
        replicas=1,
        transport="inproc",
        autoscale=True,
        min_replicas=1,
        max_replicas=3,
        scale_out_fraction=0.6,
        scale_in_fraction=0.15,
        scale_out_ticks=1,
        scale_in_ticks=1,
        scale_cooldown_s=0.0,
        scale_interval_s=0.01,
    )
    base.update(kw)
    return fleet_mod.configure(**base)


def _scale_ops(replica=None):
    return [
        (e["op"], e["replica"], e["reason"])
        for e in obs_mod.recorder.events()
        if e["type"] == "scale"
        and (replica is None or e["replica"] == replica)
    ]


class TestScaleOut:
    def test_warm_before_ring_with_hot_model_preload(self):
        """THE scale-out contract: the new replica is warmed (with the
        hottest models from the scheduler's mix, capped at the top-K)
        and pinged while still INVISIBLE to the ring — admission is the
        last step, so no request ever routes to a cold replica."""
        _elastic_cfg()
        obs_mod.reset_stats()
        eng = FleetEngine(replicas=1)
        # 6 models, hottest first — the warm-up must take the top 4.
        mix = {f"mock://critic?v={k}": 9 - k for k in range(6)}
        scaler = Autoscaler(
            eng,
            pressure=_pressure(backlog=10**6, brownout=True, mix=mix),
            clock=FakeClock(),
            sleep=lambda s: None,
        )
        ringed_at_warm: list[bool] = []
        warmed_with: list[list[str]] = []
        orig_spawn = eng.spawn_replica

        def spawn(rid=None, **kw):
            rep = orig_spawn(rid, **kw)
            orig_warm = rep.warm

            def warm(models):
                ringed_at_warm.append(rep.id in eng.router.alive_ids())
                warmed_with.append(list(models))
                return orig_warm(models)

            rep.warm = warm
            return rep

        eng.spawn_replica = spawn
        try:
            assert scaler.tick() is True
            assert ringed_at_warm == [False]
            assert warmed_with == [
                [f"mock://critic?v={k}" for k in range(4)]
            ]
            assert sorted(eng.router.alive_ids()) == ["r0", "r1"]
            assert scaler.member_state("r1") == SERVING
            assert fleet_mod.stats.scale_outs == 1
            # The lifecycle edges, in order, in the flight recorder.
            assert [op for op, _, _ in _scale_ops("r1")] == [
                "provision",
                "warming",
                "serving",
            ]
            # Counter + gauge pair: scale total by (direction, reason),
            # desired tracking actual.
            assert (
                obs_mod.hot.fleet_scale("out", "brownout").value == 1.0
            )
            assert obs_mod.hot.fleet_replicas_desired.value == 2.0
            assert obs_mod.hot.fleet_replicas_alive.value == 2.0
        finally:
            scaler.shutdown()
            eng.shutdown()

    def test_ceiling_is_hard(self):
        _elastic_cfg(max_replicas=2)
        eng = FleetEngine(replicas=2)
        spawns: list[str] = []
        eng.spawn_replica = lambda rid=None, **kw: spawns.append(rid)
        scaler = Autoscaler(
            eng,
            pressure=_pressure(backlog=10**9, brownout=True),
            clock=FakeClock(),
            sleep=lambda s: None,
        )
        try:
            for _ in range(5):
                assert scaler.tick() is False
            assert spawns == []
            assert len(eng.router.alive_ids()) == 2
        finally:
            scaler.shutdown()
            eng.shutdown()

    def test_daemon_drain_freezes_scaling(self):
        """A draining daemon must not grow the fleet it is abandoning."""
        _elastic_cfg()
        eng = FleetEngine(replicas=1)
        scaler = Autoscaler(
            eng,
            pressure=_pressure(backlog=10**9, brownout=True, draining=True),
            clock=FakeClock(),
            sleep=lambda s: None,
        )
        try:
            assert scaler.tick() is False
            assert len(eng.router.alive_ids()) == 1
        finally:
            scaler.shutdown()
            eng.shutdown()


class TestSpawnHardening:
    def test_bounded_retry_backoff_is_jittered_and_typed(self, monkeypatch):
        """spawn_replica semantics: each failed attempt tears down and
        retries after ``base * 2^k * (0.5 + U[0,1))``; after the
        retries exhaust the typed SpawnFailed carries the attempt
        count. Injected sleep/rng make the jitter exact."""

        class _NeverUp:
            def __init__(self, rid, engine_factory=None, role=""):
                self.id = rid
                self.role = role
                self.closed = False

            def ping(self):
                return False

            def close(self):
                self.closed = True

        monkeypatch.setattr(replica_mod, "InProcessReplica", _NeverUp)
        sleeps: list[float] = []
        with pytest.raises(SpawnFailed) as ei:
            replica_mod.spawn_replica(
                "r9",
                "inproc",
                retries=2,
                backoff_base_s=0.05,
                sleep=sleeps.append,
                rng=lambda: 0.5,
            )
        assert ei.value.attempts == 3
        assert ei.value.replica == "r9"
        assert sleeps == pytest.approx([0.05, 0.1])  # 0.05*2^k*(0.5+0.5)

    def test_spawn_failed_counted_and_cooled_never_hot_loops(self):
        """A broken spawn path must not be retried every tick: the
        failure enters cooldown exactly like a membership change, so
        the retry rate is bounded by scale_cooldown_s."""
        _elastic_cfg(scale_cooldown_s=5.0)
        obs_mod.reset_stats()
        eng = FleetEngine(replicas=1)
        attempts: list[str] = []

        def failing_spawn(rid=None, **kw):
            attempts.append(rid)
            raise SpawnFailed(rid, 4, "scripted")

        eng.spawn_replica = failing_spawn
        clock = FakeClock()
        scaler = Autoscaler(
            eng,
            pressure=_pressure(brownout=True),
            clock=clock,
            sleep=lambda s: None,
        )
        try:
            assert scaler.tick() is False
            assert fleet_mod.stats.spawn_failures == 1
            assert attempts == ["r1"]
            assert scaler.member_state("r1") == RETIRED
            assert "r1" not in eng.router.alive_ids()
            assert scaler.desired == 1  # target restored
            # Still inside the cooldown: pressure persists but no new
            # spawn attempt happens — the veto is counted as a
            # suppressed flap.
            clock.advance(1.0)
            assert scaler.tick() is False
            assert attempts == ["r1"]
            assert fleet_mod.stats.flaps_suppressed == 1
            # Past the cooldown the controller tries again.
            clock.advance(5.0)
            scaler.tick()
            assert len(attempts) == 2
            assert fleet_mod.stats.spawn_failures == 2
            assert ("spawn_failed", "r1", "spawn_failed") in _scale_ops()
        finally:
            scaler.shutdown()
            eng.shutdown()

    def test_dies_while_warming_decommissioned_never_ringed(self):
        """Regression pin: a replica that dies BETWEEN spawn and ring
        admission is decommissioned through the surgery — transport
        closed, member RETIRED — and the ring never saw it."""
        _elastic_cfg()
        obs_mod.reset_stats()
        eng = FleetEngine(replicas=1)
        spawned = []
        orig_spawn = eng.spawn_replica

        def spawn(rid=None, **kw):
            rep = orig_spawn(rid, **kw)

            def dying_warm(models):
                raise ReplicaDead(rep.id, "died mid-warm")

            rep.warm = dying_warm
            spawned.append(rep)
            return rep

        eng.spawn_replica = spawn
        scaler = Autoscaler(
            eng,
            pressure=_pressure(brownout=True),
            clock=FakeClock(),
            sleep=lambda s: None,
        )
        try:
            assert scaler.tick() is False
            (rep,) = spawned
            assert rep.id not in eng.router.alive_ids()
            assert scaler.member_state(rep.id) == RETIRED
            assert rep.closed  # decommission closed the transport
            assert fleet_mod.stats.scale_outs == 0
            assert [op for op, _, _ in _scale_ops(rep.id)] == [
                "provision",
                "warming",
                "spawn_failed",
                "retired",
            ]
            retired = [
                e
                for e in obs_mod.recorder.events()
                if e["type"] == "scale" and e["op"] == "retired"
            ]
            assert retired[0]["reason"] == "warm_failed"
            # The router never emitted "ready" for it: never routable.
            readies = [
                e["replica"]
                for e in obs_mod.recorder.events()
                if e["type"] == "replica" and e["op"] == "ready"
            ]
            assert rep.id not in readies
        finally:
            scaler.shutdown()
            eng.shutdown()


class TestFlapControl:
    def test_hysteresis_requires_consecutive_ticks(self):
        """An oscillating pressure trace (pressure every OTHER tick)
        never reaches a 2-tick streak: zero membership changes."""
        _elastic_cfg(scale_out_ticks=2)
        eng = FleetEngine(replicas=1)
        snap = {"backlog_tokens": 0, "brownout": False}
        scaler = Autoscaler(
            eng,
            pressure=lambda: dict(snap),
            clock=FakeClock(),
            sleep=lambda s: None,
        )
        try:
            for i in range(8):
                snap["brownout"] = i % 2 == 0
                assert scaler.tick() is False
            assert fleet_mod.stats.scale_outs == 0
            assert len(eng.router.alive_ids()) == 1
            # Sustained pressure DOES cross the streak.
            snap["brownout"] = True
            assert scaler.tick() is False
            assert scaler.tick() is True
            assert len(eng.router.alive_ids()) == 2
        finally:
            scaler.shutdown()
            eng.shutdown()

    def test_cooldown_vetoes_and_counts_flaps(self):
        _elastic_cfg(scale_cooldown_s=10.0)
        eng = FleetEngine(replicas=1)
        clock = FakeClock()
        scaler = Autoscaler(
            eng,
            pressure=_pressure(brownout=True),
            clock=clock,
            sleep=lambda s: None,
        )
        try:
            assert scaler.tick() is True  # first change is free
            for _ in range(4):
                clock.advance(1.0)
                assert scaler.tick() is False
            assert fleet_mod.stats.flaps_suppressed == 4
            assert fleet_mod.stats.scale_outs == 1
            assert len(eng.router.alive_ids()) == 2
            clock.advance(10.0)  # past the cooldown: allowed again
            assert scaler.tick() is True
            assert len(eng.router.alive_ids()) == 3
        finally:
            scaler.shutdown()
            eng.shutdown()

    def test_out_and_in_thresholds_cannot_overlap(self):
        """want_in measures against the SHRUNK capacity (n-1), so for
        any backlog at most one of want_out/want_in can hold — no
        pressure value oscillates the controller by itself."""
        _elastic_cfg(scale_out_ticks=1, scale_in_ticks=1)
        eng = FleetEngine(replicas=2)
        cfg = fleet_mod.config()
        per = serve_mod.config().max_backlog_tokens
        out_at = cfg.scale_out_fraction * per * 2
        in_at = cfg.scale_in_fraction * per * 1
        assert in_at < out_at  # the dead band exists
        # A backlog inside the band: neither direction fires.
        scaler = Autoscaler(
            eng,
            pressure=_pressure(backlog=int((in_at + out_at) / 2)),
            clock=FakeClock(),
            sleep=lambda s: None,
        )
        try:
            for _ in range(5):
                assert scaler.tick() is False
            assert len(eng.router.alive_ids()) == 2
        finally:
            scaler.shutdown()
            eng.shutdown()


class TestScaleIn:
    def test_least_affine_victim_drains_then_retires(self):
        """Scale-in order: the victim (owning the FEWEST active keys)
        leaves the ring first, in-flight units drain while survivors
        take new work, then the lifecycle retires it — and the whole
        handoff duplicates nothing."""
        _elastic_cfg(replicas=3, scale_cooldown_s=1.0)
        obs_mod.reset_stats()
        eng = FleetEngine(replicas=3)
        keys = [f"debate-{i}" for i in range(60)]
        load = eng.router.affinity_load(keys)
        expected = min(
            eng.router.alive_ids(),
            key=lambda rid: (load.get(rid, 0), -int(rid[1:])),
        )
        clock = FakeClock()
        # The victim reports in-flight work for 3 drain polls; each
        # poll must observe it OUT of the ring with its transport OPEN.
        state = {"polls": 3, "observed": []}

        def inflight(rid):
            state["observed"].append(
                (
                    rid in eng.router.alive_ids(),
                    eng.router.replica(rid).closed,
                )
            )
            if state["polls"] > 0:
                state["polls"] -= 1
                return 1
            return 0

        eng.router.inflight = inflight
        sleeps: list[float] = []

        def sleep(s):
            sleeps.append(s)
            clock.advance(s)

        scaler = Autoscaler(
            eng,
            pressure=_pressure(backlog=0, keys=keys),
            clock=clock,
            sleep=sleep,
        )
        try:
            assert scaler.tick() is True
            assert expected not in eng.router.alive_ids()
            assert len(eng.router.alive_ids()) == 2
            assert scaler.member_state(expected) == RETIRED
            assert fleet_mod.stats.scale_ins == 1
            assert fleet_mod.stats.duplicated_completions == 0
            assert len(sleeps) == 3  # drained, not deadline-killed
            # Every drain poll saw: un-ringed, transport still open.
            assert state["observed"][:3] == [(False, False)] * 3
            assert [op for op, _, _ in _scale_ops(expected)] == [
                "draining",
                "retired",
            ]
            assert obs_mod.hot.fleet_scale("in", "idle").value == 1.0
        finally:
            scaler.shutdown()
            eng.shutdown()

    def test_floor_is_hard(self):
        _elastic_cfg(min_replicas=1)
        eng = FleetEngine(replicas=1)
        scaler = Autoscaler(
            eng,
            pressure=_pressure(backlog=0),
            clock=FakeClock(),
            sleep=lambda s: None,
        )
        try:
            for _ in range(5):
                assert scaler.tick() is False
            assert len(eng.router.alive_ids()) == 1
            assert fleet_mod.stats.scale_ins == 0
        finally:
            scaler.shutdown()
            eng.shutdown()

    def test_stalled_victim_is_retired_at_the_drain_deadline(self):
        """A victim that never drains is retired mid-batch — the
        planned handoff degrades to the ReplicaDead-remainder path
        instead of wedging the controller."""
        _elastic_cfg(replicas=2, min_replicas=1, scale_cooldown_s=0.05)
        eng = FleetEngine(replicas=2)
        eng.router.inflight = lambda rid: 1  # never drains
        clock = FakeClock()
        scaler = Autoscaler(
            eng,
            pressure=_pressure(backlog=0),
            clock=clock,
            sleep=lambda s: clock.advance(s),
        )
        try:
            assert scaler.tick() is True
            assert len(eng.router.alive_ids()) == 1
            assert fleet_mod.stats.scale_ins == 1
        finally:
            scaler.shutdown()
            eng.shutdown()


class TestLifecycle:
    def test_reconcile_funnels_router_retirements(self):
        """The router retiring a member behind the controller's back
        (heartbeat miss) reaches the SAME surgery on the next tick, so
        the two machines never disagree about who is alive."""
        _elastic_cfg(replicas=2)
        obs_mod.reset_stats()
        eng = FleetEngine(replicas=2)
        scaler = Autoscaler(
            eng,
            pressure=_pressure(),
            clock=FakeClock(),
            sleep=lambda s: None,
        )
        try:
            eng.router._retire_replica("r0", "heartbeat")
            scaler.tick()
            assert scaler.member_state("r0") == RETIRED
            retired = [
                e
                for e in obs_mod.recorder.events()
                if e["type"] == "scale"
                and e["op"] == "retired"
                and e["replica"] == "r0"
            ]
            assert retired and retired[0]["reason"] == "heartbeat"
        finally:
            scaler.shutdown()
            eng.shutdown()

    def test_shutdown_decommissions_mid_transition_members_only(self):
        """Exit path: shutdown closes never-ringed pending transports
        and retires draining members, but leaves SERVING members to the
        fleet engine's own shutdown (they are the fleet, not the
        controller's transients)."""
        _elastic_cfg()
        eng = FleetEngine(replicas=1)

        class _Transport:
            closed = False

            def close(self):
                self.closed = True

        t = _Transport()
        scaler = Autoscaler(
            eng,
            pressure=_pressure(),
            clock=FakeClock(),
            sleep=lambda s: None,
        )
        scaler._members["r9"] = WARMING
        scaler._pending["r9"] = t
        scaler.shutdown()
        assert t.closed
        assert scaler.member_state("r9") == RETIRED
        assert scaler.member_state("r0") == SERVING
        assert eng.router.alive_ids() == ["r0"]
        eng.shutdown()

    def test_decommission_is_idempotent(self):
        _elastic_cfg()
        eng = FleetEngine(replicas=1)
        scaler = Autoscaler(
            eng,
            pressure=_pressure(),
            clock=FakeClock(),
            sleep=lambda s: None,
        )
        try:
            scaler._decommission("r0", "scale_in", direction="in")
            before = eng.router._dead.get("r0")
            scaler._decommission("r0", "other")  # second is a no-op
            assert eng.router._dead["r0"] == before == "scale_in"
            assert scaler.member_state("r0") == RETIRED
        finally:
            scaler.shutdown()
            eng.shutdown()


class TestServeCoupling:
    def test_capacity_provider_stretches_admission_and_brownout(self):
        """The elastic half of admission control: the backlog cap (and
        with it the brownout thresholds) scales with the routable
        replica count; a broken provider fails safe to factor 1."""
        from adversarial_spec_tpu_torch.serve.sched import ServeScheduler

        serve_mod.configure(max_backlog_tokens=1000)
        sched = ServeScheduler()
        shed = sched.try_admit("t0", "interactive", "d1", 1500)
        assert shed is not None and shed.reason == "backlog"
        sched.set_capacity_provider(lambda: 2)
        assert sched.try_admit("t0", "interactive", "d1", 1500) is None
        snap = sched.pressure_snapshot()
        assert snap["capacity_tokens"] == 2000
        assert snap["backlog_tokens"] == 1500
        assert "d1" in snap["active_keys"]
        sched.set_capacity_provider(lambda: 1 / 0)
        assert sched._capacity_tokens(serve_mod.config()) == 1000

    def test_model_mix_feeds_the_warm_preload_hottest_first(self):
        from adversarial_spec_tpu_torch.serve.sched import ServeScheduler

        serve_mod.configure(max_backlog_tokens=10**6)
        sched = ServeScheduler()
        assert (
            sched.try_admit(
                "t0", "batch", "d1", 10, models=["m-b", "m-a"]
            )
            is None
        )
        assert (
            sched.try_admit("t0", "batch", "d2", 10, models=["m-a"])
            is None
        )
        mix = sched.pressure_snapshot()["model_mix"]
        assert list(mix) == ["m-a", "m-b"]  # hottest first, name ties
        assert mix == {"m-a": 2, "m-b": 1}


class TestScaleEvents:
    def test_scale_event_validation(self):
        from adversarial_spec_tpu_torch.obs.events import (
            SCALE_DIRECTIONS,
            SCALE_OPS,
            ScaleEvent,
            event_to_dict,
            validate_event,
        )

        good = event_to_dict(
            1,
            ScaleEvent(
                replica="r1",
                op="serving",
                direction="out",
                reason="backlog",
                desired=2,
                alive=2,
                backlog_tokens=4096,
            ),
        )
        assert validate_event(json.loads(json.dumps(good))) == []
        assert validate_event(event_to_dict(2, ScaleEvent(op="grew")))
        assert validate_event(
            event_to_dict(3, ScaleEvent(direction="sideways"))
        )
        # The wire enum mirrors the lifecycle states (the provision
        # EDGE is named for the transition, not the state), plus the
        # one non-state edge.
        for state in (WARMING, SERVING, DRAINING, RETIRED):
            assert state in SCALE_OPS
        assert "provision" in SCALE_OPS
        assert "spawn_failed" in SCALE_OPS
        assert PROVISIONING == "provisioning"
        assert SCALE_DIRECTIONS == ("out", "in", "")


class TestAutoscaleLifecycleLint:
    def test_exit_skipping_the_decommission_surgery_fires(self):
        """GL-LIFECYCLE's autoscaler machine is LIVE on the real
        source: a scale-in exit that marks the member RETIRED directly
        instead of funnelling through _decommission is permanently
        caught."""
        from tools.graftlint.config import GraftlintConfig
        from tools.graftlint.core import lint_sources

        src = Path("adversarial_spec_tpu_torch/fleet/autoscale.py").read_text(
            encoding="utf-8"
        )
        broken = src.replace(
            '        self._decommission(rid, "scale_in", direction="in")\n',
            "        self._members[rid] = RETIRED\n",
        )
        assert broken != src, "scale-in surgery call not found to strip"
        cfg = GraftlintConfig(package="pkg")
        findings = lint_sources(
            {"pkg/autoscale.py": broken}, rules=["GL-LIFECYCLE"], cfg=cfg
        )
        msgs = [f.message for f in findings]
        assert any(
            "Autoscaler._finish_scale_in never reaches" in m for m in msgs
        ), msgs
        # The committed source is clean under the same config.
        assert (
            lint_sources(
                {"pkg/autoscale.py": src}, rules=["GL-LIFECYCLE"], cfg=cfg
            )
            == []
        )


def _movement(before: list[str], after: list[str]) -> float:
    """Fraction of a fixed key sample whose primary owner changes
    between two memberships (real HashRing math — mirrors
    the reference's scale-storm drill)."""
    ra, rb = HashRing(before), HashRing(after)
    n = 2000
    moved = sum(
        1
        for k in range(n)
        if ra.primary(f"debate-{k}") != rb.primary(f"debate-{k}")
    )
    return moved / n


@pytest.mark.chaos
class TestMockClockScaleStorm:
    """The deterministic variant of the reference's scale-storm drill: a scripted backlog step drives the controller to
    the ceiling, the trough drives it back to the floor, and every
    membership change moves ~1/N of the keyspace — on a mock clock, so
    the whole storm is replayable tick for tick."""

    def test_storm_grows_to_ceiling_shrinks_to_floor(self):
        _elastic_cfg(
            scale_out_ticks=2,
            scale_in_ticks=3,
            scale_cooldown_s=1.0,
            max_replicas=3,
        )
        eng = FleetEngine(replicas=1)
        clock = FakeClock()
        snap = {
            "backlog_tokens": 0,
            "brownout": False,
            "active_keys": [],
            "model_mix": {},
        }
        ringed_at_warm: list[bool] = []
        orig_spawn = eng.spawn_replica

        def spawn(rid=None, **kw):
            rep = orig_spawn(rid, **kw)
            orig_warm = rep.warm

            def warm(models):
                ringed_at_warm.append(rep.id in eng.router.alive_ids())
                return orig_warm(models)

            rep.warm = warm
            return rep

        eng.spawn_replica = spawn
        scaler = Autoscaler(
            eng,
            pressure=lambda: dict(snap),
            clock=clock,
            sleep=lambda s: clock.advance(s),
        )
        memberships = [sorted(eng.router.alive_ids())]

        def tick():
            changed = scaler.tick()
            clock.advance(0.5)
            if changed:
                memberships.append(sorted(eng.router.alive_ids()))

        per = serve_mod.config().max_backlog_tokens
        try:
            # The step: sustained heavy backlog -> grow to the ceiling.
            snap["backlog_tokens"] = 10 * per
            for _ in range(10):
                tick()
            assert len(eng.router.alive_ids()) == 3
            # Warm-before-ring held for every growth step.
            assert ringed_at_warm == [False, False]
            # The trough: backlog drains -> shrink to the floor.
            snap["backlog_tokens"] = 0
            for _ in range(20):
                tick()
            assert len(eng.router.alive_ids()) == 1
            # Exactly the 4 planned changes — no flapping beyond them.
            assert fleet_mod.stats.scale_outs == 2
            assert fleet_mod.stats.scale_ins == 2
            assert fleet_mod.stats.duplicated_completions == 0
            # ~1/N of the keyspace moved per membership change.
            assert len(memberships) == 5
            for before, after in zip(memberships, memberships[1:]):
                n_ref = max(len(before), len(after))
                frac = _movement(before, after)
                assert 0.5 / n_ref <= frac <= min(1.0, 2.0 / n_ref), (
                    before,
                    after,
                    frac,
                )
            # Survivor invariants clean (the drill's `check` op).
            eng.router.check_invariants()
        finally:
            scaler.shutdown()
            eng.shutdown()


class TestRoleAwareScaling:
    """Disaggregated fleets scale per role: prefill-token backlog sizes
    the prefill pool, the decode remainder sizes the decode pool, each
    under its own floor/ceiling (docs/fleet.md "Disaggregation")."""

    def _role_pressure(self, prefill=0, decode=0, brownout=False):
        snap = {
            "backlog_tokens": prefill + decode,
            "prefill_backlog_tokens": prefill,
            "decode_backlog_tokens": decode,
            "brownout": brownout,
            "draining": False,
            "active_keys": [],
            "model_mix": {},
        }
        return lambda: dict(snap)

    def test_prefill_backlog_grows_only_the_prefill_pool(self):
        _elastic_cfg(
            replicas=2,
            max_replicas=4,
            min_prefill_replicas=1,
            max_prefill_replicas=2,
        )
        obs_mod.reset_stats()
        eng = FleetEngine(replicas=2, prefill_replicas=1)
        scaler = Autoscaler(
            eng,
            pressure=self._role_pressure(prefill=10**6, decode=0),
            clock=FakeClock(),
            sleep=lambda s: None,
        )
        try:
            assert scaler.tick() is True
            assert sorted(eng.router.alive_ids("prefill")) == ["r0", "r2"]
            assert eng.router.alive_ids("decode") == ["r1"]  # untouched
            # Ceiling is per-pool: the prefill pool is now full, so the
            # same pressure cannot grow it past max_prefill_replicas.
            assert scaler.tick() is False
        finally:
            scaler.shutdown()
            eng.shutdown()

    def test_idle_decode_pool_shrinks_to_its_own_floor(self):
        _elastic_cfg(
            replicas=3,
            min_replicas=1,
            max_replicas=4,
            min_prefill_replicas=1,
            max_prefill_replicas=2,
        )
        obs_mod.reset_stats()
        eng = FleetEngine(replicas=3, prefill_replicas=1)
        scaler = Autoscaler(
            eng,
            pressure=self._role_pressure(prefill=0, decode=0),
            clock=FakeClock(),
            sleep=lambda s: None,
        )
        try:
            # Decode pool (r1, r2) is idle above its floor: one leaves.
            assert scaler.tick() is True
            assert len(eng.router.alive_ids("decode")) == 1
            # Both pools now sit AT their floors: idleness changes
            # nothing — disaggregation never scales a pool to zero.
            assert scaler.tick() is False
            assert eng.router.alive_ids("prefill") == ["r0"]
            assert len(eng.router.alive_ids("decode")) == 1
        finally:
            scaler.shutdown()
            eng.shutdown()
