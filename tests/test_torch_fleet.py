"""The port's fleet (``adversarial_spec_tpu_torch/fleet``) held to the
reference's fleet tests: hash ring, replicas, router, failover, handoff.

Every test of ``tests/test_fleet.py`` but its worker-transport and chaos
classes (those are in ``test_torch_fleet_workers.py``) runs here on the
port's ``fleet/`` over in-process replicas of the port's mock engine:
fully deterministic, no subprocesses. The reference's tooling tests read
``tools/`` (which imports the JAX package) and the reference's committed
``BENCH_*.json`` files; here the port's fleet events are held to the
reference's encoding and rendered by the same tools, its sources are
linted by the same lifecycle rules, and the port's ``perf.fleet`` and
handoff ledger are held to the reference's schema.
"""

from __future__ import annotations

import json

import pytest

from tests import torch_cli_support as sup

from adversarial_spec_tpu_torch import fleet as fleet_mod
from adversarial_spec_tpu_torch import obs as obs_mod
from adversarial_spec_tpu_torch.engine.types import ChatRequest, Completion, SamplingParams
from adversarial_spec_tpu_torch.fleet.hashring import HashRing
from adversarial_spec_tpu_torch.fleet.replica import (
    InProcessReplica,
    ReplicaDead,
)
from adversarial_spec_tpu_torch.fleet.router import FleetEngine, FleetRouter
from adversarial_spec_tpu_torch.resilience import breaker as breaker_mod
from adversarial_spec_tpu_torch.resilience import injector as injector_mod
from adversarial_spec_tpu_torch.resilience.injector import FaultInjector, parse_chaos_spec


@pytest.fixture(autouse=True)
def _port_state(tmp_path, monkeypatch):
    yield from sup.isolate_port(tmp_path, monkeypatch)


PARAMS = SamplingParams()


def _req(model="mock://critic", key="debate-A", user=None, **kw):
    return ChatRequest(
        model=model,
        system="You are a reviewer.",
        user=(
            user
            if user is not None
            else "Debate round 1\n--- DOCUMENT ---\nA spec body.\n"
            "--- END DOCUMENT ---"
        ),
        affinity_key=key,
        **kw,
    )


class TestHashRing:
    def test_deterministic_and_sticky(self):
        a = HashRing(["r0", "r1", "r2"])
        b = HashRing(["r2", "r0", "r1"])  # insertion order irrelevant
        for key in (f"debate-{i}" for i in range(20)):
            assert a.primary(key) == b.primary(key)
            assert a.primary(key) == a.primary(key)

    def test_preference_is_distinct_and_complete(self):
        ring = HashRing(["r0", "r1", "r2"])
        pref = ring.preference("debate-x")
        assert sorted(pref) == ["r0", "r1", "r2"]
        assert pref[0] == ring.primary("debate-x")

    def test_membership_change_moves_only_the_affected_arc(self):
        """The consistent-hashing contract: removing one replica moves
        ONLY the keys it owned; everyone else's cache stays warm."""
        ring = HashRing(["r0", "r1", "r2"])
        keys = [f"debate-{i}" for i in range(64)]
        before = {k: ring.primary(k) for k in keys}
        ring.remove("r1")
        for k in keys:
            if before[k] != "r1":
                assert ring.primary(k) == before[k]
        ring.add("r1")
        assert {k: ring.primary(k) for k in keys} == before

    def test_add_moves_about_one_over_n_keys_to_the_new_node(self):
        """The scale-OUT half of the consistent-hashing contract: a
        node joining an N-1 ring takes ~1/N of the keyspace, every
        moved key moves TO the newcomer, and nothing else reshuffles."""
        ring = HashRing(["r0", "r1", "r2"])
        keys = [f"debate-{i}" for i in range(2000)]
        before = {k: ring.primary(k) for k in keys}
        ring.add("r3")
        moved = [k for k in keys if ring.primary(k) != before[k]]
        frac = len(moved) / len(keys)
        assert 0.5 / 4 <= frac <= 2.0 / 4, frac
        assert all(ring.primary(k) == "r3" for k in moved)

    def test_add_keeps_preference_order_of_existing_nodes(self):
        """Preference-order stability on add: the newcomer's vnode
        points interleave into the walk, but the RELATIVE failover
        order of the pre-existing replicas is untouched for every key
        (unmoved keys keep their failover order; moved keys keep their
        old chain right behind the new primary) — a scale-out must not
        scramble where a later failover would land."""
        ring = HashRing(["r0", "r1", "r2"])
        keys = [f"debate-{i}" for i in range(256)]
        pref_before = {k: ring.preference(k) for k in keys}
        ring.add("r3")
        for k in keys:
            after_without_new = [
                r for r in ring.preference(k) if r != "r3"
            ]
            assert after_without_new == pref_before[k], k

    def test_keys_spread_across_replicas(self):
        ring = HashRing(["r0", "r1", "r2"])
        owners = {ring.primary(f"debate-{i}") for i in range(64)}
        assert owners == {"r0", "r1", "r2"}

    def test_empty_ring(self):
        ring = HashRing()
        assert ring.primary("k") is None
        assert ring.preference("k") == []


class TestFleetConfig:
    def test_env_defaults(self, monkeypatch):
        monkeypatch.delenv("ADVSPEC_FLEET", raising=False)
        assert fleet_mod.env_enabled() is False  # fleet is opt-in
        monkeypatch.setenv("ADVSPEC_FLEET", "1")
        assert fleet_mod.env_enabled() is True
        monkeypatch.setenv("ADVSPEC_FLEET_REPLICAS", "5")
        assert fleet_mod.env_replicas() == 5
        monkeypatch.setenv("ADVSPEC_FLEET_TRANSPORT", "worker")
        assert fleet_mod.env_transport() == "worker"
        monkeypatch.setenv("ADVSPEC_FLEET_TRANSPORT", "bogus")
        assert fleet_mod.env_transport() == "inproc"

    def test_bad_transport_fails_at_the_knob(self):
        with pytest.raises(ValueError, match="unknown fleet transport"):
            fleet_mod.configure(transport="bogus")

    def test_armed_needs_two_replicas(self):
        fleet_mod.configure(enabled=True, replicas=1)
        assert not fleet_mod.armed()
        fleet_mod.configure(replicas=2)
        assert fleet_mod.armed()
        fleet_mod.configure(enabled=False)
        assert not fleet_mod.armed()

    def test_snapshot_payload(self):
        snap = fleet_mod.snapshot()
        for key in (
            "routed_requests",
            "affinity_hits",
            "failover_hops",
            "breaker_skips",
            "reissued_requests",
            "completed_requests",
            "duplicated_completions",
            "affinity_hit_rate",
            "enabled",
            "replicas",
            "transport",
        ):
            assert key in snap


class TestInProcessReplica:
    def test_serves_and_accounts(self):
        rep = InProcessReplica("r0")
        comps = rep.chat_batch([_req(), _req(model="mock://agree")], PARAMS)
        assert all(c.ok for c in comps)
        assert rep.served == {"mock://critic": 1, "mock://agree": 1}
        assert rep.busy_s > 0
        rep.check()  # invariants clean
        assert rep.stats()["replica"] == "r0"

    def test_consumer_keeps_original_batch_indexing(self):
        rep = InProcessReplica("r0")
        seen = []

        def consumer(row, text):
            seen.append(row)
            return True

        rep.chat_batch([_req(), _req()], PARAMS, consumer=consumer)
        # Each request is served as its own single-row engine call, but
        # the consumer must see the fleet batch's indexing.
        assert set(seen) == {0, 1}

    def test_replicas_do_not_share_prefix_caches(self):
        """The lifecycle seam: each replica owns a FRESH engine — the
        second replica serving the same prompt pays the full prefill
        (no cross-replica device-cache magic)."""
        r0, r1 = InProcessReplica("r0"), InProcessReplica("r1")
        c0 = r0.chat_batch([_req()], PARAMS)[0]
        c1 = r1.chat_batch([_req()], PARAMS)[0]
        assert c0.usage.cached_tokens == c1.usage.cached_tokens == 0

    def test_closed_replica_raises(self):
        rep = InProcessReplica("r0")
        rep.close()
        with pytest.raises(ReplicaDead):
            rep.chat_batch([_req()], PARAMS)


class _DyingReplica:
    """Serves ``die_after`` requests of a batch, then dies — the
    in-process stand-in for a SIGKILLed worker."""

    def __init__(self, replica_id: str, die_after: int):
        self.id = replica_id
        self.die_after = die_after
        self.closed = False

    def ping(self) -> bool:
        return not self.closed

    def chat_batch(self, requests, params, consumer=None, on_completion=None):
        partial = {}
        for j, req in enumerate(requests[: self.die_after]):
            comp = Completion(text=f"{self.id}:{req.model}")
            partial[j] = comp
            if on_completion is not None:
                on_completion(j, comp)
        raise ReplicaDead(self.id, "scripted death", partial)

    def validate(self, model):
        return None

    def check(self) -> None:
        pass

    def stats(self) -> dict:
        return {"replica": self.id, "served": {}, "busy_s": 0.0}

    def close(self) -> None:
        self.closed = True


class TestRouterRouting:
    def _engine(self, n=2, **kw):
        return FleetEngine(replicas=n, transport="inproc", **kw)

    def test_affinity_is_sticky_across_submits(self):
        eng = self._engine(3)
        for _ in range(3):
            eng.chat([_req(key="debate-sticky")] * 2, PARAMS)
        served = {
            s["replica"]: sum(s["served"].values())
            for s in eng.router.replica_stats()
            if s["served"]
        }
        assert len(served) == 1  # one replica owns the debate
        assert sum(served.values()) == 6
        eng.shutdown()

    def test_distinct_debates_spread(self):
        eng = self._engine(3)
        for d in range(12):
            eng.chat([_req(key=f"debate-{d}")], PARAMS)
        used = [s for s in eng.router.replica_stats() if s["served"]]
        assert len(used) >= 2
        eng.shutdown()

    def test_random_mode_round_robins(self):
        eng = self._engine(3, affinity=False)
        eng.chat([_req(key="debate-same")] * 3, PARAMS)
        used = [s for s in eng.router.replica_stats() if s["served"]]
        assert len(used) == 3  # same key, three replicas: no stickiness
        assert fleet_mod.stats.affinity_hits == 0
        eng.shutdown()

    def test_route_events_carry_trace_ids(self):
        obs_mod.reset_stats()
        eng = self._engine(2)
        eng.chat(
            [_req(trace_id="tr-001-01", span_id="tr-001-01/s00")], PARAMS
        )
        routes = [
            e
            for e in obs_mod.recorder.events()
            if e["type"] == "route"
        ]
        assert routes and routes[0]["trace_id"] == "tr-001-01"
        assert routes[0]["span_id"] == "tr-001-01/s00"
        assert routes[0]["reason"] == "affinity" and routes[0]["hop"] == 0
        eng.shutdown()

    def test_breaker_open_pair_skips_replica(self):
        reg = breaker_mod.BreakerRegistry(threshold=1, cooldown_s=1e9)
        eng = self._engine(2, breakers=reg)
        primary = eng.router._ring.preference("debate-A")[0]
        reg.record(
            breaker_mod.replica_key(primary, "mock://critic"), ok=False
        )
        comps = eng.chat([_req()], PARAMS)
        assert comps[0].ok
        assert fleet_mod.stats.breaker_skips >= 1
        # The pair breaker drained the primary for this model only:
        # the OTHER replica served it.
        assert not eng.router.replica(primary).served
        eng.shutdown()

    def test_injected_replica_fault_fails_over(self):
        injector_mod.install(
            FaultInjector(parse_chaos_spec("device_lost@replica:times=1"))
        )
        reg = breaker_mod.BreakerRegistry(threshold=3)
        eng = self._engine(2, breakers=reg)
        comps = eng.chat([_req(), _req()], PARAMS)
        assert all(c.ok for c in comps)
        assert fleet_mod.stats.failover_hops == 2
        # Both replicas still alive: the fault was replica-LEVEL, not
        # a transport death.
        assert len(eng.router.alive_ids()) == 2
        # The faulted pair fed its breaker.
        primary = eng.router._ring.preference("debate-A")[0]
        pair = breaker_mod.replica_key(primary, "mock://critic")
        assert reg.breaker(pair).failures == 2
        eng.shutdown()

    def test_no_routable_replica_resolves_with_error(self):
        injector_mod.install(
            FaultInjector(parse_chaos_spec("device_lost@replica:times=1"))
        )
        eng = self._engine(1)
        comps = eng.chat([_req()], PARAMS)
        assert not comps[0].ok
        assert "no routable replica" in comps[0].error
        eng.shutdown()

    def test_replica_death_keeps_partials_and_reroutes_rest(self):
        key = "debate-death"
        primary = HashRing(["r0", "r1"]).preference(key)[0]
        survivor = "r1" if primary == "r0" else "r0"
        dying = _DyingReplica(primary, die_after=2)
        healthy = InProcessReplica(survivor)
        router = FleetRouter([dying, healthy])
        reqs = [_req(model=f"mock://critic?v={k}", key=key) for k in range(4)]
        comps = router.submit(reqs, PARAMS)
        assert all(c.ok for c in comps)
        # The two that landed before death are the dying replica's.
        assert [c.text for c in comps[:2]] == [
            f"{primary}:mock://critic?v=0",
            f"{primary}:mock://critic?v=1",
        ]
        # The remainder re-routed; the survivor never saw the first two.
        assert healthy.served == {
            "mock://critic?v=2": 1,
            "mock://critic?v=3": 1,
        }
        assert fleet_mod.stats.reissued_requests == 2
        assert fleet_mod.stats.duplicated_completions == 0
        assert router.alive_ids() == [survivor]
        assert router._dead == {primary: "dead"}

    def test_heartbeat_miss_retires(self):
        obs_mod.reset_stats()
        eng = self._engine(2)
        victim = eng.router.alive_ids()[0]
        eng.router.replica(victim).closed = True  # ping now fails
        eng.router.health_check()
        assert victim not in eng.router.alive_ids()
        assert fleet_mod.stats.heartbeat_failures == 1
        ops = [
            (e["replica"], e["op"])
            for e in obs_mod.recorder.events()
            if e["type"] == "replica"
        ]
        assert (victim, "heartbeat_miss") in ops
        assert (victim, "retire") in ops
        eng.shutdown()

    def test_retire_is_idempotent_and_shutdown_funnels_through_it(self):
        eng = self._engine(2)
        eng.router._retire_replica("r0", "dead")
        eng.router._retire_replica("r0", "heartbeat")  # second is a no-op
        assert eng.router._dead["r0"] == "dead"
        eng.shutdown()
        assert eng.router.alive_ids() == []
        assert eng.router._dead["r1"] == "shutdown"


class TestDispatchIntegration:
    def test_get_engine_returns_fleet_when_armed(self):
        from adversarial_spec_tpu_torch.engine import dispatch

        fleet_mod.configure(enabled=True, replicas=2, transport="inproc")
        eng = dispatch.get_engine("mock://critic")
        assert isinstance(eng, FleetEngine)
        # One fleet serves every provider (that is the point).
        assert dispatch.get_engine("mock://agree") is eng
        fleet_mod.configure(enabled=False)
        from adversarial_spec_tpu_torch.engine.mock import MockEngine

        assert isinstance(dispatch.get_engine("mock://critic"), MockEngine)

    def test_one_replica_fleet_never_routes(self):
        from adversarial_spec_tpu_torch.engine import dispatch
        from adversarial_spec_tpu_torch.engine.mock import MockEngine

        fleet_mod.configure(enabled=True, replicas=1)
        assert isinstance(dispatch.get_engine("mock://critic"), MockEngine)

    def test_topology_change_rebuilds_the_fleet(self):
        fleet_mod.configure(enabled=True, replicas=2, transport="inproc")
        first = fleet_mod.fleet_engine()
        fleet_mod.configure(replicas=3)
        second = fleet_mod.fleet_engine()
        assert second is not first
        assert first.router.alive_ids() == []  # old fleet shut down
        assert len(second.router.alive_ids()) == 3

    def test_validate_routes_to_a_replica(self):
        fleet_mod.configure(enabled=True, replicas=2)
        eng = fleet_mod.fleet_engine()
        assert eng.validate("mock://critic") is None
        assert eng.validate("nonsense") is not None


class TestRunRoundFleet:
    def test_round_routes_and_resolves(self):
        from adversarial_spec_tpu_torch.debate.core import RoundConfig, run_round

        fleet_mod.configure(enabled=True, replicas=2)
        cfg = RoundConfig(debate_id="fleet-round")
        r = run_round(
            "# spec", ["mock://critic?v=1", "mock://agree"], 1, cfg
        )
        assert all(resp.ok for resp in r.responses)
        assert fleet_mod.stats.routed_requests == 2
        assert fleet_mod.stats.completed_requests == 2

    def test_rounds_of_one_debate_share_a_replica(self):
        from adversarial_spec_tpu_torch.debate.core import RoundConfig, run_round

        fleet_mod.configure(enabled=True, replicas=3)
        cfg = RoundConfig(debate_id="fleet-affinity")
        for round_num in (1, 2):
            run_round(
                "# spec", ["mock://critic?v=1", "mock://critic?v=2"],
                round_num, cfg,
            )
        eng = fleet_mod.fleet_engine()
        used = [s for s in eng.router.replica_stats() if s["served"]]
        assert len(used) == 1
        assert sum(used[0]["served"].values()) == 4

    def test_sessionless_round_keys_on_the_spec(self):
        from adversarial_spec_tpu_torch.debate.core import RoundConfig, run_round

        obs_mod.reset_stats()
        fleet_mod.configure(enabled=True, replicas=2)
        run_round("# spec", ["mock://critic"], 1, RoundConfig())
        routes = [
            e for e in obs_mod.recorder.events() if e["type"] == "route"
        ]
        from adversarial_spec_tpu_torch.debate.journal import spec_sha

        assert routes[0]["key"] == spec_sha("# spec")[:16]

    def test_streaming_early_cancel_survives_the_replica_hop(self):
        from adversarial_spec_tpu_torch.debate.core import RoundConfig, run_round
        from adversarial_spec_tpu_torch.engine import streaming

        fleet_mod.configure(enabled=True, replicas=2)
        r = run_round(
            "# spec", ["mock://agree?agree_tail=50"], 1,
            RoundConfig(debate_id="fleet-cancel"),
        )
        assert r.responses[0].ok and r.responses[0].agreed
        # The consumer crossed the router with its indexing intact and
        # cancelled mid-reply (the in-process transport streams).
        assert streaming.stats.cancels == 1


class TestFleetEvents:
    def test_replica_and_route_events_validate(self):
        from adversarial_spec_tpu_torch.obs.events import (
            ReplicaEvent,
            RouteEvent,
            event_to_dict,
            validate_event,
        )

        good_rep = event_to_dict(
            1, ReplicaEvent(replica="r0", op="retire", reason="dead", alive=1)
        )
        assert validate_event(json.loads(json.dumps(good_rep))) == []
        good_route = event_to_dict(
            2,
            RouteEvent(
                replica="r1", req_id=0, key="k", model="m", hop=1,
                reason="failover",
            ),
        )
        assert validate_event(json.loads(json.dumps(good_route))) == []
        assert validate_event(
            event_to_dict(3, ReplicaEvent(op="vanish"))
        )
        assert validate_event(
            event_to_dict(4, RouteEvent(reason="luck"))
        )


class TestToolsRendering:
    def _events(self):
        from adversarial_spec_tpu_torch.obs.events import (
            ReplicaEvent,
            RouteEvent,
            SpanEvent,
            StepEvent,
            event_to_dict,
        )

        return [
            event_to_dict(1, ReplicaEvent(replica="r0", op="spawn", alive=1)),
            event_to_dict(
                2,
                RouteEvent(
                    replica="r0", req_id=0, key="debate-A", model="m",
                    trace_id="tr-001-01", span_id="tr-001-01/s00",
                ),
            ),
            event_to_dict(3, StepEvent(kind="decode", n_live=1)),
            event_to_dict(
                4,
                RouteEvent(
                    replica="r1", req_id=0, key="debate-A", model="m",
                    hop=1, reason="failover",
                    trace_id="tr-001-01", span_id="tr-001-01/s00",
                ),
            ),
            event_to_dict(
                5,
                ReplicaEvent(
                    replica="r0", op="retire", reason="dead", alive=1
                ),
            ),
            event_to_dict(6, StepEvent(kind="decode", n_live=1)),
            event_to_dict(
                7,
                SpanEvent(
                    name="request", phase="begin", req_id=0,
                    trace_id="tr-001-01", span_id="tr-001-01/s00",
                ),
            ),
            event_to_dict(
                8,
                SpanEvent(
                    name="prefill", phase="end", req_id=0, wall_s=0.25,
                    trace_id="tr-001-01", span_id="tr-001-01/s00",
                ),
            ),
            event_to_dict(
                9,
                SpanEvent(
                    name="decode", phase="end", req_id=0, wall_s=0.75,
                    trace_id="tr-001-01", span_id="tr-001-01/s00",
                ),
            ),
            event_to_dict(
                10,
                SpanEvent(
                    name="request", phase="end", req_id=0, wall_s=1.0,
                    trace_id="tr-001-01", span_id="tr-001-01/s00",
                ),
            ),
        ]

    def _write(self, tmp_path, events):
        p = tmp_path / "ev.jsonl"
        p.write_text(
            "".join(json.dumps(e) + "\n" for e in events), encoding="utf-8"
        )
        return str(p)

    def test_obs_dump_renders_replica_column_and_validates(
        self, tmp_path, capsys
    ):
        from tools.obs_dump import main

        path = self._write(tmp_path, self._events())
        assert main([path, "--timeline"]) == 0
        out = capsys.readouterr().out
        assert "route>r0" in out and "route>r1" in out
        assert "replica:retire" in out
        assert "rep=r0" in out and "rep=r1" in out  # the replica column
        assert "failover hop(s)" in out
        assert "WARNING: replica r0 retire" in out

    def test_trace_view_shows_the_failover_hop(self, tmp_path, capsys):
        from tools.trace_view import main

        path = self._write(tmp_path, self._events())
        assert main([path]) == 0
        out = capsys.readouterr().out
        assert "via r0 -> r1 (failover)" in out

    def test_port_events_encode_as_the_reference(self):
        """The rendered events are the port's; the reference's classes
        encode the same fields to the same dicts, so its tools read the
        port's flight recorder as their own."""
        from adversarial_spec_tpu import obs as ref_obs
        from adversarial_spec_tpu.obs.events import event_to_dict as ref_e2d
        from adversarial_spec_tpu.obs.events import validate_event as ref_validate

        port = self._events()
        for e in port:
            assert ref_validate(e) == [], e
        ref = [
            ref_e2d(1, ref_obs.ReplicaEvent(replica="r0", op="spawn", alive=1)),
            ref_e2d(2, ref_obs.RouteEvent(
                replica="r0", req_id=0, key="debate-A", model="m",
                trace_id="tr-001-01", span_id="tr-001-01/s00",
            )),
        ]
        assert port[:2] == ref

    def test_fleet_snapshot_schema_matches_reference(self):
        """``perf.fleet`` carries the reference's keys, defaults and
        derived rates; dropping a counter is a schema break."""
        from adversarial_spec_tpu import fleet as ref_fleet

        for mod in (fleet_mod, ref_fleet):
            mod.reset_stats()
            mod.stats.routed_requests += 4
            mod.stats.affinity_hits += 3
            mod.stats.handoff_attempts += 2
            mod.stats.handoff_adopted += 1
        port, ref = fleet_mod.snapshot(), ref_fleet.snapshot()
        ref_fleet.reset_stats()
        assert port == ref
        assert port["affinity_hit_rate"] == 0.75
        assert port["handoff_hit_rate"] == 0.5


class TestFleetLifecycleLint:
    def test_exit_skipping_the_retirement_surgery_fires(self):
        """GL-LIFECYCLE's fleet machine is LIVE on the real source: a
        hand-rolled shutdown that skips _retire_replica (writing the
        dead-ledger directly) is permanently caught."""
        from pathlib import Path

        from tools.graftlint.config import GraftlintConfig
        from tools.graftlint.core import lint_sources

        src = Path("adversarial_spec_tpu_torch/fleet/router.py").read_text(
            encoding="utf-8"
        )
        broken = src.replace(
            "    def shutdown(self) -> None:\n"
            "        for rid in self.alive_ids():\n"
            "            self._retire_replica(rid, \"shutdown\")\n",
            "    def shutdown(self) -> None:\n"
            "        for rid in self.alive_ids():\n"
            "            self._dead[rid] = \"shutdown\"\n",
        )
        assert broken != src, "shutdown surgery call not found to strip"
        cfg = GraftlintConfig(package="pkg")
        findings = lint_sources(
            {"pkg/router.py": broken}, rules=["GL-LIFECYCLE"], cfg=cfg
        )
        msgs = [f.message for f in findings]
        assert any(
            "FleetRouter.shutdown never reaches" in m for m in msgs
        ), msgs
        assert any("self._dead" in m and "shutdown" in m for m in msgs)
        # The committed source is clean under the same config.
        assert (
            lint_sources(
                {"pkg/router.py": src}, rules=["GL-LIFECYCLE"], cfg=cfg
            )
            == []
        )


class TestHandoffLifecycleLint:
    def test_exit_skipping_the_publication_surgery_fires(self):
        """GL-LIFECYCLE's handoff machine is LIVE on the real source: a
        hand-rolled degrade that skips _publish_blocks (writing the
        terminal-outcome ledger directly) is permanently caught."""
        from pathlib import Path

        from tools.graftlint.config import GraftlintConfig
        from tools.graftlint.core import lint_sources

        src = Path("adversarial_spec_tpu_torch/fleet/handoff.py").read_text(
            encoding="utf-8"
        )
        broken = src.replace(
            "        return self._publish_blocks(key, DEGRADED, reason)\n",
            "        self._outcomes[key] = DEGRADED\n"
            "        return None\n",
        )
        assert broken != src, "_degrade surgery call not found to strip"
        cfg = GraftlintConfig(package="pkg")
        findings = lint_sources(
            {"pkg/handoff.py": broken}, rules=["GL-LIFECYCLE"], cfg=cfg
        )
        msgs = [f.message for f in findings]
        assert any(
            "HandoffLedger._degrade never reaches" in m for m in msgs
        ), msgs
        assert any("self._outcomes" in m and "_degrade" in m for m in msgs)
        # The committed source is clean under the same config.
        assert (
            lint_sources(
                {"pkg/handoff.py": src}, rules=["GL-LIFECYCLE"], cfg=cfg
            )
            == []
        )


class TestCliFleet:
    def _run(self, argv, monkeypatch, capsys, stdin="# spec\nBody.\n"):
        import io

        from adversarial_spec_tpu_torch import cli

        monkeypatch.setattr("sys.stdin", io.StringIO(stdin))
        code = cli.main(argv)
        out, err = capsys.readouterr()
        return code, out, err

    def test_fleet_flags_reach_perf_json(self, monkeypatch, capsys):
        code, out, err = self._run(
            [
                "critique", "--models", "mock://critic,mock://agree",
                "--fleet", "--fleet-replicas", "3", "--json",
            ],
            monkeypatch, capsys,
        )
        assert code == 0
        perf = json.loads(out)["perf"]["fleet"]
        assert perf["enabled"] is True
        assert perf["replicas"] == 3
        assert perf["routed_requests"] == 2
        assert perf["completed_requests"] == 2
        assert "fleet: 2 request(s) routed" in err

    def test_fleet_does_not_leak_across_invocations(self, monkeypatch, capsys):
        self._run(
            [
                "critique", "--models", "mock://critic",
                "--fleet", "--fleet-replicas", "2", "--json",
            ],
            monkeypatch, capsys,
        )
        code, out, _ = self._run(
            ["critique", "--models", "mock://critic", "--json"],
            monkeypatch, capsys,
        )
        assert code == 0
        perf = json.loads(out)["perf"]["fleet"]
        assert perf["enabled"] is False  # env default (off) re-resolved
        assert perf["routed_requests"] == 0


class TestHashRingRoles:
    """Role-tagged ring pins (fleet disaggregation, docs/fleet.md)."""

    def test_role_filter_skips_foreign_roles(self):
        ring = HashRing()
        ring.add("p0", role="prefill")
        ring.add("d0", role="decode")
        ring.add("d1", role="decode")
        for key in (f"debate-{i}" for i in range(32)):
            assert ring.preference(key, role="prefill") == ["p0"]
            dec = ring.preference(key, role="decode")
            assert sorted(dec) == ["d0", "d1"]
            assert ring.primary(key, role="decode") == dec[0]
        assert ring.role_of("p0") == "prefill"
        assert ring.role_nodes("decode") == {"d0", "d1"}

    def test_untagged_nodes_serve_every_role(self):
        ring = HashRing(["r0", "r1"])  # symmetric fleet: no tags
        assert ring.role_nodes("prefill") == {"r0", "r1"}
        assert ring.role_nodes("decode") == {"r0", "r1"}
        for key in ("a", "b", "c"):
            assert ring.primary(key, role="decode") == ring.primary(key)

    def test_empty_role_pool_routes_nowhere(self):
        ring = HashRing()
        ring.add("d0", role="decode")
        assert ring.preference("k", role="prefill") == []
        assert ring.primary("k", role="prefill") is None

    def test_role_pool_membership_change_scoped_to_the_pool(self):
        """The per-pool consistent-hashing contract: a node joining
        the decode pool moves ~1/N of DECODE keys (all to the
        newcomer) and zero prefill keys; the foreign pool never even
        observes the change."""
        ring = HashRing()
        ring.add("p0", role="prefill")
        ring.add("p1", role="prefill")
        for k in range(3):
            ring.add(f"d{k}", role="decode")
        keys = [f"debate-{i}" for i in range(2000)]
        dec_before = {k: ring.primary(k, role="decode") for k in keys}
        pre_before = {k: ring.primary(k, role="prefill") for k in keys}
        ring.add("d3", role="decode")
        moved = [
            k for k in keys if ring.primary(k, role="decode") != dec_before[k]
        ]
        frac = len(moved) / len(keys)
        assert 0.5 / 4 <= frac <= 2.0 / 4, frac
        assert all(
            ring.primary(k, role="decode") == "d3" for k in moved
        )
        assert all(
            ring.primary(k, role="prefill") == pre_before[k] for k in keys
        )


class TestHandoffLedger:
    """The handoff lifecycle machine in isolation (fleet/handoff.py)."""

    def _ledger(self):
        from adversarial_spec_tpu_torch.fleet.handoff import HandoffLedger

        fleet_mod.reset_stats()
        return HandoffLedger(stats=fleet_mod.stats)

    def test_adopt_walks_the_full_lifecycle(self):
        from adversarial_spec_tpu_torch.fleet import handoff as h

        led = self._ledger()
        rec = led.begin("debate-A", "r0", "r1")
        assert rec.state == h.PLANNED
        assert led.seen("debate-A") and not led.seen("debate-B")
        led.note_prefilling("debate-A")
        assert led.active("debate-A").state == h.PREFILLING
        led.note_published("debate-A", ["c1", "c2"], blocks=2)
        assert led.active("debate-A").state == h.PUBLISHED
        out = led._finish_adopt("debate-A")
        assert out is not None and out.state == h.ADOPTED
        assert led.active("debate-A") is None
        assert led.outcome("debate-A") == h.ADOPTED
        assert led.seen("debate-A")  # decided keys never re-handoff
        assert fleet_mod.stats.handoff_attempts == 1
        assert fleet_mod.stats.handoff_adopted == 1
        assert fleet_mod.stats.handoff_shipped_blocks == 2

    def test_surgery_is_idempotent_first_decision_stands(self):
        led = self._ledger()
        led.begin("k", "r0", "r1")
        assert led._degrade("k", "store_miss") is not None
        # A second exit for the same key is a no-op: no double count.
        assert led._finish_adopt("k") is None
        assert led._degrade("k", "again") is None
        assert led.outcome("k") == "degraded"
        assert fleet_mod.stats.handoff_degraded == 1
        assert fleet_mod.stats.handoff_adopted == 0

    def test_abandon_counts_separately(self):
        led = self._ledger()
        led.begin("k", "r0", "r1")
        led._abandon("k", "no_blocks")
        assert led.outcome("k") == "abandoned"
        assert fleet_mod.stats.handoff_abandoned == 1
        assert led.snapshot() == {
            "active": 0, "adopted": 0, "degraded": 0, "abandoned": 1,
        }


class TestDisaggRouting:
    """Prefill/decode disaggregation on in-process replicas: the
    adopted fast path, every degradation, and the byte-identity
    contract against a symmetric fleet."""

    DOC = (
        "## Goals\nShip the spec.\n## Constraints\n"
        + "The decode replica SHALL NOT re-prefill shipped blocks. " * 40
    )

    def _arm_tier(self, tmp_path):
        from adversarial_spec_tpu_torch.engine import kvtier

        kvtier.configure(
            enabled=True, host_mb=64, store_dir=str(tmp_path / "store")
        )

    def _reqs(self, n=2, key="debate-dis", doc=None):
        doc = self.DOC if doc is None else doc
        return [
            _req(
                model=f"mock://critic?v={k}",
                key=key,
                user=doc + f"\nOpponent {k}.",
            )
            for k in range(n)
        ]

    def _texts(self, engine, reqs):
        params = SamplingParams(max_new_tokens=32, greedy=True)
        outs = engine.chat(reqs, params)
        assert all(o.ok for o in outs), [o.error for o in outs]
        return [o.text for o in outs]

    def test_adopted_handoff_is_byte_identical(self, tmp_path):
        self._arm_tier(tmp_path)
        fleet_mod.reset_stats()
        sym = FleetEngine(replicas=2, transport="inproc")
        ref = self._texts(sym, self._reqs())
        sym.shutdown()
        fleet_mod.reset_stats()
        eng = FleetEngine(replicas=2, transport="inproc", prefill_replicas=1)
        try:
            assert eng.disagg_armed()
            assert eng.router.alive_ids("prefill") == ["r0"]
            assert eng.router.alive_ids("decode") == ["r1"]
            got = self._texts(eng, self._reqs())
            assert got == ref  # byte-identical across topologies
            assert fleet_mod.stats.handoff_attempts == 1
            assert fleet_mod.stats.handoff_adopted == 1
            assert fleet_mod.stats.handoff_shipped_blocks > 0
            assert eng.handoff.outcome("debate-dis") == "adopted"
        finally:
            eng.shutdown()

    def test_small_admissions_never_handoff(self, tmp_path):
        self._arm_tier(tmp_path)
        fleet_mod.reset_stats()
        eng = FleetEngine(replicas=2, transport="inproc", prefill_replicas=1)
        try:
            self._texts(eng, self._reqs(doc="Tiny spec."))
            assert fleet_mod.stats.handoff_attempts == 0
        finally:
            eng.shutdown()

    def test_later_rounds_ride_the_first_handoff(self, tmp_path):
        self._arm_tier(tmp_path)
        fleet_mod.reset_stats()
        eng = FleetEngine(replicas=2, transport="inproc", prefill_replicas=1)
        try:
            self._texts(eng, self._reqs())
            self._texts(eng, self._reqs())  # round 2, same debate key
            assert fleet_mod.stats.handoff_attempts == 1  # no re-handoff
        finally:
            eng.shutdown()

    def test_prefill_error_degrades_byte_identical(
        self, tmp_path, monkeypatch
    ):
        self._arm_tier(tmp_path)
        fleet_mod.reset_stats()
        sym = FleetEngine(replicas=2, transport="inproc")
        ref = self._texts(sym, self._reqs())
        sym.shutdown()
        fleet_mod.reset_stats()
        eng = FleetEngine(replicas=2, transport="inproc", prefill_replicas=1)
        try:
            def boom(requests, params):
                raise RuntimeError("prefill replica exploded")

            monkeypatch.setattr(eng.router.replica("r0"), "prefill", boom)
            got = self._texts(eng, self._reqs())
            assert got == ref  # local prefill on the decode side
            assert fleet_mod.stats.handoff_degraded == 1
            assert fleet_mod.stats.handoff_adopted == 0
        finally:
            eng.shutdown()

    def test_no_store_abandons_but_still_serves(self, tmp_path):
        from adversarial_spec_tpu_torch.engine import kvtier

        # Tier 2 unset: the prefill side has nowhere durable to ship.
        kvtier.configure(enabled=True, host_mb=64, store_dir="")
        fleet_mod.reset_stats()
        eng = FleetEngine(replicas=2, transport="inproc", prefill_replicas=1)
        try:
            self._texts(eng, self._reqs())
            assert fleet_mod.stats.handoff_attempts == 1
            assert fleet_mod.stats.handoff_abandoned == 1
        finally:
            eng.shutdown()

    def test_symmetric_fleet_never_plans_handoffs(self, tmp_path):
        self._arm_tier(tmp_path)
        fleet_mod.reset_stats()
        eng = FleetEngine(replicas=2, transport="inproc")
        try:
            assert not eng.disagg_armed()
            self._texts(eng, self._reqs())
            assert fleet_mod.stats.handoff_attempts == 0
        finally:
            eng.shutdown()


class TestHandoffLedgerParity:
    def test_handoff_ledger_matches_reference(self):
        """The same lifecycle walks through both packages' ledgers leave
        the same snapshots, outcomes and fleet counters."""
        from adversarial_spec_tpu import fleet as ref_fleet
        from adversarial_spec_tpu.fleet.handoff import HandoffLedger as RefLedger
        from adversarial_spec_tpu_torch.fleet.handoff import HandoffLedger

        out = []
        for mod, cls in ((ref_fleet, RefLedger), (fleet_mod, HandoffLedger)):
            mod.reset_stats()
            led = cls(stats=mod.stats)
            led.begin("a", "r0", "r1")
            led.note_prefilling("a")
            led.note_published("a", ["c1", "c2", "c3"], blocks=3)
            led._finish_adopt("a")
            led.begin("b", "r0", "r1")
            led.note_prefilling("b")
            led._degrade("b", "prefill_error")
            led.begin("c", "r0", "r1")
            led._abandon("c", "no_blocks")
            led.begin("d", "r0", "r1")
            out.append((
                led.snapshot(),
                [led.outcome(k) for k in "abcd"],
                mod.snapshot(),
            ))
        ref_fleet.reset_stats()
        assert out[1] == out[0]
        assert out[1][1] == ["adopted", "degraded", "abandoned", None]
