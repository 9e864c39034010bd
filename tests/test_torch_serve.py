"""The port's ``serve`` daemon (``adversarial_spec_tpu_torch/serve``)
held to the reference's serve tests, then against the reference's daemon.

Every test of ``tests/test_serve.py`` runs here on the port's ``serve/``
and its mock engine: the protocol schema, the scheduler state machine
driven synchronously (admission, fair share, brownout, quota,
preemption, drain, shutdown safety), trace scopes and breakers, the gate
+ pump + reentrant round driver with real threads, the asyncio daemon
over a real unix socket, and the CLI's ``serve`` flags. The reference's
tooling tests read ``tools/`` modules that import the JAX package; here
the port's events are held to the same schema through the port's own
``obs/events.py`` and against the reference's event encoding.

Then, against the reference: one scripted socket conversation (two
tenants, streamed ``mock://`` debates, a shed, a preemption and a drain)
gives equal event sequences from both daemons once clock fields and ids
are masked; a ``tpu://random-tiny`` debate through the port's daemon on
a CPU ``GpuEngine`` holding the reference's weights gives the reference
daemon's results byte for byte; and the port's daemon runs its mock
lifecycle in a subprocess with jax blocked. Every socket and thread wait
has its own bound.
"""

from __future__ import annotations

import asyncio
import json
import threading
import time

import pytest

from tests import torch_cli_support as sup

from adversarial_spec_tpu import obs as ref_obs
from adversarial_spec_tpu.obs.events import event_to_dict as ref_event_to_dict
from adversarial_spec_tpu.obs.events import validate_event as ref_validate_event
from adversarial_spec_tpu_torch import obs as obs_mod
from adversarial_spec_tpu_torch import serve as serve_mod
from adversarial_spec_tpu_torch.debate.journal import RoundJournal
from adversarial_spec_tpu_torch.engine import spec as spec_mod
from adversarial_spec_tpu_torch.engine.mock import MockEngine
from adversarial_spec_tpu_torch.engine.types import ChatRequest, Completion, SamplingParams
from adversarial_spec_tpu_torch.obs.events import SERVE_OPS, SERVE_TIERS, validate_event
from adversarial_spec_tpu_torch.resilience import breaker as breaker_mod
from adversarial_spec_tpu_torch.serve import gate, protocol
from adversarial_spec_tpu_torch.serve.client import ServeClient
from adversarial_spec_tpu_torch.serve.daemon import ServeDaemon
from adversarial_spec_tpu_torch.serve.driver import run_debate
from adversarial_spec_tpu_torch.serve.gate import EnginePump, Submission
from adversarial_spec_tpu_torch.serve.sched import (
    ServeScheduler,
    Unit,
    estimate_tokens,
)

SPEC = (
    "## Goals\nServe heavy traffic from millions of users, fast.\n"
    "## Constraints\n" + "The daemon SHALL shed, not collapse. " * 12
)


@pytest.fixture(autouse=True)
def _port_state(tmp_path, monkeypatch):
    yield from sup.isolate_port(tmp_path, monkeypatch)


def _unit(
    tenant="t0",
    tier="interactive",
    debate="d1",
    index=0,
    engine=None,
    model="mock://critic",
    max_new=128,
    consumer=None,
    on_stream=None,
    submission=None,
):
    req = ChatRequest(
        model=model, system="sys", user=f"Debate round 1\n{SPEC}"
    )
    return Unit(
        debate=debate,
        tenant=tenant,
        tier=tier,
        index=index,
        request=req,
        params=SamplingParams(max_new_tokens=max_new, greedy=True),
        engine=engine,
        consumer=consumer,
        on_stream=on_stream,
        submission=submission,
    )


def _completion(tokens_in=100, tokens_out=50, cached=0):
    from adversarial_spec_tpu_torch.debate.usage import Usage

    return Completion(
        text="x" * (tokens_out * 4),
        usage=Usage(
            input_tokens=tokens_in,
            output_tokens=tokens_out,
            cached_tokens=cached,
        ),
    )


class TestProtocol:
    def test_self_check_clean(self):
        assert protocol.self_check() == []

    def test_tiers_match_obs_vocabulary(self):
        # One drift axis less: the wire tier names ARE the event tier
        # names obs_dump validates against.
        assert tuple(protocol.TIERS) == tuple(SERVE_TIERS)

    def test_shed_reasons_are_closed_vocabulary(self):
        for reason in protocol.SHED_REASONS:
            ev = protocol.shed_event("r1", reason, 1.5, "why")
            assert ev["event"] == "shed" and ev["retry_after_s"] == 1.5

    def test_validate_request_fires(self):
        good = {
            "op": "debate",
            "id": "c1",
            "tenant": "t0",
            "spec": SPEC,
            "models": ["mock://agree"],
        }
        assert protocol.validate_request(good) == []
        assert protocol.validate_request({**good, "op": "zap"})
        assert protocol.validate_request({**good, "tier": "bulk"})
        assert protocol.validate_request({**good, "models": []})
        assert protocol.validate_request({**good, "round": "one"})
        assert protocol.validate_request({**good, "mystery": 1})
        missing_id = {k: v for k, v in good.items() if k != "id"}
        assert protocol.validate_request(missing_id)

    def test_decode_tolerates_garbage(self):
        assert protocol.decode(b"not json\n") is None
        assert protocol.decode(b"[1,2]\n") is None
        assert protocol.decode(b"") is None
        assert protocol.decode(protocol.encode({"op": "ping", "id": "x"}))


class TestServeEventSchema:
    def test_good_event_validates(self):
        ev = obs_mod.ServeEvent(op="shed", tenant="t0", tier="batch",
                                debate="d1", reason="backlog", tokens=10)
        from adversarial_spec_tpu_torch.obs.events import event_to_dict

        assert validate_event(event_to_dict(1, ev)) == []

    def test_unknown_op_and_tier_fire(self):
        from adversarial_spec_tpu_torch.obs.events import event_to_dict

        good = event_to_dict(1, obs_mod.ServeEvent())
        assert validate_event({**good, "op": "vanish"})
        assert validate_event({**good, "tier": "bulk"})

    def test_op_vocabulary_covers_lifecycle(self):
        # The daemon request lifecycle (docs/serving.md) is exactly the
        # event vocabulary: every exit the GL-LIFECYCLE machine guards
        # has an op, plus the brownout transitions.
        for op in (
            "accepted", "queued", "running", "finished", "shed",
            "preempted", "drained", "brownout_enter", "brownout_exit",
        ):
            assert op in SERVE_OPS


class TestAdmission:
    def test_queue_depth_cap_typed_shed(self):
        serve_mod.configure(max_queue_depth=2, max_backlog_tokens=10**9)
        sched = ServeScheduler()
        assert sched.try_admit("t0", "interactive", "d1", 100) is None
        assert sched.try_admit("t0", "interactive", "d2", 100) is None
        shed = sched.try_admit("t0", "interactive", "d3", 100)
        assert shed is not None and shed.reason == "queue_full"
        assert shed.retry_after_s >= 0.0
        # Another tenant is unaffected: the cap is per tenant.
        assert sched.try_admit("t1", "interactive", "d4", 100) is None
        # Completion frees the slot.
        sched.finish_debate("d1")
        assert sched.try_admit("t0", "interactive", "d5", 100) is None

    def test_backlog_cap_typed_shed_with_retry_after(self):
        serve_mod.configure(max_queue_depth=100, max_backlog_tokens=1000)
        sched = ServeScheduler()
        assert sched.try_admit("t0", "interactive", "d1", 700) is None
        shed = sched.try_admit("t1", "interactive", "d2", 700)
        assert shed is not None and shed.reason == "backlog"
        assert shed.retry_after_s > 0.0

    def test_draining_shed(self):
        sched = ServeScheduler()
        sched.begin_drain()
        shed = sched.try_admit("t0", "interactive", "d1", 10)
        assert shed is not None and shed.reason == "draining"

    def test_accounting_ledger(self):
        serve_mod.configure(max_queue_depth=2, max_backlog_tokens=1000)
        sched = ServeScheduler()
        sched.try_admit("t0", "interactive", "d1", 700)
        assert sched.try_admit("t1", "interactive", "d2", 700).reason == (
            "backlog"
        )
        snap = serve_mod.snapshot()
        assert snap["accepted_debates"] == 1
        assert snap["shed_debates"] == 1
        assert snap["shed_fraction"] == 0.5


class TestFairShare:
    def _drain_order(self, sched, n):
        """Pop n units one at a time, charging each before the next
        pick — the stride scheduler's feedback loop, synchronously."""
        order = []
        for _ in range(n):
            batch = sched.next_batch(timeout=0.01)
            assert len(batch) == 1
            u = batch[0]
            order.append(u.tenant)
            # Heavy tenant pays 10x per completion.
            cost = 1000 if u.tenant == "heavy" else 100
            sched.on_dispatch_complete([u], [_completion(cost, 0)])
        return order

    def test_stride_interleave_by_token_cost(self):
        serve_mod.configure(max_dispatch_batch=1)
        sched = ServeScheduler()
        sched.try_admit("heavy", "interactive", "dh", 10000)
        sched.try_admit("light", "interactive", "dl", 10000)
        sched.submit_units(
            [_unit(tenant="heavy", debate="dh", index=i) for i in range(3)]
        )
        sched.submit_units(
            [_unit(tenant="light", debate="dl", index=i) for i in range(8)]
        )
        order = self._drain_order(sched, 11)
        # After one heavy completion (1000 tokens) the light tenant
        # (100/completion) must be served MANY times before heavy runs
        # again: passes advance by actual tokens paid.
        first_heavy = order.index("heavy")
        second_heavy = order.index("heavy", first_heavy + 1)
        assert second_heavy - first_heavy >= 5, order

    def test_interactive_strictly_before_batch(self):
        serve_mod.configure(max_dispatch_batch=1)
        sched = ServeScheduler()
        sched.submit_units([_unit(tier="batch", debate="db", index=0)])
        sched.submit_units([_unit(tier="interactive", debate="di", index=0)])
        batch = sched.next_batch(timeout=0.01)
        assert batch[0].tier == "interactive"

    def test_same_model_units_coalesce_into_one_dispatch(self):
        serve_mod.configure(max_dispatch_batch=4)
        eng = object()
        sched = ServeScheduler()
        sched.submit_units(
            [_unit(debate="d1", index=i, engine=eng) for i in range(3)]
        )
        batch = sched.next_batch(timeout=0.01)
        assert len(batch) == 3  # N rows of one batched decode
        sched.on_dispatch_complete(batch, [_completion()] * 3)

    def test_queue_wait_and_events_emitted(self):
        sched = ServeScheduler()
        u = _unit()
        sched.submit_units([u])
        batch = sched.next_batch(timeout=0.01)
        sched.on_dispatch_complete(batch, [_completion()])
        types = [
            e["op"]
            for e in obs_mod.recorder.events()
            if e["type"] == "serve"
        ]
        assert types[-3:] == ["queued", "running", "finished"]
        for e in obs_mod.recorder.events():
            assert validate_event(e) == [], e


class TestBrownout:
    def test_enter_lowers_gamma_exit_restores(self):
        serve_mod.configure(
            max_queue_depth=100,
            max_backlog_tokens=1000,
            brownout_gamma=2,
        )
        prev_gamma = spec_mod.config().gamma
        try:
            sched = ServeScheduler()
            assert sched.try_admit("t0", "interactive", "d1", 800) is None
            assert sched.brownout  # 800 >= 0.75 * 1000
            assert spec_mod.config().gamma == 2
            # Batch admissions pause, typed; interactive still fits.
            shed = sched.try_admit("t0", "batch", "d2", 10)
            assert shed is not None and shed.reason == "brownout"
            assert sched.try_admit("t1", "interactive", "d3", 100) is None
            # Draining the backlog below the exit fraction restores γ.
            sched.finish_debate("d1")
            assert not sched.brownout
            assert spec_mod.config().gamma == prev_gamma
            snap = serve_mod.snapshot()
            assert snap["brownout_entries"] == 1
            assert snap["brownout_exits"] == 1
        finally:
            spec_mod.configure(gamma=prev_gamma)

    def test_brownout_events_in_recorder(self):
        serve_mod.configure(max_queue_depth=100, max_backlog_tokens=1000)
        prev_gamma = spec_mod.config().gamma
        try:
            sched = ServeScheduler()
            sched.try_admit("t0", "interactive", "d1", 900)
            sched.finish_debate("d1")
        finally:
            spec_mod.configure(gamma=prev_gamma)
        ops = [
            e["op"]
            for e in obs_mod.recorder.events()
            if e["type"] == "serve"
        ]
        assert "brownout_enter" in ops and "brownout_exit" in ops


class TestQuota:
    """Quota accounting edge cases."""

    def test_admission_shed_when_exhausted(self):
        serve_mod.configure(tenant_quota_tokens=100)
        sched = ServeScheduler()
        assert sched.try_admit("t0", "interactive", "d1", 10) is None
        u = _unit(debate="d1")
        sched.submit_units([u])
        batch = sched.next_batch(timeout=0.01)
        sched.on_dispatch_complete(batch, [_completion(200, 100)])
        shed = sched.try_admit("t0", "interactive", "d2", 10)
        assert shed is not None and shed.reason == "quota"
        # Another tenant's quota is its own.
        assert sched.try_admit("t1", "interactive", "d3", 10) is None

    def test_quota_exhausted_mid_round_sheds_remaining_units(self):
        """Quota dies between opponent 1 and opponents 2-3: the
        remaining units shed with a TYPED error completion (no retry
        ladder — transient=False) and the round still resolves."""
        serve_mod.configure(tenant_quota_tokens=250, max_dispatch_batch=1)
        sched = ServeScheduler()
        sched.try_admit("t0", "interactive", "d1", 10)
        units = [_unit(debate="d1", index=i) for i in range(3)]
        sched.submit_units(units)
        first = sched.next_batch(timeout=0.01)
        sched.on_dispatch_complete(first, [_completion(200, 100)])  # 300 paid
        # Quota now negative: the next two picks shed at dispatch.
        assert sched.next_batch(timeout=0.01) == []
        for u in units[1:]:
            assert u.done.is_set()
            assert not u.completion.ok
            assert u.completion.error.startswith("shed (quota)")
            assert u.completion.transient is False
            assert u.state == "shed"
        assert units[0].completion.ok
        snap = serve_mod.snapshot()
        assert snap["units_shed"] == 2

    def test_refill_race_with_queued_admission(self):
        """A unit queued while quota is exhausted dispatches the moment
        a refill lands — the refill is not lost to the queue."""
        serve_mod.configure(tenant_quota_tokens=100, max_dispatch_batch=1)
        sched = ServeScheduler()
        sched.try_admit("t0", "interactive", "d1", 10)
        u1, u2 = _unit(debate="d1", index=0), _unit(debate="d1", index=1)
        sched.submit_units([u1])
        sched.on_dispatch_complete(
            sched.next_batch(timeout=0.01), [_completion(200, 100)]
        )
        sched.submit_units([u2])  # queued with quota exhausted
        assert sched.refill_quota("t0", 1000) > 0
        batch = sched.next_batch(timeout=0.01)
        assert batch == [u2]  # dispatched, not shed
        sched.on_dispatch_complete(batch, [_completion()])
        assert u2.completion.ok

    def test_quota_error_classifies_as_shed_not_model_fault(self):
        from adversarial_spec_tpu_torch.resilience.faults import (
            FaultKind,
            classify_message,
        )

        assert (
            classify_message("shed (quota): tenant 't0' token quota "
                             "exhausted")
            is FaultKind.SHED
        )
        assert (
            classify_message("drained: daemon shutting down")
            is FaultKind.SHED
        )
        assert FaultKind.SHED.transient is False

    def test_shed_does_not_trip_breaker(self):
        """A policy shed must not open the model's circuit: a drain
        storm counting as failures would ban every opponent (found by
        the SIGTERM drain drill)."""
        from adversarial_spec_tpu_torch.debate.core import RoundConfig, run_round

        breakers = breaker_mod.BreakerRegistry(threshold=1)

        class ShedEngine:
            def validate(self, model):
                return None

            def chat(self, requests, params):
                return [
                    Completion(
                        error="shed (quota): tenant quota exhausted",
                        transient=False,
                    )
                    for _ in requests
                ]

        from adversarial_spec_tpu_torch.engine import dispatch

        eng = ShedEngine()
        old = dict(dispatch._ENGINE_CACHE)
        dispatch._ENGINE_CACHE["mock"] = eng
        try:
            result = run_round(
                SPEC,
                ["mock://critic"],
                cfg=RoundConfig(breakers=breakers),
            )
        finally:
            dispatch._ENGINE_CACHE.clear()
            dispatch._ENGINE_CACHE.update(old)
        assert not result.responses[0].ok
        assert breakers.breaker("mock://critic").state == "closed"


class TestPreemption:
    def _pump_once(self, sched, engine):
        batch = sched.next_batch(timeout=0.05)
        assert batch
        EnginePump(sched)._execute(batch)
        return batch

    def test_batch_preempted_then_readmitted_byte_prefix_parity(self):
        """A batch unit preempted for interactive
        pressure re-queues and its eventual transcript carries the
        preempted partial as a byte prefix (mock determinism + the
        batcher's byte-parity guarantee)."""
        serve_mod.configure(max_dispatch_batch=1, preempt_grace_s=0.0)
        eng = MockEngine()
        sched = ServeScheduler()
        gate.install(sched)
        try:
            batch_unit = _unit(
                tier="batch", debate="db", model="mock://critic", engine=eng
            )
            sched.submit_units([batch_unit])
            picked = sched.next_batch(timeout=0.05)
            assert picked == [batch_unit]
            # Interactive work arrives while the batch unit holds the
            # engine: the composed consumer must cancel it mid-stream.
            inter = _unit(
                tier="interactive", debate="di", model="mock://agree",
                engine=eng,
            )
            sched.submit_units([inter])
            EnginePump(sched)._execute(picked)
            assert batch_unit.state == "queued"  # released + readmitted
            assert not batch_unit.done.is_set()
            assert batch_unit.preempt_partials
            snap = serve_mod.snapshot()
            assert snap["units_preempted"] == 1
            assert snap["units_readmitted"] == 1
            # Interactive unit dispatches next (strict priority).
            nxt = sched.next_batch(timeout=0.05)
            assert nxt == [inter]
            EnginePump(sched)._execute(nxt)
            assert inter.completion.ok
            # The batch unit re-runs to completion; byte-prefix parity.
            again = sched.next_batch(timeout=0.05)
            assert again == [batch_unit]
            EnginePump(sched)._execute(again)
            assert batch_unit.completion.ok
            assert batch_unit.completion.text.startswith(
                batch_unit.preempt_partials[0]
            )
            assert len(batch_unit.completion.text) > len(
                batch_unit.preempt_partials[0]
            )
        finally:
            gate.uninstall()

    def test_interactive_never_preempted(self):
        serve_mod.configure(preempt_grace_s=0.0)
        sched = ServeScheduler()
        u = _unit(tier="interactive")
        assert sched.should_preempt(u) is False

    def test_grace_respects_clock(self):
        serve_mod.configure(preempt_grace_s=100.0)
        now = [0.0]
        sched = ServeScheduler(clock=lambda: now[0])
        sched.submit_units([_unit(tier="interactive", debate="di")])
        batch_unit = _unit(tier="batch", debate="db")
        assert sched.should_preempt(batch_unit) is False  # within grace
        now[0] = 200.0
        assert sched.should_preempt(batch_unit) is True

    def test_caller_cancel_beats_preemption(self):
        """An early-convergence cancel must resolve as FINISHED (clean
        truncation), never as a preemption re-queue, even when the
        preempt flag is also up."""
        serve_mod.configure(max_dispatch_batch=1)
        eng = MockEngine()
        sched = ServeScheduler()
        unit = _unit(
            tier="batch",
            model="mock://agree?agree_tail=8",
            engine=eng,
            # Caller cancels at the FIRST delivery — the same delivery
            # at which the raised preempt flag would otherwise fire.
            consumer=lambda i, text: False,
        )
        unit.preempt_requested = True
        sched.submit_units([unit])
        batch = sched.next_batch(timeout=0.05)
        EnginePump(sched)._execute(batch)
        assert unit.done.is_set()
        assert unit.state == "finished"
        assert unit.completion.cancelled


class TestDrain:
    def test_force_drain_sheds_queued_units_typed(self):
        sched = ServeScheduler()
        units = [_unit(debate="d1", index=i) for i in range(3)]
        sched.submit_units(units)
        n = sched.force_drain()
        assert n == 3
        for u in units:
            assert u.done.is_set()
            assert u.completion.error.startswith("drained:")
            assert u.completion.transient is False
            assert u.state == "drained"
        assert serve_mod.snapshot()["units_drained"] == 3

    def test_drain_mid_round_journal_resumable(self, tmp_path):
        """The drain contract end to end, deterministically: a 4-
        opponent journaled round gets exactly 2 opponents served (the
        pump is driven by hand), the drain forces the rest, and a
        resumed round replays the 2 durable completions with zero
        engine work."""
        serve_mod.configure(max_dispatch_batch=1)
        eng = MockEngine()
        sched = ServeScheduler()
        gate.install(sched)
        models = [f"mock://critic?v={k}" for k in range(4)]
        journal = RoundJournal("serve-drain", journal_dir=tmp_path)
        result_box = {}

        def debate_thread():
            from adversarial_spec_tpu_torch.debate.core import RoundConfig, run_round

            with gate.submission(Submission(tenant="t0", debate="d1")):
                result_box["result"] = run_round(
                    SPEC,
                    models,
                    cfg=RoundConfig(
                        journal=journal, trace_scope="serve-drain"
                    ),
                )

        th = threading.Thread(target=debate_thread, daemon=True)
        try:
            th.start()
            # Serve exactly two opponents, then force the drain.
            for _ in range(2):
                batch = sched.next_batch(timeout=2.0)
                assert batch, "round driver never submitted units"
                EnginePump(sched)._execute(batch)
            deadline = time.monotonic() + 2.0
            while time.monotonic() < deadline:
                if sched.force_drain() or sched.idle():
                    break
                time.sleep(0.01)
            th.join(timeout=5.0)
            assert not th.is_alive()
        finally:
            gate.uninstall()
        result = result_box["result"]
        ok = [r for r in result.responses if r.ok]
        failed = [r for r in result.responses if not r.ok]
        assert len(ok) == 2 and len(failed) == 2
        for r in failed:
            assert "drained" in r.error
        # The journal holds exactly the two durable completions; a
        # resumed round serves them byte-identically with zero engine
        # work for those opponents.
        replay = journal.replay(1, SPEC, models)
        assert sorted(replay) == [i for i, r in enumerate(result.responses) if r.ok]
        from adversarial_spec_tpu_torch.debate.core import RoundConfig, run_round

        resumed = run_round(
            SPEC, models, cfg=RoundConfig(journal=journal)
        )
        assert all(r.ok for r in resumed.responses)
        assert int(resumed.tracer.counters.get("journal.served", 0)) == 2
        for i in replay:
            assert (
                resumed.responses[i].critique
                == result.responses[i].critique
            )


class TestShutdownSafety:
    """Review-found regression pins: a debate thread that reaches the
    scheduler AFTER shutdown/force-drain must resolve immediately, not
    block forever on a queue nobody serves."""

    def test_submit_after_stop_resolves_drained(self):
        sched = ServeScheduler()
        sched.stop()
        units = [_unit(debate="late", index=i) for i in range(2)]
        sched.submit_units(units)
        for u in units:
            assert u.done.is_set()  # no hang: resolved on arrival
            assert u.completion.error.startswith("drained:")
            assert u.state == "drained"

    def test_submit_after_force_drain_resolves_drained(self):
        sched = ServeScheduler()
        sched.force_drain()
        u = _unit(debate="late")
        sched.submit_units([u])
        assert u.done.is_set()
        assert u.completion.error.startswith("drained:")

    def test_ttft_measured_from_admission_not_thread_start(self):
        """The executor queue wait is latency the client pays; the
        reported ttft_s must include it (run_debate threads t0 =
        accept_t through the Submission probe)."""
        serve_mod.configure(max_dispatch_batch=1)
        sched = ServeScheduler()
        gate.install(sched)
        pump = EnginePump(sched)
        pump.start()
        try:
            sched.try_admit("t0", "interactive", "d1", 100)
            accept_t = time.monotonic() - 30.0  # admitted 30s "ago"
            payload = run_debate(
                {
                    "tenant": "t0",
                    "tier": "interactive",
                    "spec": SPEC,
                    "models": ["mock://agree"],
                    "round": 1,
                },
                sched,
                debate_id="d1",
                accept_t=accept_t,
            )
        finally:
            sched.stop()
            gate.uninstall()
            pump.join(timeout=5)
        assert payload["ttft_s"] >= 30.0


class TestTraceScopes:
    """Per-debate trace scopes + daemon-safe
    resets (the one-invocation-one-round assumption unbaked)."""

    def test_scoped_minting_no_collision(self):
        a1 = obs_mod.trace.mint_trace(1, scope="debate-a")
        b1 = obs_mod.trace.mint_trace(1, scope="debate-b")
        a2 = obs_mod.trace.mint_trace(2, scope="debate-a")
        assert a1 != b1  # same round, different debates: distinct ids
        assert a1.split("-")[-1] == a2.split("-")[-1]  # stable suffix
        # Deterministic per scope: a fresh scope counter restarts.
        obs_mod.trace.reset_scope("debate-a")
        assert obs_mod.trace.mint_trace(1, scope="debate-a") == a1

    def test_scoped_minting_does_not_reset_other_scopes(self):
        obs_mod.trace.reset()
        obs_mod.trace.mint_trace(1, scope="a")
        obs_mod.trace.mint_trace(1, scope="b")
        second_a = obs_mod.trace.mint_trace(1, scope="a")
        # Scope b minting did not reset scope a's counter.
        assert second_a.startswith("tr-001-02-")

    def test_unscoped_minting_unchanged(self):
        """The CLI path's exact-id pins survive: no scope = the
        process-wide counter and the classic format."""
        obs_mod.trace.reset()
        assert obs_mod.trace.mint_trace(3) == "tr-003-01"
        assert obs_mod.trace.mint_trace(3) == "tr-003-02"

    def test_ambient_is_thread_local(self):
        obs_mod.trace.set_ambient("tr-main", "")
        seen = {}

        def other():
            seen["before"] = obs_mod.trace.get_ambient()
            obs_mod.trace.set_ambient("tr-other", "s")
            seen["after"] = obs_mod.trace.get_ambient()

        th = threading.Thread(target=other)
        th.start()
        th.join()
        assert seen["before"] == ("", "")  # fresh thread: clean ambient
        assert seen["after"] == ("tr-other", "s")
        assert obs_mod.trace.get_ambient() == ("tr-main", "")
        obs_mod.trace.set_ambient("", "")

    def test_two_interleaved_concurrent_rounds(self):
        """The daemon regression: two debates run CONCURRENTLY
        in one process — no trace-id collision, each debate's span ids
        embed its own trace, and neither debate's counters are reset by
        the other (no cross-debate counter reset)."""
        serve_mod.configure(max_dispatch_batch=1)
        sched = ServeScheduler()
        gate.install(sched)
        pump = EnginePump(sched)
        pump.start()
        results = {}

        def one(name):
            sched.try_admit(name, "interactive", name, 100)
            results[name] = run_debate(
                {
                    "tenant": name,
                    "tier": "interactive",
                    "spec": SPEC,
                    "models": ["mock://critic?v=1", "mock://critic?v=2"],
                    "round": 1,
                },
                sched,
                debate_id=name,
            )

        try:
            threads = [
                threading.Thread(target=one, args=(n,), daemon=True)
                for n in ("da", "db")
            ]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=20)
                assert not t.is_alive()
        finally:
            sched.stop()
            gate.uninstall()
            pump.join(timeout=5)
        ra, rb = results["da"], results["db"]
        assert ra["trace_id"] != rb["trace_id"]
        for payload in (ra, rb):
            for r in payload["results"]:
                assert r["error"] is None
                assert r["span_id"].startswith(payload["trace_id"] + "/s")
        # No cross-debate counter reset: the process stats saw BOTH
        # debates accumulate (a per-invocation reset mid-serve would
        # have zeroed the first debate's counts).
        snap = serve_mod.snapshot()
        assert snap["completed_debates"] == 2
        assert snap["units_completed"] == 4


class TestBreakersInDaemon:
    """Per-process breakers stay authoritative
    across successive rounds in one daemon process; snapshots ride the
    per-debate result at round commit."""

    def _debate(self, sched, name, models):
        sched.try_admit("t0", "interactive", name, 100)
        return run_debate(
            {
                "tenant": "t0",
                "tier": "interactive",
                "spec": SPEC,
                "models": models,
                "round": 1,
            },
            sched,
            debate_id=name,
        )

    def test_open_circuit_skips_across_rounds_one_process(self):
        breakers = breaker_mod.default_registry()
        breakers.configure(threshold=1, cooldown_s=3600.0)
        serve_mod.configure(max_dispatch_batch=1)
        sched = ServeScheduler()
        gate.install(sched)
        pump = EnginePump(sched)
        pump.start()
        try:
            r1 = self._debate(
                sched, "d1", ["mock://error", "mock://critic"]
            )
            # Round 1 opened the circuit (threshold 1); the snapshot
            # rides the result payload at round commit.
            assert r1["breakers"]["mock://error"]["state"] == "open"
            from adversarial_spec_tpu_torch.engine import dispatch

            inner = dispatch.cached_engines()[0]
            calls_before = dict(inner._calls)
            r2 = self._debate(
                sched, "d2", ["mock://error", "mock://critic"]
            )
            # Round 2 in the SAME process: the failing model degraded
            # with ZERO engine attempts (no stale half-open probe — the
            # cooldown has not elapsed).
            assert "circuit open" in r2["results"][0]["error"]
            assert inner._calls.get("mock://error", 0) == calls_before.get(
                "mock://error", 0
            )
            assert r2["results"][1]["error"] is None
        finally:
            sched.stop()
            gate.uninstall()
            pump.join(timeout=5)

    def test_probe_not_leaked_between_tenants(self):
        """One half-open probe at a time, registry-wide: tenant A's
        in-flight probe means tenant B's request for the same model is
        degraded, not admitted as a second probe."""
        clock = [0.0]
        reg = breaker_mod.BreakerRegistry(
            threshold=1, cooldown_s=10.0, clock=lambda: clock[0]
        )
        reg.record("m", ok=False)
        assert reg.breaker("m").state == "open"
        clock[0] = 11.0
        assert reg.allow("m") is True  # tenant A's probe admitted
        assert reg.allow("m") is False  # tenant B must wait, not probe


@pytest.mark.chaos
class TestDaemonSocket:
    """The deterministic mock-engine daemon smoke (tier-1, chaos
    marker): a REAL unix socket, a real storm, the real drain."""

    def _start(self, tmp_path):
        sock = str(tmp_path / "serve.sock")
        ready = threading.Event()
        daemon = ServeDaemon(sock, sessions_dir=str(tmp_path / "sessions"))
        th = threading.Thread(
            target=lambda: asyncio.run(daemon.run(ready=ready)), daemon=True
        )
        th.start()
        assert ready.wait(10), "daemon did not come up"
        return daemon, th, sock

    def test_lifecycle_smoke(self, tmp_path):
        serve_mod.configure(max_queue_depth=8, max_backlog_tokens=10**6)
        daemon, th, sock = self._start(tmp_path)
        client = ServeClient(sock)
        try:
            assert client.ping()["event"] == "pong"
            rid = client.submit_debate(
                SPEC,
                ["mock://critic?v=1", "mock://agree"],
                stream=True,
            )
            evs = client.collect(rid, timeout_s=20)
            kinds = [e["event"] for e in evs]
            assert kinds[0] == "accepted" and kinds[-1] == "result"
            assert "stream" in kinds  # per-token transport delivered
            res = evs[-1]
            assert res.get("error") is None
            assert [r["agreed"] for r in res["results"]] == [False, True]
            assert res["ttft_s"] >= 0.0
            stats = client.stats()
            assert stats["serve"]["completed_debates"] == 1
            assert client.check()["ok"] is True
        finally:
            client.drain()
            client.close()
            th.join(timeout=15)
            assert not th.is_alive()
        assert daemon.drain_report["clean_exit"] is True

    def test_stats_op_exposes_admission_pressure(self, tmp_path):
        """The stats op carries the admission ledger's live pressure
        view over the wire — the ``pressure_snapshot`` the autoscaler
        reads in-process (backlog tokens, brownout, capacity) plus the
        per-tier queue depths already in ``scheduler`` — so the replay
        harness and external scrapers see the same numbers the
        scheduler sheds on."""
        serve_mod.configure(max_queue_depth=8, max_backlog_tokens=10**6)
        daemon, th, sock = self._start(tmp_path)
        client = ServeClient(sock)
        try:
            rid = client.submit_debate(
                SPEC, ["mock://critic?v=1", "mock://agree"]
            )
            client.collect(rid, timeout_s=20)
            stats = client.stats()
            pressure = stats["pressure"]
            for key in (
                "backlog_tokens",
                "prefill_backlog_tokens",
                "decode_backlog_tokens",
                "capacity_tokens",
                "brownout",
                "draining",
            ):
                assert key in pressure, key
            assert pressure["capacity_tokens"] == 10**6
            assert pressure["brownout"] is False
            assert pressure["draining"] is False
            # Per-tier queue depths ride in the scheduler snapshot.
            assert set(stats["scheduler"]["queued_units"]) >= {
                "interactive",
                "batch",
            }
        finally:
            client.drain()
            client.close()
            th.join(timeout=15)

    def test_overload_storm_sheds_typed_zero_loss(self, tmp_path):
        """The tier-1 slice of chaos_run --overload: open-loop burst
        past the caps → typed sheds, zero accepted loss, brownout,
        interactive admitted in full, invariants clean."""
        serve_mod.configure(
            max_queue_depth=2, max_backlog_tokens=16000
        )
        daemon, th, sock = self._start(tmp_path)
        client = ServeClient(sock, timeout_s=60)
        try:
            submitted = []
            for k in range(12):
                submitted.append(
                    (
                        client.submit_debate(
                            SPEC,
                            ["mock://critic?v=1", "mock://critic?v=2"],
                            tenant=f"b{k % 2}",
                            tier="batch",
                            max_new_tokens=1536,
                        ),
                        "batch",
                    )
                )
                if k < 4:
                    submitted.append(
                        (
                            client.submit_debate(
                                SPEC,
                                ["mock://agree"],
                                tenant=f"i{k % 2}",
                                tier="interactive",
                                max_new_tokens=64,
                            ),
                            "interactive",
                        )
                    )
            shed = {"batch": 0, "interactive": 0}
            accepted = {"batch": 0, "interactive": 0}
            lost = 0
            for rid, tier in submitted:
                evs = client.collect(rid, timeout_s=60)
                if evs[0]["event"] == "accepted":
                    accepted[tier] += 1
                    last = evs[-1]
                    if last["event"] != "result" or last.get("error") or any(
                        r["error"] for r in last["results"]
                    ):
                        lost += 1
                else:
                    assert evs[-1]["event"] == "shed"
                    assert evs[-1]["reason"] in protocol.SHED_REASONS
                    assert isinstance(
                        evs[-1]["retry_after_s"], (int, float)
                    )
                    shed[tier] += 1
            assert lost == 0  # zero accepted-request loss
            assert accepted["interactive"] == 4  # never shed
            assert shed["batch"] > 0  # batch starved first
            snap = serve_mod.snapshot()
            assert snap["brownout_entries"] >= 1
            assert client.check()["ok"] is True
            assert (
                accepted["batch"]
                + accepted["interactive"]
                + shed["batch"]
                + shed["interactive"]
                == len(submitted)
            )
        finally:
            client.drain()
            client.close()
            th.join(timeout=15)

    def test_refill_and_stats_ops(self, tmp_path):
        serve_mod.configure(tenant_quota_tokens=50)
        daemon, th, sock = self._start(tmp_path)
        client = ServeClient(sock)
        try:
            rid = client.submit_debate(SPEC, ["mock://critic"], tenant="q0")
            last = client.collect(rid, timeout_s=20)[-1]
            assert last["event"] == "result"
            # The round charged more than the 50-token quota: the next
            # debate sheds until a refill lands.
            shed = client.collect(
                client.submit_debate(SPEC, ["mock://critic"], tenant="q0"),
                timeout_s=20,
            )[-1]
            assert shed["event"] == "shed" and shed["reason"] == "quota"
            refill = client.refill("q0", 100000)
            assert refill["quota_remaining"] > 0
            ok = client.collect(
                client.submit_debate(SPEC, ["mock://critic"], tenant="q0"),
                timeout_s=20,
            )[-1]
            assert ok["event"] == "result" and not ok.get("error")
        finally:
            client.drain()
            client.close()
            th.join(timeout=15)

    def test_malformed_requests_answered_not_fatal(self, tmp_path):
        daemon, th, sock = self._start(tmp_path)
        client = ServeClient(sock)
        try:
            client.sock.sendall(b"not json at all\n")
            ev = client.recv(timeout_s=10)
            assert ev["event"] == "error"
            bad = client.call({"op": "debate", "tenant": "t0"})
            assert bad["event"] == "error"
            assert client.ping()["event"] == "pong"  # daemon unharmed
        finally:
            client.drain()
            client.close()
            th.join(timeout=15)


class TestCliServe:
    def test_parser_accepts_serve_flags(self):
        from adversarial_spec_tpu_torch import cli

        parser = cli.create_parser()
        args = parser.parse_args(
            [
                "serve",
                "--socket",
                "/tmp/x.sock",
                "--serve-queue-depth",
                "3",
                "--serve-backlog-tokens",
                "9999",
                "--serve-quota-tokens",
                "100",
                "--serve-drain-deadline-s",
                "1.5",
                "--serve-ttft-slo-ms",
                "250",
                "--drain-report",
                "/tmp/report.json",
            ]
        )
        assert args.action == "serve"
        assert args.serve_queue_depth == 3
        assert args.serve_drain_deadline_s == 1.5

    def test_env_defaults(self, monkeypatch):
        monkeypatch.setenv("ADVSPEC_SERVE_QUEUE_DEPTH", "17")
        monkeypatch.setenv("ADVSPEC_SERVE_BACKLOG_TOKENS", "12345")
        monkeypatch.setenv("ADVSPEC_SERVE_QUOTA_TOKENS", "77")
        monkeypatch.setenv("ADVSPEC_SERVE_DRAIN_DEADLINE_S", "2.5")
        monkeypatch.setenv("ADVSPEC_SERVE_TTFT_SLO_MS", "300")
        assert serve_mod.env_queue_depth() == 17
        assert serve_mod.env_backlog_tokens() == 12345
        assert serve_mod.env_quota_tokens() == 77
        assert serve_mod.env_drain_deadline_s() == 2.5
        assert serve_mod.env_ttft_slo_ms() == 300.0

    def test_env_garbage_falls_back(self, monkeypatch):
        monkeypatch.setenv("ADVSPEC_SERVE_QUEUE_DEPTH", "lots")
        monkeypatch.setenv("ADVSPEC_SERVE_DRAIN_DEADLINE_S", "-3")
        assert serve_mod.env_queue_depth() == serve_mod.DEFAULT_QUEUE_DEPTH
        assert serve_mod.env_drain_deadline_s() == 0.0


class TestServeTooling:
    """The reference's tooling tests read ``tools/`` (which imports the
    JAX package); the port's events, snapshots and sources are held to
    the same schema and rules here."""

    @staticmethod
    def _events(obs):
        from adversarial_spec_tpu_torch.obs.events import event_to_dict as port_e2d

        e2d = port_e2d if obs is obs_mod else ref_event_to_dict
        return [
            e2d(1, obs.ServeEvent(
                op="accepted", tenant="tA", tier="interactive",
                debate="d00001", tokens=100, backlog_tokens=100,
            )),
            e2d(2, obs.ServeEvent(
                op="running", tenant="tA", tier="interactive",
                debate="d00001", index=0, backlog_tokens=100,
            )),
            e2d(3, obs.StepEvent(kind="decode", n_live=1)),
            e2d(4, obs.ServeEvent(
                op="shed", tenant="tB", tier="batch", debate="d00002",
                reason="brownout", backlog_tokens=900,
            )),
            e2d(5, obs.ServeEvent(
                op="preempted", tenant="tC", tier="batch",
                debate="d00003", index=1, reason="tier_pressure",
                backlog_tokens=900,
            )),
        ]

    def test_obs_dump_renders_tenant_column_and_shed_rows(self):
        """The port's serve events validate under the port's schema,
        encode exactly as the reference's do, and so render as the
        reference's in its timeline (tenant column, shed and preempt
        rows, backlog)."""
        from tools.obs_dump import occupancy_timeline, summarize

        events = self._events(obs_mod)
        for e in events:
            assert validate_event(e) == [], e
            assert ref_validate_event(e) == [], e
        assert events == self._events(ref_obs)
        timeline = occupancy_timeline(events)
        assert "ten=tA" in timeline  # the per-tenant column
        assert "serve:shed" in timeline and "(brownout)" in timeline
        assert "serve:preempted" in timeline
        assert "backlog=900" in timeline
        summary = summarize(events)
        assert "1 typed load-shed refusal(s): brownout=1" in summary
        assert "1 batch unit(s) preempted" in summary

    def test_serve_snapshot_schema_matches_reference(self):
        """The ``stats`` op's ``serve`` block (and so the drain report's
        ``stats``) carries the reference's keys, defaults and derived
        ``shed_fraction``; dropping a counter is a schema break."""
        from adversarial_spec_tpu import serve as ref_serve

        ref_serve.reset_stats()
        for mod in (serve_mod, ref_serve):
            mod.stats.accepted_debates += 1
            mod.stats.shed_debates += 1
        port, ref = serve_mod.snapshot(), ref_serve.snapshot()
        ref_serve.reset_stats()
        assert port == ref
        assert port["shed_fraction"] == 0.5
        for key in ("shed_fraction", "units_preempted", "brownout_entries"):
            assert key in port, key

    def test_lifecycle_live_fire_pin(self):
        """Stripping the serve release surgery fires GL-LIFECYCLE on the
        port's source — and the committed source is clean."""
        from pathlib import Path

        from tools.graftlint.core import lint_sources

        path = "adversarial_spec_tpu_torch/serve/sched.py"
        src = (Path(__file__).resolve().parent.parent / path).read_text()
        assert lint_sources({path: src}, rules=["GL-LIFECYCLE"]) == []
        assert "self._release_unit(" in src
        mutated = src.replace(
            "self._release_unit(", "(lambda *a, **k: None)("
        )
        findings = lint_sources({path: mutated}, rules=["GL-LIFECYCLE"])
        assert findings, (
            "stripping _release_unit produced no GL-LIFECYCLE finding "
            "— the serve machine is unguarded"
        )
        assert "ServeScheduler" in " ".join(f.message for f in findings)

    def test_estimate_tokens_scales(self):
        small = estimate_tokens(
            ChatRequest(model="m", system="s", user="u"),
            SamplingParams(max_new_tokens=10),
        )
        big = estimate_tokens(
            ChatRequest(model="m", system="s" * 4000, user="u" * 4000),
            SamplingParams(max_new_tokens=1000),
        )
        assert big > small > 0


# -- the port's daemon against the reference's ---------------------------------

# Fields that read a clock, and trace ids (minted per process), masked
# before two daemons' events compare.
_MASKED = {
    "wall_s", "ttft_s", "uptime_s", "arrival_s", "drain_rate_tokens_per_s",
    "trace_id", "span_id",
}


def _mask(node):
    if isinstance(node, dict):
        return {k: ("<m>" if k in _MASKED else _mask(v)) for k, v in node.items()}
    if isinstance(node, list):
        return [_mask(v) for v in node]
    return node


class _HoldFirstBatch:
    """The mock engine behind a latch: the first dispatch of the batch
    debate's opponent waits until the test has seen interactive work
    queue behind it, so the preemption happens at the same delivery in
    every run."""

    def __init__(self, inner, model):
        self.inner, self.model = inner, model
        self.holding, self.release = threading.Event(), threading.Event()

    def validate(self, model):
        return self.inner.validate(model)

    def chat(self, requests, params, consumer=None):
        if not self.holding.is_set() and any(r.model == self.model for r in requests):
            self.holding.set()
            assert self.release.wait(20), "test never released the batch unit"
        return self.inner.chat(requests, params, consumer=consumer)


def _scripted_conversation(pkg, tmp_path):
    """Two tenants over one socket: a streamed batch debate held in the
    engine, a second batch debate of the same tenant (shed: queue
    depth 1), an interactive debate of the other tenant that preempts
    the batch unit, then the drain op. Returns the masked client events
    per request, the recorder's serve events and the drain report."""
    if pkg == "port":
        serve, obs = serve_mod, obs_mod
        from adversarial_spec_tpu_torch.engine import dispatch
        from adversarial_spec_tpu_torch.engine.mock import MockEngine as Mock
        from adversarial_spec_tpu_torch.serve.client import ServeClient as Client
        from adversarial_spec_tpu_torch.serve.daemon import ServeDaemon as Daemon
    else:
        from adversarial_spec_tpu import serve
        from adversarial_spec_tpu import obs
        from adversarial_spec_tpu.engine import dispatch
        from adversarial_spec_tpu.engine.mock import MockEngine as Mock
        from adversarial_spec_tpu.serve.client import ServeClient as Client
        from adversarial_spec_tpu.serve.daemon import ServeDaemon as Daemon
    held = "mock://critic?v=1"
    eng = _HoldFirstBatch(Mock(), held)
    dispatch.clear_engine_cache()
    dispatch._ENGINE_CACHE["mock"] = eng
    serve.configure(max_queue_depth=1, max_backlog_tokens=10**6, preempt_grace_s=0.0)
    serve.reset_stats()
    obs.reset_stats()
    sock = str(tmp_path / f"{pkg}.sock")
    ready = threading.Event()
    daemon = Daemon(sock, sessions_dir=str(tmp_path / f"{pkg}-sessions"))
    th = threading.Thread(target=lambda: asyncio.run(daemon.run(ready=ready)), daemon=True)
    th.start()
    assert ready.wait(10), "daemon did not come up"
    client = Client(sock, timeout_s=30)
    try:
        rid_a = client.submit_debate(SPEC, [held], tenant="tA", tier="batch", stream=True)
        assert eng.holding.wait(20)
        rid_shed = client.submit_debate(SPEC, ["mock://agree"], tenant="tA", tier="batch")
        shed = client.collect(rid_shed, timeout_s=20)
        rid_b = client.submit_debate(
            SPEC, ["mock://agree", "mock://critic?v=2"], tenant="tB", stream=True
        )
        deadline = time.monotonic() + 20
        while not daemon.sched.state_snapshot()["queued_units"]["interactive"]:
            assert time.monotonic() < deadline, "interactive units never queued"
            time.sleep(0.005)
        eng.release.set()
        evs = {
            "shed": shed,
            "b": client.collect(rid_b, timeout_s=30),
            "a": client.collect(rid_a, timeout_s=30),
        }
        evs["check"] = [client.check()]
        evs["drain"] = [client.drain()]
    finally:
        eng.release.set()
        client.close()
        th.join(timeout=15)
        dispatch.clear_engine_cache()
    assert not th.is_alive()
    # Once the interactive debate's last unit completes, its thread
    # finishing the debate races the pump starting the batch unit's
    # re-run: the order of events ACROSS debates, the backlog gauge
    # sampled at each transition and the mid-run counters in a result
    # vary from run to run. Each debate's own sequence does not.
    per_debate: dict = {}
    for e in obs.recorder.events():
        if e["type"] == "serve":
            per_debate.setdefault(e["debate"], []).append(
                {k: v for k, v in e.items() if k not in ("seq", "backlog_tokens")}
            )
    for e in evs["a"] + evs["b"]:
        e.pop("serve", None)
    return _mask(evs), _mask(per_debate), _mask(daemon.drain_report)


@pytest.mark.chaos
def test_daemon_event_sequences_match_reference(tmp_path):
    """The same scripted conversation through both daemons: equal client
    events (accepted, stream, shed, result, check, drain acks), equal
    serve lifecycle events in the flight recorder (per debate) and equal
    drain reports (the final counters), clock fields and trace ids
    masked."""
    from adversarial_spec_tpu import serve as ref_serve
    from adversarial_spec_tpu.serve import gate as ref_gate

    try:
        ref = _scripted_conversation("ref", tmp_path)
    finally:
        ref_gate.uninstall()
        ref_serve.configure(max_queue_depth=ref_serve.DEFAULT_QUEUE_DEPTH)
        ref_serve.reset_stats()
    got = _scripted_conversation("port", tmp_path)
    evs, serve_events, report = got
    kinds = [e["event"] for e in evs["a"]]
    assert kinds[0] == "accepted" and kinds[-1] == "result" and "stream" in kinds
    assert evs["shed"][-1]["event"] == "shed"
    assert evs["shed"][-1]["reason"] == "queue_full"
    ops = [e["op"] for seq in serve_events.values() for e in seq]
    assert "preempted" in ops and "shed" in ops
    assert report["stats"]["units_preempted"] == 1
    assert report["stats"]["units_readmitted"] == 1
    assert report["clean_exit"] is True
    assert got[0] == ref[0]
    assert got[1] == ref[1]
    assert got[2] == ref[2]


@pytest.fixture
def tiny_f32_registry(tmp_path, monkeypatch):
    """``tpu://random-tiny`` in f32 on one device, one registry file for
    both packages (f32: where greedy text is byte-identical)."""
    from adversarial_spec_tpu.engine import registry as ref_registry
    from adversarial_spec_tpu_torch.engine import registry

    path = tmp_path / "registry.json"
    monkeypatch.setattr(ref_registry, "REGISTRY_PATH", path)
    monkeypatch.setattr(registry, "REGISTRY_PATH", path)
    registry.save_registry_entry(
        registry.ModelSpec(
            alias="random-tiny", family="llama", size="tiny",
            dtype="float32", mesh={"dp": 1},
        ),
        path,
    )
    return path


def _tiny_debate(daemon_cls, client_cls, sock):
    ready = threading.Event()
    daemon = daemon_cls(sock)
    th = threading.Thread(target=lambda: asyncio.run(daemon.run(ready=ready)), daemon=True)
    th.start()
    assert ready.wait(10), "daemon did not come up"
    client = client_cls(sock, timeout_s=120)
    try:
        rid = client.send({
            "op": "debate", "tenant": "t0", "spec": SPEC,
            "models": ["tpu://random-tiny", "tpu://random-tiny"],
            "max_new_tokens": 24, "greedy": True,
        })
        res = client.collect(rid, timeout_s=120)[-1]
        check = client.check()
        client.drain()
    finally:
        client.close()
        th.join(timeout=30)
    assert not th.is_alive()
    return res, check


def test_tiny_model_debate_matches_reference_daemon(tiny_f32_registry, tmp_path):
    """A ``tpu://random-tiny`` debate through the port's daemon, on a CPU
    ``GpuEngine`` holding the reference's weights, gives the reference
    daemon's results byte for byte; the ``check`` op reaches the
    engine's residency ledger walk."""
    import jax
    import numpy as np
    import torch

    from adversarial_spec_tpu.engine import dispatch as ref_dispatch
    from adversarial_spec_tpu.engine.tpu import TpuEngine
    from adversarial_spec_tpu.serve.client import ServeClient as RefClient
    from adversarial_spec_tpu.serve.daemon import ServeDaemon as RefDaemon
    from adversarial_spec_tpu_torch.engine import dispatch
    from adversarial_spec_tpu_torch.engine.gpu import GpuEngine
    from adversarial_spec_tpu_torch.engine.loader import params_from_jax
    from adversarial_spec_tpu_torch.serve.client import ServeClient
    from adversarial_spec_tpu_torch.serve.daemon import ServeDaemon

    ref_engine = TpuEngine()
    lm = ref_engine._load("random-tiny")
    ref_dispatch._ENGINE_CACHE["tpu"] = ref_engine
    try:
        ref, ref_check = _tiny_debate(RefDaemon, RefClient, str(tmp_path / "r.sock"))
    finally:
        ref_dispatch.clear_engine_cache()
    port = GpuEngine(device="cpu")
    port.install(
        "random-tiny",
        params_from_jax(jax.tree.map(np.asarray, lm.params), lm.cfg, "cpu", torch.float32),
    )
    dispatch.install_engine("tpu://random-tiny", port)
    got, check = _tiny_debate(ServeDaemon, ServeClient, str(tmp_path / "p.sock"))
    assert ref.get("error") is None and got.get("error") is None
    assert [r["error"] for r in got["results"]] == [None, None]
    keys = ("model", "agreed", "response", "spec", "input_tokens", "output_tokens",
            "cached_tokens")
    for r, g in zip(ref["results"], got["results"]):
        for k in keys:
            assert g[k] == r[k], k
        assert g["response"].encode() == r["response"].encode()
    assert got["results"][0]["output_tokens"] > 0
    assert check["ok"] is True and check["checked"] == 1
    assert ref_check["ok"] is True


def test_module_daemon_serves_mock_with_jax_blocked(tmp_path):
    """``python -m adversarial_spec_tpu_torch.serve`` with jax blocked:
    ping, a streamed mock debate and ``check`` over the socket, then
    SIGTERM drains it — exit 0 with the drain report as the last stdout
    line."""
    import os
    import signal
    import subprocess
    import sys
    from pathlib import Path

    from adversarial_spec_tpu_torch.serve.client import ServeClient

    repo = Path(__file__).resolve().parent.parent
    sock = tmp_path / "s.sock"
    report = tmp_path / "report.json"
    boot = (
        "import sys, runpy; sys.modules['jax'] = None; "
        f"sys.argv = ['serve', '--socket', {str(sock)!r}, "
        f"'--drain-report', {str(report)!r}]; "
        "runpy.run_module('adversarial_spec_tpu_torch.serve', run_name='__main__')"
    )
    env = {**os.environ, "PYTHONPATH": str(repo), "HOME": str(tmp_path)}
    proc = subprocess.Popen(
        [sys.executable, "-c", boot], cwd=repo, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
    )
    try:
        deadline = time.monotonic() + 60
        while not sock.exists():
            assert proc.poll() is None, proc.communicate()[1]
            assert time.monotonic() < deadline, "daemon did not come up"
            time.sleep(0.05)
        client = ServeClient(str(sock), timeout_s=30)
        try:
            assert client.ping()["event"] == "pong"
            rid = client.submit_debate(SPEC, ["mock://agree", "mock://critic"], stream=True)
            evs = client.collect(rid, timeout_s=30)
            assert evs[-1]["event"] == "result" and "stream" in [e["event"] for e in evs]
            assert [r["agreed"] for r in evs[-1]["results"]] == [True, False]
            assert client.check()["ok"] is True
        finally:
            client.close()
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=30)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err
    drain = json.loads(out.strip().splitlines()[-1])
    assert drain["event"] == "drain_report" and drain["reason"] == "sigterm"
    assert drain["clean_exit"] is True
    assert drain["stats"]["completed_debates"] == 1
    assert json.loads(report.read_text()) == drain
