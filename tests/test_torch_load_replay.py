"""The port's trace-replay load harness (``tools/load_replay_torch.py``):
the reference's ``tests/test_load_replay.py`` on the port's serve daemon,
then parity with ``tools/load_replay.py`` on the same inputs.

The four contracts the harness stands on: the canonical shape encoding
is invertible (record → reconstruct → identical requests), the synthetic
generator is seed-deterministic, the recording reader is torn/foreign-line
tolerant, and the arrival process is OPEN-LOOP. The chaos-marked cases
drive the port's daemon end to end, one of them on a pool of two
``tpu://`` ids served by a CPU ``GpuEngine`` (``models=``). The rendering
cases read a recording the port's daemon wrote with ``tools/obs_dump.py``
and ``tools/trace_view.py``. The parity cases run both tools on the same
specs, estimates, files and traces.
"""

from __future__ import annotations

import dataclasses
import json
import time
from pathlib import Path

import pytest

from tests import torch_cli_support as sup

from adversarial_spec_tpu_torch.serve import driver
from tools import load_replay as ref
from tools import load_replay_torch as load_replay
from tools.load_replay_torch import (
    ReplayRequest,
    ServeKnobs,
    SLOSpec,
    SynthSpec,
    canonical_spec,
    est_tokens_for,
    read_recording,
    replay_once,
    slo_breaches,
    spec_chars_from_est,
    synthesize,
    tenant_rates,
)

# A two-opponent pool of ``tpu://`` ids (a paged tiny alias) served by a
# CPU GpuEngine: the departure ``models=`` exists for.
TPU_POOL = ("tpu://paged-tiny", "tpu://paged-tiny")


@pytest.fixture(autouse=True)
def _port_state(tmp_path, monkeypatch):
    yield from sup.isolate_port(tmp_path, monkeypatch)


def _serve_line(seq, op="accepted", arrival=1.0, tokens=None,
                tier="interactive", tenant="t0"):
    if tokens is None:
        tokens = est_tokens_for(512, tier)
    return json.dumps(
        {
            "seq": seq,
            "type": "serve",
            "op": op,
            "tenant": tenant,
            "tier": tier,
            "debate": f"d{seq:05d}",
            "index": -1,
            "reason": "",
            "tokens": tokens,
            "backlog_tokens": 0,
            "arrival_s": arrival,
            "trace_id": "",
            "span_id": "",
        }
    )


def _torn_recording(path: Path) -> Path:
    """A recording with every kind of line the reader must drop alone."""
    lines = [
        _serve_line(1, arrival=1.0),
        "{not json at all",
        json.dumps({"seq": 2, "type": "futuristic", "op": "warp"}),
        json.dumps({"seq": 3, "type": "step", "kind": "decode"}),
        # serve event from a FOREIGN workload: non-canonical est.
        _serve_line(4, arrival=1.5, tokens=7),
        # serve event with a wrong-typed tokens field.
        _serve_line(5, arrival=1.6).replace(
            f'"tokens": {est_tokens_for(512, "interactive")}',
            '"tokens": "many"',
        ),
        # unarmed event (arrival 0): recorded pre-arming, not ours.
        _serve_line(6, arrival=0.0),
        _serve_line(7, arrival=2.0),
    ]
    # Torn tail: the final line has no newline terminator.
    path.write_text("\n".join(lines) + "\n" + _serve_line(8)[:20])
    return path


class TestCanonicalShapeEncoding:
    def test_spec_is_exact_length_and_deterministic(self):
        for n in (128, 256, 513, 2048, 4096):
            s = canonical_spec(n)
            assert len(s) == n - (n % 4)
            assert s == canonical_spec(n)

    def test_est_inverts_for_every_canonical_shape(self):
        """estimate → shape → estimate is the identity for every
        canonical (chars, tier), and the port daemon's estimator agrees
        byte for byte — for the mock pool and for a pool of two
        ``tpu://`` ids alike."""
        for tier in ("interactive", "batch"):
            for chars in (128, 400, 512, 1000, 4096):
                chars = len(canonical_spec(chars))
                for models in (load_replay.MODELS, TPU_POOL):
                    est = est_tokens_for(chars, tier, models=models)
                    assert spec_chars_from_est(est, tier, models=models) == chars
                    assert est == driver.estimate_debate_tokens(
                        {
                            "spec": canonical_spec(chars),
                            "models": list(models),
                            "max_new_tokens": load_replay.TIER_MAX_NEW[tier],
                        }
                    )

    def test_foreign_estimates_rejected(self):
        assert spec_chars_from_est(3, "interactive") is None  # odd
        assert spec_chars_from_est(10, "interactive") is None  # tiny
        assert spec_chars_from_est(10**6, "batch") is None  # huge
        assert spec_chars_from_est(900, "premium") is None  # bad tier


class TestSynthesis:
    def test_seed_determinism(self):
        a = synthesize(SynthSpec(seed=7, requests=40))
        b = synthesize(SynthSpec(seed=7, requests=40))
        assert a == b
        c = synthesize(SynthSpec(seed=8, requests=40))
        assert a != c

    def test_trace_shape(self):
        reqs = synthesize(SynthSpec(seed=0, requests=80, tenants=3))
        assert len(reqs) == 80
        offsets = [r.arrival_s for r in reqs]
        assert offsets == sorted(offsets) and offsets[0] > 0
        rates = tenant_rates(reqs)
        assert set(rates) <= {"t0", "t1", "t2"}
        assert rates["t0"] == max(rates.values())
        assert {r.tier for r in reqs} == {"interactive", "batch"}
        for r in reqs:
            assert r.spec_chars == len(canonical_spec(r.spec_chars))


class TestTolerantReader:
    def test_reconstructs_arrivals_rebased(self, tmp_path):
        p = tmp_path / "events.jsonl"
        p.write_text(
            _serve_line(1, arrival=5.0)
            + "\n"
            + _serve_line(2, arrival=5.25, tier="batch", tenant="t1")
            + "\n"
        )
        reqs, report = read_recording(p)
        assert report == {"requests": 2, "skipped": 0, "torn_tail": 0}
        assert [r.arrival_s for r in reqs] == [0.0, 0.25]  # re-based
        assert [r.tenant for r in reqs] == ["t0", "t1"]
        assert [r.tier for r in reqs] == ["interactive", "batch"]
        assert all(r.spec_chars == 512 for r in reqs)

    def test_torn_tail_discarded_foreign_lines_skipped_alone(self, tmp_path):
        """One bad byte never poisons the recording — garbage, foreign
        event types, foreign versions and a torn final line each drop
        ALONE."""
        reqs, report = read_recording(_torn_recording(tmp_path / "events.jsonl"))
        assert len(reqs) == 2  # seq 1 and 7 only
        assert report["torn_tail"] == 1
        assert report["skipped"] == 3  # garbage + bad est + bad type
        assert [r.arrival_s for r in reqs] == [0.0, 1.0]

    def test_empty_and_unarmed_recordings(self, tmp_path):
        p = tmp_path / "empty.jsonl"
        p.write_text("")
        reqs, report = read_recording(p)
        assert reqs == [] and report["requests"] == 0


@pytest.mark.chaos
class TestReplayAgainstDaemon:
    """End-to-end against the port's socket daemon on the mock engine."""

    def test_open_loop_schedule_fidelity_on_slow_server(self, monkeypatch):
        """A server that takes ~100ms per debate must NOT slow the
        arrival schedule: the open-loop generator's p99 submit lateness
        stays under 50ms."""
        real_run = driver.run_debate

        def slow_run(payload, sched, **kw):
            time.sleep(0.1)
            return real_run(payload, sched, **kw)

        monkeypatch.setattr(driver, "run_debate", slow_run)
        reqs = [
            ReplayRequest(
                arrival_s=0.025 * i, tenant="t0", tier="interactive",
                spec_chars=256,
            )
            for i in range(8)
        ]
        res = replay_once(
            reqs,
            1.0,
            knobs=ServeKnobs(max_backlog_tokens=10**6, max_queue_depth=64),
            poll_pressure=False,
        )
        m = res.metrics
        assert m["lost"] == 0 and m["shed"] == 0
        assert m["completed"] == 8
        assert m["schedule_lateness_p99_s"] < 0.05

    def test_smoke_sweep_zero_accepted_loss(self, tmp_path):
        """A small two-arm sweep completes with zero accepted-request
        loss and a bench_trend-valid payload."""
        from tools.bench_trend import validate_bench_file

        reqs = synthesize(SynthSpec(seed=0, requests=12))
        slo = SLOSpec()
        frontier = load_replay.frontier_sweep(
            reqs,
            [ServeKnobs(replicas=1), ServeKnobs(replicas=3)],
            slo,
            max_doublings=1,
            bisect_iters=0,
        )
        assert set(frontier) == {"replicas=1", "replicas=3"}
        for arm in frontier.values():
            assert arm["at_frontier"]["lost"] == 0
            assert arm["debates_per_s"] >= 0
        payload = load_replay.bench_payload(frontier, slo, "test", platform="cpu")
        out = tmp_path / "BENCH_capacity.json"
        out.write_text(json.dumps(payload), encoding="utf-8")
        row, problems = validate_bench_file(out)
        assert problems == [] and row is not None

    def test_recorded_roundtrip_byte_identical_at_1x(self, tmp_path):
        """Replay a synthetic trace with arrivals armed, dump the port's
        flight recorder, RECONSTRUCT the trace from the dump, replay at
        1× — byte-identical transcripts."""
        events = str(tmp_path / "events.jsonl")
        reqs = synthesize(SynthSpec(seed=3, requests=10))
        knobs = ServeKnobs(max_backlog_tokens=10**6, max_queue_depth=64)
        first = replay_once(
            reqs, 1.0, knobs=knobs, collect_transcripts=True,
            events_out=events, poll_pressure=False,
        )
        assert first.metrics["shed"] == 0 and first.metrics["lost"] == 0
        rebuilt, report = read_recording(events)
        assert report["requests"] == len(reqs)
        assert report["skipped"] == 0
        assert [(r.tenant, r.tier, r.spec_chars) for r in rebuilt] == [
            (r.tenant, r.tier, r.spec_chars) for r in reqs
        ]
        second = replay_once(
            rebuilt, 1.0, knobs=knobs, collect_transcripts=True,
            poll_pressure=False,
        )
        assert second.metrics["shed"] == 0 and second.metrics["lost"] == 0
        assert first.transcripts == second.transcripts
        assert all(t is not None for t in first.transcripts)

    def test_slo_breach_detection(self):
        m = {"lost": 0, "ttft_p95_s": 0.1, "shed_fraction": 0.0}
        assert slo_breaches(m, SLOSpec()) == []
        assert slo_breaches({**m, "lost": 1}, SLOSpec())
        assert slo_breaches({**m, "ttft_p95_s": 9.0}, SLOSpec())
        assert slo_breaches({**m, "shed_fraction": 0.5}, SLOSpec())


# The port daemon's recording of a replay, made once for the rendering
# cases (see ``_recording``).
_RECORDING: dict = {}
_RECORDED_REQS = [
    ReplayRequest(arrival_s=0.0, tenant="t0", tier="interactive", spec_chars=128),
    ReplayRequest(arrival_s=0.05, tenant="t1", tier="interactive", spec_chars=256),
    ReplayRequest(arrival_s=0.15, tenant="t0", tier="batch", spec_chars=128),
]


def _recording(tmp_path_factory) -> tuple[list[dict], dict]:
    """``_RECORDED_REQS`` replayed at 1× through the port's daemon on the
    mock pool with arrivals armed: the dump's events (validated against
    the event vocabulary on load) and the replay's metrics."""
    if not _RECORDING:
        from tools.obs_dump import load_events

        events = str(tmp_path_factory.mktemp("recording") / "events.jsonl")
        res = replay_once(
            _RECORDED_REQS, 1.0,
            knobs=ServeKnobs(max_backlog_tokens=10**6, max_queue_depth=64),
            events_out=events, poll_pressure=False,
        )
        loaded, problems = load_events(events)
        assert problems == [], problems[:3]
        _RECORDING.update(events=loaded, metrics=res.metrics)
    return _RECORDING["events"], _RECORDING["metrics"]


@pytest.mark.chaos
def test_replay_serves_a_tpu_pool_on_a_cpu_engine(tmp_path, monkeypatch):
    """``models=``: the same canonical trace against two ``tpu://`` ids (a
    paged tiny alias, f32) served by a CPU ``GpuEngine`` through the
    port's daemon: every debate completes, and the recording it leaves
    reconstructs the trace (a two-id pool keeps the estimate invertible)."""
    from adversarial_spec_tpu_torch.engine import dispatch, registry
    from adversarial_spec_tpu_torch.engine.gpu import GpuEngine

    path = tmp_path / "tpu-registry.json"
    monkeypatch.setattr(registry, "REGISTRY_PATH", path)
    registry.save_registry_entry(
        registry.ModelSpec(
            alias="paged-tiny", family="llama", size="tiny", dtype="float32",
            kv="paged",
        ),
        path,
    )
    dispatch.install_engine("tpu://paged-tiny", GpuEngine(device="cpu"))
    events = str(tmp_path / "events.jsonl")
    res = replay_once(
        _RECORDED_REQS[:2], 1.0,
        knobs=ServeKnobs(max_backlog_tokens=10**6, max_queue_depth=64),
        collect_transcripts=True, events_out=events, poll_pressure=False,
        models=TPU_POOL, collect_timeout_s=300.0,
    )
    m = res.metrics
    assert (m["offered"], m["accepted"], m["completed"], m["lost"]) == (2, 2, 2, 0)
    assert all(t is not None and len(t) == 2 for t in res.transcripts)
    assert m["ttft_p50_s"] > 0 and m["round_p99_s"] >= m["round_p50_s"] > 0
    rebuilt, report = read_recording(events)
    assert report == {"requests": 2, "skipped": 0, "torn_tail": 0}
    assert [(r.tenant, r.tier, r.spec_chars) for r in rebuilt] == [
        (r.tenant, r.tier, r.spec_chars) for r in _RECORDED_REQS[:2]
    ]


class TestArrivalRendering:
    """The obs_dump/trace_view renderings of the arrival offsets (@t) and
    the per-tenant rate summary, on a recording the port's daemon wrote
    (its events validate against the shared vocabulary on load)."""

    def test_obs_dump_summary_has_tenant_rate_line(self, tmp_path_factory):
        from tools.obs_dump import summarize

        events, metrics = _recording(tmp_path_factory)
        assert metrics["completed"] == 3 and metrics["lost"] == 0
        arrivals = [
            e for e in events
            if e["type"] == "serve" and e["op"] in ("accepted", "shed")
        ]
        assert len(arrivals) == 3 and all(e["arrival_s"] > 0 for e in arrivals)
        span = max(e["arrival_s"] for e in arrivals) - min(
            e["arrival_s"] for e in arrivals
        )
        text = summarize(events)
        assert f"arrivals: 3 over {span:.3f}s" in text
        assert f"t0={2 / span:.1f}/s" in text and f"t1={1 / span:.1f}/s" in text
        # Unarmed dumps (arrival 0) keep the old summary byte for byte.
        unarmed = [{**e, "arrival_s": 0.0} if "arrival_s" in e else e for e in events]
        assert "arrivals:" not in summarize(unarmed)

    def test_obs_dump_request_log_leads_with_arrival_column(self, tmp_path_factory):
        from tools.obs_dump import request_log

        events, _ = _recording(tmp_path_factory)
        reqs = [e for e in events if e["type"] == "request"]
        queued = [e for e in reqs if e["state"] == "queued"]
        assert len(queued) == 6 and all(e["arrival_s"] > 0 for e in queued)
        lines = request_log(events).splitlines()
        assert len(lines) == len(reqs)
        for e, line in zip(reqs, lines):
            if e["arrival_s"] > 0:
                assert line.startswith(f"@{e['arrival_s']:8.3f}s ")
            else:  # non-edge rows keep alignment without an offset
                assert line.startswith(" " * 11 + "seq")
        unarmed = [{**e, "arrival_s": 0.0} for e in reqs]
        assert "@" not in request_log(unarmed)

    def test_obs_dump_timeline_serve_rows_show_offset(self, tmp_path_factory):
        from tools.obs_dump import occupancy_timeline

        events, _ = _recording(tmp_path_factory)
        assert any(e["type"] == "step" for e in events)
        text = occupancy_timeline(events)
        for e in events:
            if e["type"] == "serve" and e["arrival_s"] > 0:
                assert f"@{e['arrival_s']:.3f}s" in text

    def test_trace_view_waterfall_head_shows_arrival(self, tmp_path_factory):
        from tools.trace_view import collect_requests, render_waterfall

        events, _ = _recording(tmp_path_factory)
        recs = collect_requests(events)
        queued = {
            e["req_id"]: e["arrival_s"] for e in events
            if e["type"] == "request" and e["state"] == "queued"
        }
        timed = [r for r in recs.values() if r["req_id"] in queued]
        assert timed, "no request span carried a queued arrival"
        for r in timed:
            assert r["arrival_s"] == queued[r["req_id"]]
        text = render_waterfall(recs)
        assert all(f"@{r['arrival_s']:.3f}s" in text for r in timed)


class TestParityWithReference:
    """``tools/load_replay_torch.py`` against ``tools/load_replay.py`` on
    the same inputs."""

    def test_synthesize_equal_for_the_same_spec(self):
        for spec in (SynthSpec(), SynthSpec(seed=3, requests=200, tenants=7),
                     SynthSpec(seed=11, batch_fraction=0.9, spec_sigma=1.5)):
            got = [dataclasses.astuple(r) for r in synthesize(spec)]
            want = [
                dataclasses.astuple(r)
                for r in ref.synthesize(ref.SynthSpec(**dataclasses.asdict(spec)))
            ]
            assert got == want

    def test_estimates_equal_over_every_canonical_shape(self):
        assert load_replay.MODELS == ref.MODELS
        assert load_replay.TIER_MAX_NEW == ref.TIER_MAX_NEW
        for tier in ("interactive", "batch"):
            for chars in range(ref.MIN_SPEC_CHARS, ref.MAX_SPEC_CHARS + 1, 4):
                assert canonical_spec(chars) == ref.canonical_spec(chars)
                est = ref.est_tokens_for(chars, tier)
                assert est_tokens_for(chars, tier) == est
                assert est_tokens_for(chars, tier, models=TPU_POOL) == est
                assert spec_chars_from_est(est, tier) == ref.spec_chars_from_est(est, tier)
                assert spec_chars_from_est(est, tier, models=TPU_POOL) == chars
        for est in (3, 10, 7, 10**6, 900, 1001, 2 * 1024):
            for tier in ("interactive", "batch", "premium"):
                assert spec_chars_from_est(est, tier) == ref.spec_chars_from_est(est, tier)

    def test_read_recording_equal_on_a_torn_foreign_file(self, tmp_path):
        path = _torn_recording(tmp_path / "events.jsonl")
        got, got_report = read_recording(path)
        want, want_report = ref.read_recording(path)
        assert got_report == want_report
        assert [dataclasses.astuple(r) for r in got] == [
            dataclasses.astuple(r) for r in want
        ]
        assert tenant_rates(got) == ref.tenant_rates(want)

    def test_replay_transcripts_equal_at_1x_on_the_mock_pool(self):
        reqs = synthesize(SynthSpec(seed=5, requests=8))
        knobs = dict(max_backlog_tokens=10**6, max_queue_depth=64)
        got = replay_once(
            reqs, 1.0, knobs=ServeKnobs(**knobs), collect_transcripts=True,
            poll_pressure=False,
        )
        want = ref.replay_once(
            [ref.ReplayRequest(*dataclasses.astuple(r)) for r in reqs], 1.0,
            knobs=ref.ServeKnobs(**knobs), collect_transcripts=True,
            poll_pressure=False,
        )
        assert got.transcripts == want.transcripts
        assert all(t is not None for t in got.transcripts)
        for key in ("arm", "rate_multiplier", "offered", "accepted", "completed",
                    "shed", "lost", "shed_reasons", "shed_fraction"):
            assert got.metrics[key] == want.metrics[key], key
        assert set(got.metrics) == set(want.metrics)

    def test_slo_breaches_and_bench_payload_equal(self, tmp_path):
        metrics = [
            {"lost": 0, "ttft_p95_s": 0.1, "shed_fraction": 0.0},
            {"lost": 2, "ttft_p95_s": 0.7, "shed_fraction": 0.3},
            {"lost": 0, "ttft_p95_s": 0.5, "shed_fraction": 0.02},
        ]
        for m in metrics:
            for slo in ((0.5, 0.02), (0.05, 0.0)):
                assert slo_breaches(m, SLOSpec(*slo)) == ref.slo_breaches(
                    m, ref.SLOSpec(*slo)
                )
        frontier = {
            "replicas=1": {"k_at_slo": 2.0, "debates_per_s": 12.5, "breached": True,
                           "probes": 4, "at_frontier": metrics[0]},
            "replicas=3": {"k_at_slo": 8.0, "debates_per_s": 40.0, "breached": False,
                           "probes": 5, "at_frontier": metrics[2]},
        }
        base = tmp_path / "capacity.json"
        base.write_text(json.dumps({"value": 10.0}))
        for baseline in (None, base, tmp_path / "missing.json"):
            got = load_replay.bench_payload(
                frontier, SLOSpec(), "trace", baseline_path=baseline
            )
            want = ref.bench_payload(
                frontier, ref.SLOSpec(), "trace", baseline_path=baseline
            )
            assert got == want
