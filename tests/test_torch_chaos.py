"""The port's chaos drills (``tools/chaos_run_torch.py``) and the
reference's resilience fuzz on the port.

- The drills against the reference runner's (``tools/chaos_run.py``) on
  the CPU: ``--crash`` prints the reference drill's lines; ``--overload``
  and ``--drain`` hold the reference's asserts; ``--scale-storm``'s
  membership history moves the reference ring's keys; the weight-swap
  drill on a CPU ``GpuEngine`` gives the reference drill's payload and the
  same autodump event kinds; without a card its flag fails with the "no
  CUDA device" error; the runner's marked suite and ``--sweep`` name the
  port's test files only.
- ``TestSchedulerChaosFuzz`` (``tests/test_fuzz.py``'s) on the port's
  ``ContinuousBatcher`` and ``resilience/injector.py``: random faults
  mid-drain never lose a request, at seeds 0-2 or the seed
  ``ADVSPEC_CHAOS_FUZZ_SEED`` names (the runner's ``--sweep``).
- The crash-seam fuzz (``tests/test_durability.py``'s) on the port's
  ``run_round`` and ``RoundJournal``, held to the reference's durable
  records seed for seed.
"""

from __future__ import annotations

import json
import os
import random
import time
import types

import pytest

from tests import torch_cli_support as sup

from adversarial_spec_tpu_torch import obs
from adversarial_spec_tpu_torch.engine import spec as spec_mod
from tools import chaos_run, chaos_run_torch

SPEC = "# Cache Service\n\nA read-through cache with bounded staleness."


@pytest.fixture(autouse=True)
def _port_state(tmp_path, monkeypatch):
    yield from sup.isolate_port(tmp_path, monkeypatch)


@pytest.fixture
def spec_off(monkeypatch):
    """Speculation off in both packages (as the reference's fuzz and
    durability modules run), restored after."""
    from adversarial_spec_tpu.engine import spec as ref_spec

    prev = ref_spec.config()
    prev = (prev.enabled, prev.gamma)
    monkeypatch.setenv("ADVSPEC_SPECULATIVE", "0")
    ref_spec.configure(enabled=False)
    spec_mod.configure(enabled=False)
    yield
    ref_spec.configure(enabled=prev[0], gamma=prev[1])


@pytest.fixture
def no_card():
    """A machine without a CUDA card (decided here, not at import)."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the drill would run on it")


@pytest.mark.chaos
class TestDrills:
    def test_crash_drill_prints_the_reference_drills_lines(self, capsys):
        """SIGKILL mid-journal, resume: exit 0 and, line for line, what
        the reference drill prints (2 opponents served from the journal,
        2 re-issued, transcripts byte-identical)."""
        assert chaos_run_torch.crash_drill(verbose=True) == 0
        got = capsys.readouterr()
        assert chaos_run.crash_drill(verbose=True) == 0
        want = capsys.readouterr()
        assert got.out.splitlines() == want.out.splitlines()
        assert "resume served 2 opponent(s) from the journal, re-issued 2" in got.out
        assert got.err == want.err == ""

    def test_overload_storm_holds_the_reference_asserts(self):
        failures, payload = chaos_run_torch.run_overload(verbose=False)
        assert failures == []
        assert payload["zero_accepted_lost"] is True
        assert payload["invariants_clean"] is True
        assert payload["accepted"]["interactive"] == 6
        assert payload["shed"]["batch"] > 0 and payload["shed"]["interactive"] == 0
        assert payload["brownout_entries"] >= 1
        assert payload["shed_reasons"].get("brownout", 0) >= 1
        assert payload["interactive_ttft_p99_s"] <= payload["ttft_slo_s"]
        assert payload["submitted"] == sum(payload["accepted"].values()) + sum(
            payload["shed"].values()
        )

    def test_drain_drill_holds_the_reference_asserts(self):
        """A port daemon subprocess SIGTERMed mid-burst: every accepted
        debate resolves, exit 0 with a clean drain report, drained
        sessions resume from their journals on a fresh daemon."""
        failures, payload = chaos_run_torch.run_drain_drill(verbose=False)
        assert failures == []
        assert payload["sigterm_rc"] == 0
        assert payload["drain_report_clean"] is True
        assert payload["zero_accepted_lost"] is True
        assert sum(payload["outcomes"].values()) == payload["debates"]
        assert payload["resumable_debates"] == payload["outcomes"]["drained"]

    def test_scale_storm_moves_the_reference_rings_keys(self, monkeypatch):
        """The elastic storm on the port's daemon and fleet: the drill's
        verdict is clean, its membership history starts at the floor and
        grows, and every membership change moves exactly the fraction of
        keys the reference's ring moves for the same memberships."""
        from adversarial_spec_tpu_torch.serve import driver

        # A warm process serves a mock debate in about a millisecond, so
        # the 18-debate step never backs up: each debate holds its
        # admission for 0.2 s here, as a loaded server would.
        real_run = driver.run_debate

        def slow_run(payload, sched, **kw):
            time.sleep(0.2)
            return real_run(payload, sched, **kw)

        monkeypatch.setattr(driver, "run_debate", slow_run)
        changes: list = []
        real = chaos_run_torch._ring_movement

        def recording(before, after):
            frac = real(before, after)
            changes.append((list(before), list(after), frac))
            return frac

        monkeypatch.setattr(chaos_run_torch, "_ring_movement", recording)
        failures, payload = chaos_run_torch.run_scale_storm(verbose=False)
        assert failures == []
        assert payload["scale_outs"] >= 1 and payload["scale_ins"] >= 1
        assert payload["memberships"][0] == 1 and max(payload["memberships"]) > 1
        assert payload["duplicated_completions"] == 0
        assert [round(f, 4) for _, _, f in changes] == payload["key_movement_per_change"]
        assert changes and changes[0][0] == ["r0"]
        for before, after, frac in changes:
            assert frac == chaos_run._ring_movement(before, after)

    def test_weight_swap_on_a_cpu_engine_matches_the_reference(
        self, tmp_path, monkeypatch, spec_off
    ):
        """The weight-swap drill with ``device="cpu"`` (the port's plain
        PyTorch paths) beside the reference's: the same payload (victim,
        one swap fault, one promotion, the retry byte-identical to the
        pre-fault round, the autodump's event count) and the same event
        kinds in the autodump."""
        from adversarial_spec_tpu_torch.engine import weightres

        failures, payload = chaos_run_torch.run_weight_swap(verbose=False, device="cpu")
        assert failures == []
        assert payload["retry_graph_captures"] == 0  # the CPU runs no graphs
        assert payload["retry_promote_s"] > 0
        # The drill hands back the knobs it set: a later daemon must not
        # dump its events into the drill's removed directory.
        assert obs.config().events_out is None
        assert spec_mod.config().enabled is False  # as ``spec_off`` set it
        assert weightres.config().host_mb == weightres.DEFAULT_HOST_MB
        assert "ADVSPEC_HBM_BUDGET_BYTES" not in os.environ
        ref_dir = tmp_path / "ref"
        ref_dir.mkdir()
        monkeypatch.setattr(
            chaos_run, "tempfile",
            types.SimpleNamespace(mkdtemp=lambda prefix="": str(ref_dir)),
        )
        ref_failures, ref_payload = chaos_run.run_weight_swap(verbose=False)
        assert ref_failures == []
        assert {k: payload[k] for k in ref_payload} == ref_payload
        dump = (ref_dir / "events.fault.jsonl").read_text().splitlines()
        assert payload["autodump_kinds"] == chaos_run_torch.event_kinds(
            [json.loads(ln) for ln in dump if ln]
        )

    def test_weight_swap_flag_needs_a_card(self, no_card, capsys):
        failures, payload = chaos_run_torch.run_weight_swap(verbose=False)
        assert payload == {}
        assert len(failures) == 1 and "no CUDA device" in failures[0]
        assert chaos_run_torch.main(["--weight-swap"]) == 1
        assert "no CUDA device" in capsys.readouterr().err

    def test_marked_suite_and_sweep_run_the_ports_tests(self, monkeypatch):
        """The default run is ``pytest -m chaos`` over the port's test
        files; ``--sweep N`` then reruns the port's scheduler fuzz at the
        seeds the reference's sweep takes."""
        calls: dict = {"port": [], "ref": []}

        def fake(kind):
            def run(extra, env, files=None):
                calls[kind].append((extra, env, files))
                return 0
            return run

        monkeypatch.setattr(chaos_run_torch, "_pytest", fake("port"))
        monkeypatch.setattr(chaos_run, "_pytest", fake("ref"))
        assert chaos_run_torch.main(["--sweep", "2", "--", "-x"]) == 0
        assert chaos_run.main(["--sweep", "2", "--", "-x"]) == 0
        assert [c[1] for c in calls["port"]] == [c[1] for c in calls["ref"]]
        assert calls["port"][0] == (["-x"], {}, None)
        assert [c[2] for c in calls["port"][1:]] == [["tests/test_torch_chaos.py"]] * 2
        files = chaos_run_torch.port_test_files()
        assert files and all(f.startswith("tests/test_torch_") for f in files)
        assert "tests/test_torch_chaos.py" in files


@pytest.mark.chaos
class TestSchedulerChaosFuzz:
    """Random faults injected mid-drain (the port's injector): NO request
    is ever lost — every submitted req_id gets exactly one SchedResult
    (clean, partial + fault metadata, or retried to completion) and every
    evicted slot's pages return to the pool."""

    def test_no_request_lost_under_random_faults(self, spec_off):
        import torch

        from adversarial_spec_tpu_torch.engine.scheduler import (
            ContinuousBatcher,
            SchedRequest,
        )
        from adversarial_spec_tpu_torch.models import transformer as T
        from adversarial_spec_tpu_torch.models.config import get_config
        from adversarial_spec_tpu_torch.resilience import injector as injector_mod
        from adversarial_spec_tpu_torch.resilience.faults import FaultKind
        from adversarial_spec_tpu_torch.resilience.injector import (
            FaultInjector,
            FaultRule,
        )

        cfg = get_config("llama", "tiny")
        params = T.init_params(cfg, device=torch.device("cpu"), dtype=torch.float32)
        kinds = list(FaultKind)
        seams = ["scheduler_chunk", "kv_alloc"]
        # Fixed seeds keep tier-1 deterministic; tools/chaos_run_torch.py
        # --sweep widens coverage by appending extra seeds via env.
        seeds = [0, 1, 2]
        extra = os.environ.get("ADVSPEC_CHAOS_FUZZ_SEED")
        if extra is not None:
            seeds = [int(extra)]
        # A ring far below one drain's event volume: chaos can never
        # grow the flight recorder past its bound, only age events out.
        ring_size = 32
        obs.configure(enabled=True, recorder_size=ring_size)
        for seed in seeds:
            rng = random.Random(seed)
            rules = [
                FaultRule(
                    kind=rng.choice(kinds),
                    seam=rng.choice(seams),
                    p=0.3,
                    slot=rng.choice([None, 0, 1]),
                )
                for _ in range(rng.randrange(1, 3))
            ]
            injector_mod.install(FaultInjector(rules, seed=seed))
            b = ContinuousBatcher(params, cfg, max_batch=2, max_new_cap=16, chunk=4)
            total_pages = b.allocator.free_pages
            n_req = rng.randrange(3, 6)
            for i in range(n_req):
                b.submit(
                    SchedRequest(
                        req_id=i,
                        prompt_ids=[1 + (i * 7) % 64, 5, 9][: 1 + i % 3],
                        max_new_tokens=4 + (i * 3) % 12,
                    )
                )
            results = b.run_all()
            injector_mod.reset()
            assert len(obs.recorder) <= ring_size, f"seed {seed}"
            assert (
                len(obs.recorder) + obs.recorder.dropped == obs.recorder.seq
            ), f"seed {seed}"
            assert sorted(r.req_id for r in results) == list(range(n_req)), (
                f"seed {seed}: lost/duplicated requests "
                f"{[r.req_id for r in results]} with rules {rules}"
            )
            for r in results:
                assert (r.error is None) == (r.fault_kind is None)
                assert 0 <= r.n_generated <= 16
                assert len(r.tokens) == r.n_generated
            assert b.allocator.free_pages == total_pages, f"seed {seed}"


@pytest.mark.chaos
def test_crash_seam_fuzz_no_response_lost(spec_off):
    """Random faults at the journal-append seam mid-round: every opponent
    still resolves (no response lost), whatever subset of records became
    durable is readable and replayable, and it is the subset the
    reference's journal keeps under the same seeded faults."""
    from adversarial_spec_tpu.debate.core import RoundConfig as RefConfig
    from adversarial_spec_tpu.debate.core import run_round as ref_run_round
    from adversarial_spec_tpu.debate.journal import RoundJournal as RefJournal
    from adversarial_spec_tpu.resilience import injector as ref_injector
    from adversarial_spec_tpu.resilience.faults import FaultKind as RefKind
    from adversarial_spec_tpu.resilience.injector import FaultInjector as RefInjector
    from adversarial_spec_tpu.resilience.injector import FaultRule as RefRule
    from adversarial_spec_tpu_torch.debate.core import RoundConfig, run_round
    from adversarial_spec_tpu_torch.debate.journal import (
        RoundJournal,
        completion_from_record,
    )
    from adversarial_spec_tpu_torch.resilience import injector as injector_mod
    from adversarial_spec_tpu_torch.resilience.faults import FaultKind
    from adversarial_spec_tpu_torch.resilience.injector import FaultInjector, FaultRule

    models = ["mock://critic?f=1", "mock://critic?f=2", "mock://agree"]
    for seed in (0, 1, 2):
        rng = random.Random(seed)
        kind = rng.choice(list(FaultKind))
        injector_mod.install(
            FaultInjector([FaultRule(kind=kind, seam="crash", p=0.5)], seed=seed)
        )
        try:
            result = run_round(
                SPEC, models, cfg=RoundConfig(journal=RoundJournal(f"fz{seed}"))
            )
        finally:
            injector_mod.install(None)
        assert len(result.responses) == len(models), f"seed {seed}"
        assert all(r.ok for r in result.responses), f"seed {seed}"
        served = RoundJournal(f"fz{seed}").replay(1, SPEC, models)
        for i, rec in served.items():
            comp, _ = completion_from_record(rec)
            assert comp.text == result.responses[i].critique
        # The reference's round under the same seeded fault.
        ref_kind = RefKind(kind.value)
        ref_injector.install(
            RefInjector([RefRule(kind=ref_kind, seam="crash", p=0.5)], seed=seed)
        )
        try:
            ref_result = ref_run_round(
                SPEC, models, cfg=RefConfig(journal=RefJournal(f"ref-fz{seed}"))
            )
        finally:
            ref_injector.install(None)
        ref_served = RefJournal(f"ref-fz{seed}").replay(1, SPEC, models)
        assert sorted(served) == sorted(ref_served), f"seed {seed}"
        assert [r.critique for r in result.responses] == [
            r.critique for r in ref_result.responses
        ], f"seed {seed}"
