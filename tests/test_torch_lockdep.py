"""The port's lockdep sanitizer (``adversarial_spec_tpu_torch/resilience/
lockdep.py``) and its static twin (GL-LOCK, tools/graftlint/rules/
locking.py): the reference's ``tests/test_lockdep.py`` on the port.

The runtime side is pinned end to end: inversion detection naming both
stacks, RLock re-entry staying edge-free, ``threading.Condition`` over a
tracked lock, the hold/wait histograms landing in the port's obs
snapshots, and the disabled path handing back raw primitives with zero
bookkeeping. The static side gets a LIVE-FIRE pin on the port's own
``serve/sched.py``: linted untouched (clean), then with a real lock
acquire stripped (GL-LOCK-GUARD must fire on the now-unguarded reads).
The deadlock hammer runs both chaos runners' drills and holds the port's
seeded violation to the reference's.
"""

from __future__ import annotations

import threading
from pathlib import Path

import pytest

from tests import torch_cli_support as sup

from adversarial_spec_tpu_torch import obs
from adversarial_spec_tpu_torch.resilience import lockdep

REPO = Path(__file__).resolve().parents[1]
SCHED_PATH = REPO / "adversarial_spec_tpu_torch" / "serve" / "sched.py"
SCHED_MODULE = "adversarial_spec_tpu_torch.serve.sched"


@pytest.fixture(autouse=True)
def _armed(tmp_path, monkeypatch):
    """Every test here runs on isolated port state with the sanitizer
    armed and a clean graph."""
    gen = sup.isolate_port(tmp_path, monkeypatch)
    next(gen)
    lockdep.configure(enabled=True, raise_on_violation=False)
    lockdep.reset()
    yield
    lockdep.reset()
    lockdep.configure(enabled=lockdep.env_enabled(), raise_on_violation=False)
    next(gen, None)


class TestInversionDetection:
    def test_two_thread_inversion_names_both_stacks(self):
        """A->B then B->A across two (sequential) threads is THE
        violation; the message must carry the acquiring stack and the
        first-recorded opposite-direction stack."""
        a = lockdep.TrackedLock("t.A", metrics=False)
        b = lockdep.TrackedLock("t.B", metrics=False)

        def forward():
            with a:
                with b:
                    pass

        def backward():
            with b:
                with a:
                    pass

        for fn in (forward, backward):
            t = threading.Thread(target=fn)
            t.start()
            t.join(timeout=10.0)
        got = lockdep.violations()
        assert len(got) == 1
        v = got[0]
        assert v.edge == ("t.B", "t.A")
        msg = str(v)
        assert "this acquisition" in msg
        assert "opposite edge" in msg
        assert "t.A" in msg and "t.B" in msg

    def test_raise_mode_raises_and_releases_inner_lock(self):
        """Raise mode: the violating acquire raises AND leaves the
        just-acquired inner lock released so the process is not wedged
        by its own sanitizer."""
        lockdep.configure(raise_on_violation=True)
        a = lockdep.TrackedLock("r.A", metrics=False)
        b = lockdep.TrackedLock("r.B", metrics=False)
        with a:
            with b:
                pass
        with b:
            with pytest.raises(lockdep.LockOrderViolation):
                a.acquire()
        assert not a.locked()
        assert not b.locked()

    def test_same_name_locks_share_a_graph_node(self):
        """Two instances named identically (every ``ServeScheduler``
        instance's ``_lock``) are one node: nesting instance 1 under
        instance 2 records no self-edge and no violation."""
        a1 = lockdep.TrackedLock("s.L", metrics=False)
        a2 = lockdep.TrackedLock("s.L", metrics=False)
        with a1:
            with a2:
                pass
        assert lockdep.violations() == []
        assert "s.L" not in lockdep.order_edges().get("s.L", ())


class TestReentrancy:
    def test_rlock_reentry_records_no_edge_and_no_violation(self):
        r = lockdep.TrackedRLock("re.R", metrics=False)
        with r:
            with r:
                with r:
                    pass
        assert lockdep.violations() == []
        assert lockdep.order_edges() == {}
        assert lockdep.held_names() == ()

    def test_rlock_release_order_unwinds_cleanly(self):
        r = lockdep.TrackedRLock("re.R2", metrics=False)
        r.acquire()
        r.acquire()
        assert lockdep.held_names() == ("re.R2",)
        r.release()
        assert lockdep.held_names() == ("re.R2",)
        r.release()
        assert lockdep.held_names() == ()


class TestConditionIntegration:
    def test_condition_over_tracked_lock_wait_notify(self):
        """``threading.Condition(tracked)`` is the ServeScheduler's
        exact shape: wait releases and reacquires through the wrapper
        without corrupting the held stack or recording junk edges."""
        lk = lockdep.make_lock("cond.L", metrics=False)
        assert isinstance(lk, lockdep.TrackedLock)
        cond = threading.Condition(lk)
        fired = []

        def waiter():
            with cond:
                while not fired:
                    if not cond.wait(timeout=5.0):
                        break

        t = threading.Thread(target=waiter)
        t.start()
        with cond:
            fired.append(1)
            cond.notify_all()
        t.join(timeout=10.0)
        assert not t.is_alive()
        assert lockdep.violations() == []
        assert lockdep.held_names() == ()


class TestMetrics:
    def test_hold_and_wait_histograms_land_in_obs_snapshot(self):
        obs.configure(enabled=True)
        lk = lockdep.make_lock("MetricsDemo._lock")
        with lk:
            pass
        snap = obs.metrics.snapshot()
        hold = snap['advspec_lock_hold_seconds{lock="MetricsDemo._lock"}']
        wait = snap['advspec_lock_wait_seconds{lock="MetricsDemo._lock"}']
        assert hold["count"] == 1
        assert wait["count"] == 1

    def test_disabled_obs_records_no_lock_metrics(self):
        """The observe gate is per-observe, not per-handle: flipping
        obs off must stop NEW observations even on a warm lock."""
        obs.configure(enabled=True)
        lk = lockdep.make_lock("GateDemo._lock")
        with lk:
            pass
        obs.reset_stats()
        obs.configure(enabled=False)
        with lk:
            pass
        snap = obs.metrics.snapshot()
        key = 'advspec_lock_hold_seconds{lock="GateDemo._lock"}'
        assert snap.get(key, {"count": 0})["count"] == 0
        obs.configure(enabled=True)


class TestDisabledPassthrough:
    def test_make_lock_disabled_returns_raw_primitives(self):
        lockdep.configure(enabled=False)
        lk = lockdep.make_lock("off.L")
        rl = lockdep.make_rlock("off.R")
        assert type(lk) is type(threading.Lock())
        assert type(rl) is type(threading.RLock())

    def test_disabled_locks_do_no_bookkeeping(self):
        lockdep.configure(enabled=False)
        a = lockdep.make_lock("off.A")
        b = lockdep.make_lock("off.B")
        with a:
            with b:
                pass
        with b:
            with a:  # a real inversion — invisible when disabled
                pass
        assert lockdep.order_edges() == {}
        assert lockdep.violations() == []


class TestSelfTest:
    def test_self_test_passes_and_leaves_no_state(self):
        before_edges = lockdep.order_edges()
        assert lockdep.self_test() == []
        assert lockdep.order_edges() == before_edges
        assert lockdep.violations() == []


class TestLiveFireGuardRule:
    """GL-LOCK-GUARD against the port's REAL scheduler source (the rule
    configured with the port's module names: the repo's settings name
    the reference package's)."""

    def _lint(self, source: str):
        from tools.graftlint.config import GraftlintConfig
        from tools.graftlint.core import lint_sources
        import tools.graftlint.rules  # noqa: F401 - registers rules

        guards = [
            g.replace("adversarial_spec_tpu.", "adversarial_spec_tpu_torch.", 1)
            for g in GraftlintConfig().lock_guards
            if g.startswith("adversarial_spec_tpu.serve.sched:")
        ]
        assert guards, "the scheduler's lock guard left the default config"
        cfg = GraftlintConfig(
            package="adversarial_spec_tpu_torch",
            lock_guards=guards,
            lock_thread_entries=[
                f"{SCHED_MODULE}:ServeScheduler.pressure_snapshot",
                f"{SCHED_MODULE}:ServeScheduler.try_admit",
            ],
        )
        return lint_sources(
            {"adversarial_spec_tpu_torch/serve/sched.py": source},
            rules=["GL-LOCK-GUARD"],
            cfg=cfg,
        )

    def test_unmodified_sched_source_is_clean(self):
        src = SCHED_PATH.read_text(encoding="utf-8")
        assert self._lint(src) == []

    def test_stripping_a_real_acquire_is_a_finding(self):
        """Replace pressure_snapshot's ``with self._lock:`` with
        ``if True:`` (same indentation, no acquire): the guarded reads
        inside become findings on a thread-reachable path."""
        src = SCHED_PATH.read_text(encoding="utf-8")
        needle = "        with self._lock:\n            mix:"
        assert needle in src, "pressure_snapshot shape changed"
        broken = src.replace(needle, "        if True:\n            mix:", 1)
        findings = self._lint(broken)
        assert findings, "stripped acquire produced no GL-LOCK-GUARD"
        assert all(f.rule == "GL-LOCK-GUARD" for f in findings)
        assert any("pressure_snapshot" in f.message for f in findings)


@pytest.mark.chaos
class TestDeadlockHammer:
    def test_deadlock_hammer_drill_is_green(self):
        """The port's drill over the port's scheduler, fleet and
        autoscaler, beside the reference's over its own: both storms
        record cross-lock edges with zero violations, and both seeded
        inversions give exactly one violation on the same edge."""
        from adversarial_spec_tpu.resilience import lockdep as ref_lockdep
        from tools import chaos_run, chaos_run_torch

        failures, payload = chaos_run_torch.run_deadlock_hammer(verbose=False)
        assert failures == []
        assert payload["edges"], "storm recorded no cross-lock edges"
        assert payload["seeded_violations"] == 1
        try:
            ref_failures, ref_payload = chaos_run.run_deadlock_hammer(verbose=False)
        finally:
            ref_lockdep.reset()
        assert ref_failures == []
        assert ref_payload["edges"]
        assert payload["seeded_violations"] == ref_payload["seeded_violations"]
        # Every lock of an edge the port's storm recorded is one the
        # static hierarchy declares (the port's locks carry its names).
        from tools.graftlint.config import GraftlintConfig

        declared = {g.name for g in GraftlintConfig().parsed_lock_guards()}
        assert {n for e in payload["edges"] for n in e.split("->")} <= declared
