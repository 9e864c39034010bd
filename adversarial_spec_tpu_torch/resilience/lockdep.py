"""Runtime lock-order sanitizer (lockdep) — the dynamic complement of
graftlint's GL-LOCK family (tools/graftlint/rules/locking.py).

The PyTorch port's copy of ``adversarial_spec_tpu/resilience/lockdep.py``.

The static rules prove lock discipline over the call graph they can
see; callbacks, consumer seams, and injected providers are exactly the
edges a conservative analysis cannot follow. ``TrackedLock`` /
``TrackedRLock`` are drop-in wrappers that maintain one per-process
acquisition-order graph keyed by lock *name* (the lock class, in
kernel-lockdep terms — every ``ServeScheduler._lock`` instance feeds
the same node): the FIRST time thread T acquires B while holding A, an
A→B edge is recorded together with the acquiring stack, and if B
already reaches A in the graph the inversion is reported immediately —
no actual deadlock (two threads parked forever) has to occur for the
cycle to be caught.

Enablement: ``make_lock``/``make_rlock`` return RAW ``threading``
primitives when lockdep is off (``ADVSPEC_LOCKDEP`` unset/0 and no
``configure(enabled=True)``) — production pays zero bookkeeping, not
even a wrapper attribute load. Tier-1's conftest and every chaos drill
force it ON, so the whole suite runs as a deadlock detector.

On violation: raise ``LockOrderViolation`` (``raise_on_violation``) or
record it (default — the drills and the suite-wide teardown assert
inspect ``violations()``), emit a ``LockEvent`` through the flight
recorder, and trigger an auto-dump so the JSONL keeps both stacks.

Telemetry: per-lock hold/wait wall histograms
(``advspec_lock_hold_seconds{lock}`` / ``advspec_lock_wait_seconds``)
through ``obs.hot`` — contention shows up as a fat wait column long
before it becomes a stall. The obs subsystem's own locks are created
with ``metrics=False``: observing a histogram takes the metrics
registry lock, so the registry lock must never observe itself (a
thread-local re-entrancy latch guards the same hazard dynamically).
"""

from __future__ import annotations

import os
import threading
import time
import traceback


class LockOrderViolation(RuntimeError):
    """A lock-order inversion: acquiring ``edge[1]`` while holding
    ``edge[0]`` closes a cycle in the acquisition-order graph. The
    message names both stacks — the acquiring one and the first stack
    that recorded the opposite-direction path."""

    def __init__(self, message: str, edge: tuple[str, str]):
        super().__init__(message)
        self.edge = edge


# -- process-wide state -----------------------------------------------------

# Raw (untracked) lock: guards the graph/violation ledgers below. It is
# only ever acquired with the re-entrancy latch set, so tracked-lock
# bookkeeping can never recurse into it.
_meta = threading.Lock()
_edges: dict[str, set[str]] = {}  # A -> {B}: B was acquired holding A
_edge_stacks: dict[tuple[str, str], str] = {}  # first-observed stack
_edge_sites: dict[tuple[str, str], str] = {}  # "held A at ..." one-liner
_violations: list[LockOrderViolation] = []

_enabled: bool | None = None  # None = follow the environment
_raise_on_violation = False


class _Local(threading.local):
    def __init__(self) -> None:
        # Acquisition stack: [lock, acquire_t, reentry_count] records.
        self.held: list[list] = []
        # Re-entrancy latch: >0 while inside lockdep's own bookkeeping
        # (graph mutation, metric observe, event emission) — tracked
        # locks acquired there pass straight through to the primitive.
        self.latch = 0


_tls = _Local()


def env_enabled() -> bool:
    """The process default for the sanitizer (``ADVSPEC_LOCKDEP``)."""
    return os.environ.get("ADVSPEC_LOCKDEP", "0") not in ("", "0")


def enabled() -> bool:
    return env_enabled() if _enabled is None else _enabled


def configure(
    *, enabled: bool | None = None, raise_on_violation: bool | None = None
) -> None:
    """Override the env default (tests, drills, ``--lockdep``). Only
    affects locks created AFTER the call — ``make_lock`` decides
    tracked-vs-raw at construction time so the disabled path stays
    zero-cost."""
    global _enabled, _raise_on_violation
    if enabled is not None:
        _enabled = bool(enabled)
    if raise_on_violation is not None:
        _raise_on_violation = bool(raise_on_violation)


def raise_on_violation() -> bool:
    return _raise_on_violation


def reset() -> None:
    """Clear the acquisition-order graph and the violation ledger (per
    test / per drill — edges must not leak across unrelated lock
    instances that happen to share a name)."""
    with _meta:
        _edges.clear()
        _edge_stacks.clear()
        _edge_sites.clear()
        _violations.clear()


def violations() -> list[LockOrderViolation]:
    with _meta:
        return list(_violations)


def order_edges() -> dict[str, tuple[str, ...]]:
    """Snapshot of the observed acquisition-order graph (lock name ->
    locks acquired while holding it) — the runtime twin of the
    hierarchy GL-LOCK-ORDER emits into ``--json``."""
    with _meta:
        return {a: tuple(sorted(bs)) for a, bs in sorted(_edges.items())}


def held_names() -> tuple[str, ...]:
    """The current thread's held tracked locks, outermost first."""
    return tuple(rec[0].name for rec in _tls.held)


# -- graph maintenance ------------------------------------------------------


def _find_path(src: str, dst: str) -> list[str] | None:
    """A path src -> ... -> dst in the edge graph (caller holds _meta)."""
    stack = [(src, [src])]
    seen = {src}
    while stack:
        node, path = stack.pop()
        if node == dst:
            return path
        for nxt in _edges.get(node, ()):
            if nxt not in seen:
                seen.add(nxt)
                stack.append((nxt, path + [nxt]))
    return None


def _own_frames() -> str:
    """The acquiring stack, trimmed of lockdep's own frames."""
    frames = traceback.format_stack()
    return "".join(
        f for f in frames if "/lockdep.py" not in f.replace("\\", "/")
    )


def _record_edge(held_name: str, new_name: str) -> None:
    """Record held_name -> new_name; detect the cycle it may close.
    Caller has the re-entrancy latch set."""
    key = (held_name, new_name)
    if key in _edge_stacks:  # fast path: seen pairs are one dict probe
        return
    with _meta:
        if key in _edge_stacks:
            return
        back = _find_path(new_name, held_name)
        stack = _own_frames()
        _edge_stacks[key] = stack
        _edge_sites[key] = f"{held_name} -> {new_name}"
        _edges.setdefault(held_name, set()).add(new_name)
        if back is None:
            return
        # Adding held->new closed new -> ... -> held: an inversion.
        first_edge = (back[0], back[1])
        other = _edge_stacks.get(first_edge, "<unrecorded>")
        cycle = " -> ".join([held_name, new_name] + back[1:])
        msg = (
            f"lock-order inversion: acquiring {new_name!r} while "
            f"holding {held_name!r} closes the cycle [{cycle}]\n"
            f"--- this acquisition ({held_name} -> {new_name}):\n"
            f"{stack}"
            f"--- first recorded opposite edge "
            f"({first_edge[0]} -> {first_edge[1]}):\n{other}"
        )
        violation = LockOrderViolation(msg, key)
        _violations.append(violation)
    _emit_violation(violation)
    if _raise_on_violation:
        raise violation


def _emit_violation(violation: LockOrderViolation) -> None:
    """LockEvent + auto-dump; best-effort (a telemetry failure must
    never mask the violation itself)."""
    try:
        from .. import obs as obs_mod

        if obs_mod.config().enabled:
            a, b = violation.edge
            obs_mod.emit(
                obs_mod.events.LockEvent(
                    op="violation", lock=b, held=a, edge=f"{a}->{b}"
                )
            )
            obs_mod.autodump("lockdep")
    except Exception:
        pass


# -- the wrappers -----------------------------------------------------------


class TrackedLock:
    """Drop-in ``threading.Lock`` that feeds the acquisition-order
    graph and the hold/wait histograms. ``name`` is the lock class:
    every instance of ``ServeScheduler._lock`` shares one graph node."""

    _reentrant = False

    def __init__(self, name: str, *, metrics: bool = True):
        self.name = name
        self._metrics = metrics
        self._lk = threading.RLock() if self._reentrant else threading.Lock()
        self._hold_h = None  # cached histogram handles (obs.reset
        self._wait_h = None  # zeroes in place; handles stay live)

    # threading.Condition(lock) uses exactly this pair.
    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        tls = _tls
        if tls.latch:
            return self._lk.acquire(blocking, timeout)
        t0 = time.perf_counter()
        ok = self._lk.acquire(blocking, timeout)
        if not ok:
            return False
        try:
            self._note_acquired(time.perf_counter() - t0)
        except LockOrderViolation:
            self._lk.release()
            raise
        return True

    def release(self) -> None:
        tls = _tls
        if tls.latch:
            self._lk.release()
            return
        held = tls.held
        for i in range(len(held) - 1, -1, -1):
            if held[i][0] is self:
                rec = held[i]
                rec[2] -= 1
                if rec[2] == 0:
                    del held[i]
                    self._observe_hold(time.perf_counter() - rec[1])
                break
        self._lk.release()

    def __enter__(self) -> "TrackedLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def locked(self) -> bool:
        return self._lk.locked()

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"<{type(self).__name__} {self.name!r}>"

    # -- bookkeeping --------------------------------------------------

    def _note_acquired(self, wait: float) -> None:
        tls = _tls
        held = tls.held
        if self._reentrant:
            for rec in held:
                if rec[0] is self:
                    rec[2] += 1  # re-entry: no edge, no second record
                    return
        if held:
            top = held[-1][0]
            if top is not self and top.name != self.name:
                tls.latch += 1
                try:
                    _record_edge(top.name, self.name)
                finally:
                    tls.latch -= 1
        held.append([self, time.perf_counter(), 1])
        self._observe_wait(wait)

    def _observe_wait(self, wait: float) -> None:
        if not self._metrics:
            return
        tls = _tls
        tls.latch += 1
        try:
            from .. import obs as obs_mod

            if not obs_mod.config().enabled:
                return  # gate every observe, not just the handle mint
            h = self._wait_h
            if h is None:
                h = self._wait_h = obs_mod.hot.lock_wait(self.name)
            h.observe(wait)
        except Exception:
            pass
        finally:
            tls.latch -= 1

    def _observe_hold(self, hold: float) -> None:
        if not self._metrics:
            return
        tls = _tls
        tls.latch += 1
        try:
            from .. import obs as obs_mod

            if not obs_mod.config().enabled:
                return  # gate every observe, not just the handle mint
            h = self._hold_h
            if h is None:
                h = self._hold_h = obs_mod.hot.lock_hold(self.name)
            h.observe(hold)
        except Exception:
            pass
        finally:
            tls.latch -= 1


class TrackedRLock(TrackedLock):
    """Drop-in ``threading.RLock``: same-instance re-entry is counted,
    never an edge (the router's retirement surgery re-enters its own
    ``_mlock`` by design — that is what the RLock is for)."""

    _reentrant = True

    def locked(self) -> bool:  # RLock has no .locked() before 3.12
        if self._lk.acquire(blocking=False):
            self._lk.release()
            return False
        return True


def make_lock(name: str, *, metrics: bool = True):
    """A ``threading.Lock`` (lockdep off — zero added cost) or a
    ``TrackedLock`` (lockdep on). The one construction seam every
    declared lock in the package routes through."""
    if enabled():
        return TrackedLock(name, metrics=metrics)
    return threading.Lock()


def make_rlock(name: str, *, metrics: bool = True):
    if enabled():
        return TrackedRLock(name, metrics=metrics)
    return threading.RLock()


# -- self test --------------------------------------------------------------


def self_test() -> list[str]:
    """Prove the sanitizer is live: a synthetic two-lock inversion must
    be detected and must name both stacks (tools/lint_all.py runs this
    as a stage, mirroring graftlint ``--self-test``). Global state is
    snapshotted and restored — a self-test must not leave edges or a
    recorded violation behind."""
    global _enabled, _raise_on_violation
    problems: list[str] = []
    with _meta:
        saved = (
            {k: set(v) for k, v in _edges.items()},
            dict(_edge_stacks),
            dict(_edge_sites),
            list(_violations),
        )
    saved_cfg = (_enabled, _raise_on_violation)
    try:
        configure(enabled=True, raise_on_violation=False)
        a = TrackedLock("lockdep-selftest.A", metrics=False)
        b = TrackedLock("lockdep-selftest.B", metrics=False)
        with a:
            with b:
                pass
        before = len(violations())
        with b:
            with a:
                pass
        got = violations()[before:]
        if not got:
            problems.append(
                "lockdep self-test: synthetic A->B / B->A inversion "
                "produced no LockOrderViolation"
            )
        else:
            msg = str(got[0])
            if "this acquisition" not in msg or "opposite edge" not in msg:
                problems.append(
                    "lockdep self-test: violation does not name both "
                    f"stacks: {msg[:200]!r}"
                )
    finally:
        _enabled, _raise_on_violation = saved_cfg
        with _meta:
            _edges.clear()
            _edges.update(saved[0])
            _edge_stacks.clear()
            _edge_stacks.update(saved[1])
            _edge_sites.clear()
            _edge_sites.update(saved[2])
            _violations.clear()
            _violations.extend(saved[3])
    return problems
