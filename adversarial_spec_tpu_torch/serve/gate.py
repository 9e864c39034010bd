"""The scheduler-gated engine seam + the single engine pump.

The round driver (``debate.core.run_round``) stays completely unaware
of the daemon: it calls ``get_engine(model).chat(...)`` exactly as the
CLI does. When the daemon is serving, ``dispatch.get_engine`` routes
through :func:`wrap`, which hands back a :class:`GatedEngine` — same
``Engine`` protocol, but ``chat`` splits the batch into per-opponent
:class:`~adversarial_spec_tpu_torch.serve.sched.Unit`\\ s, submits them to
the fair-share scheduler, and blocks until each resolves. Concurrent
debates therefore interleave at OPPONENT-REQUEST granularity into the
one shared engine, in stride-fair order — the scheduler's contract,
not the accident of thread timing.

The :class:`EnginePump` is the only thread that touches the inner
engine (the batcher is not thread-safe by design — concurrency lives
in the batch dimension, not in Python threads): it pulls fair-order
batches from the scheduler, composes the delivery consumer below, runs
the ONE engine dispatch, and reports completions back.

The composed stream consumer is where three concerns meet on the
engine's streaming seam, in precedence order:

1. the client's per-opponent stream events (``on_stream``, best
   effort — a broken client callback disables itself, never the
   decode);
2. the round driver's own consumer (early-convergence cancel: its
   ``False`` is a CLEAN cancel, so it is checked FIRST and recorded as
   ``cancelled_by_caller`` — a cancel and a preemption must never be
   confused);
3. the preemption policy (``ServeScheduler.should_preempt``): a batch
   unit holding the engine while interactive work waits returns False,
   the batcher releases the slot through the shared ``_release_slot``
   surgery (partial KV salvaged), and the scheduler re-queues the
   unit.

Outside a submission context (``validate`` preflights, plain library
calls in the daemon process) the gate is a transparent passthrough.
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager

from adversarial_spec_tpu_torch.engine import streaming as stream_mod
from adversarial_spec_tpu_torch.engine.types import Completion
from adversarial_spec_tpu_torch.resilience import faults as faults_mod
from adversarial_spec_tpu_torch.serve.sched import ServeScheduler, Unit


class Submission:
    """Everything the gate needs to know about the debate whose round
    driver is currently calling ``chat`` on this thread: identity for
    the scheduler (tenant/tier/debate), the client stream callback,
    and the TTFT probe (first delivery or first completion, whichever
    lands first — the drill's interactive-SLO measurement)."""

    __slots__ = ("tenant", "tier", "debate", "on_stream", "t0", "ttft_s")

    def __init__(
        self,
        tenant: str,
        tier: str = "interactive",
        debate: str = "",
        on_stream=None,
        t0: float | None = None,
    ) -> None:
        self.tenant = tenant
        self.tier = tier
        self.debate = debate
        self.on_stream = on_stream
        self.t0 = time.monotonic() if t0 is None else t0
        self.ttft_s: float | None = None

    def note_first_token(self) -> None:
        if self.ttft_s is None:
            self.ttft_s = max(0.0, time.monotonic() - self.t0)


_local = threading.local()
_sched: ServeScheduler | None = None
_gates: dict[int, "GatedEngine"] = {}


def install(sched: ServeScheduler) -> None:
    """Arm the gate: from now on ``dispatch.get_engine`` wraps every
    engine it returns (one gate per inner engine, cached so
    ``run_round``'s group-by-engine-identity still batches)."""
    global _sched
    _sched = sched
    _gates.clear()


def uninstall() -> None:
    global _sched
    _sched = None
    _gates.clear()


def armed() -> bool:
    return _sched is not None


def wrap(inner):
    """The dispatch seam: the gated view of ``inner`` while serving,
    ``inner`` itself otherwise."""
    if _sched is None or isinstance(inner, GatedEngine):
        return inner
    gate = _gates.get(id(inner))
    if gate is None:
        gate = _gates[id(inner)] = GatedEngine(inner, _sched)
    return gate


@contextmanager
def submission(sub: Submission):
    """Scope a debate thread's ``chat`` calls to its submission
    identity (thread-local, like the trace ambient — each daemon
    debate thread carries its own)."""
    prev = getattr(_local, "sub", None)
    _local.sub = sub
    try:
        yield sub
    finally:
        _local.sub = prev


def current_submission() -> Submission | None:
    return getattr(_local, "sub", None)


class GatedEngine:
    """Engine-protocol adapter: ``chat`` becomes submit-and-wait on
    the fair-share scheduler; everything else passes through."""

    def __init__(self, inner, sched: ServeScheduler) -> None:
        self._inner = inner
        self._sched = sched

    def validate(self, model: str) -> str | None:
        return self._inner.validate(model)

    def chat(self, requests, params, consumer=None):
        sub = current_submission()
        if sub is None:
            # Transparent outside a submission scope (preflights,
            # library callers in the daemon process).
            if consumer is not None and stream_mod.consumer_supported(
                self._inner
            ):
                return self._inner.chat(requests, params, consumer=consumer)
            return self._inner.chat(requests, params)
        units = [
            Unit(
                debate=sub.debate,
                tenant=sub.tenant,
                tier=sub.tier,
                index=i,
                request=req,
                params=params,
                engine=self._inner,
                consumer=consumer,
                on_stream=sub.on_stream,
                submission=sub,
            )
            for i, req in enumerate(requests)
        ]
        self._sched.submit_units(units)
        for u in units:
            u.done.wait()
            if u.submission is not None:
                # No streaming armed: TTFT falls back to the first
                # resolved opponent.
                u.submission.note_first_token()
        return [u.completion for u in units]


def _composed_consumer(batch: list[Unit]):
    """One consumer for one engine dispatch, multiplexing the batch's
    units by row index. See the module docstring for the precedence
    contract."""
    def consume(row: int, text: str) -> bool:
        u = batch[row]
        if u.submission is not None:
            u.submission.note_first_token()
        if u.on_stream is not None:
            try:
                u.on_stream(u.index, text)
            except Exception:
                # A broken client callback disables itself; the decode
                # and the round are unharmed (the batcher's own
                # containment rule, applied one layer up).
                u.on_stream = None
        if u.consumer is not None:
            try:
                keep = bool(u.consumer(u.index, text))
            except Exception:
                keep = True
                u.consumer = None
            if not keep:
                u.cancelled_by_caller = True
                return False
        if u.preempt_requested or (
            _sched is not None and _sched.should_preempt(u)
        ):
            u.preempt_requested = True
            return False
        return True

    return consume


class EnginePump(threading.Thread):
    """The one thread that runs the inner engine: pull a fair-order
    batch, dispatch it, report completions. Exits when the scheduler
    stops (post-drain)."""

    def __init__(self, sched: ServeScheduler) -> None:
        super().__init__(name="advspec-serve-pump", daemon=True)
        self._sched = sched

    def run(self) -> None:
        while True:
            batch = self._sched.next_batch(timeout=0.1)
            if batch is None:
                return
            if not batch:
                continue
            self._execute(batch)

    def _execute(self, batch: list[Unit]) -> None:
        engine = batch[0].engine
        requests = [u.request for u in batch]
        params = batch[0].params
        try:
            if stream_mod.config().enabled and stream_mod.consumer_supported(
                engine
            ):
                comps = engine.chat(
                    requests, params, consumer=_composed_consumer(batch)
                )
            else:
                comps = engine.chat(requests, params)
        except Exception as e:  # the engine seam's containment rule
            kind = faults_mod.classify(e)
            faults_mod.record(kind, "serve_dispatch")
            comps = [
                Completion(error=str(e), transient=kind.transient)
                for _ in batch
            ]
        if len(comps) != len(batch):
            comps = list(comps) + [
                Completion(error="engine returned short batch")
                for _ in range(len(batch) - len(comps))
            ]
        # Drain-cancelled units resolve as drained (no re-queue); the
        # rest route through the normal completion path.
        if self._sched.draining and any(
            u.preempt_requested and c.cancelled and not u.cancelled_by_caller
            for u, c in zip(batch, comps)
        ):
            normal: list[tuple[Unit, Completion]] = []
            for u, c in zip(batch, comps):
                if (
                    u.preempt_requested
                    and c.cancelled
                    and not u.cancelled_by_caller
                ):
                    self._sched.drain_cancelled(u, c)
                else:
                    normal.append((u, c))
            if normal:
                self._sched.on_dispatch_complete(
                    [u for u, _ in normal], [c for _, c in normal]
                )
            return
        self._sched.on_dispatch_complete(batch, comps)
