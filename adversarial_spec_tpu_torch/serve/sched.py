"""Admission control + fair-share scheduling + the request lifecycle.

One class owns the daemon's whole control plane so one lock serializes
it (``ServeScheduler``); the engine itself never blocks on this lock —
the pump (serve/gate.py) holds it only to PICK work, not to run it.

**Admission** (``try_admit``): a new debate is refused with a typed,
retry-after-carrying shed (serve/protocol.py ``SHED_REASONS``) when
its tenant's outstanding-debate queue is at ``max_queue_depth``, when
the estimated token backlog would cross ``max_backlog_tokens``, when
the tenant's token quota is exhausted, when the batch tier is paused
by brownout, or when the daemon is draining. Accepted debates RESERVE
their token estimate in the backlog ledger; completions release it —
so the ledger is the daemon's pressure signal, not a guess.

**Fair share** (``next_batch``): stride scheduling per (tier, tenant).
Each tenant carries a ``pass`` value; the runnable tenant with the
minimum pass is served next, and its pass advances by the ACTUAL
tokens its completion paid (``Usage`` — prefill actually computed plus
decode produced), so a tenant burning long decodes falls behind a
tenant of short ones at exactly the token exchange rate. Tiers are
strict priority: interactive always dispatches before batch — "batch
starves first" is the contract, not an accident. Same-model units at
the head of the fair order coalesce into one dispatch batch (N rows
of one batched decode on the real engine), and when the fair head
would force a WEIGHT SWAP (a different model than the one dispatching
— engine/weightres.py), same-model units deeper in the dispatching
tenant's own queue are pulled forward first: a swap is allowed only
after the resident model's queued work is exhausted. The pull is
bounded to the tenant's own queue, so inter-tenant stride fairness is
untouched (passes advance by tokens paid regardless of intra-tenant
order, and a tenant's opponent units are independent requests).

**Brownout**: when the backlog ledger crosses
``brownout_enter_fraction x max_backlog_tokens`` the daemon DECLARES
degradation before shedding interactive traffic: speculation γ drops
to ``brownout_gamma`` (cheaper steps, lower tail latency) and batch
ADMISSIONS pause (typed ``brownout`` sheds). Batch dispatch is NOT
paused outright — strict tier priority already starves it while
interactive work exists, and batch completions are what drain the
backlog that exits the brownout (pausing them would deadlock the
state machine below its own exit threshold). Hysteresis:
exit below ``brownout_exit_fraction``.

**Preemption**: the policy side of the batcher's ``_release_slot`` surgery.
A batch unit holding the engine while an interactive unit has waited
past its grace is cancelled THROUGH ITS STREAM CONSUMER (the composed
consumer in serve/gate.py consults ``should_preempt`` at every
delivery): the batcher salvages the partial prefix KV into the prefix
cache exactly as an early-cancel does, and the unit re-queues at the
head of its tenant's queue for re-admission. The preempted partial is
recorded; on the deterministic mock the re-run's transcript must carry
it as a byte prefix (pinned).

**Lifecycle** (graftlint's third GL-LIFECYCLE machine): every unit
exits through ONE release surgery — ``_release_unit`` — reached from
``_finish_unit`` / ``_shed_unit`` / ``_preempt_unit`` /
``_drain_unit``; the running-set ledger ``_running`` is written only
by the surgery and the ``_start_unit`` acquisition. The daemon request
lifecycle (accepted → queued → running → finished | shed | preempted |
drained) is emitted as ``ServeEvent``s so ``tools/obs_dump.py`` can
render who was served and who was shed, when.

Deliberately imports no jax — the mock-engine daemon drives this
entire state machine deterministically on CPU.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass

from adversarial_spec_tpu_torch import obs as obs_mod
from adversarial_spec_tpu_torch import serve as serve_mod
from adversarial_spec_tpu_torch.engine import spec as spec_mod
from adversarial_spec_tpu_torch.engine import weightres as weightres_mod
from adversarial_spec_tpu_torch.engine.types import ChatRequest, Completion, SamplingParams
from adversarial_spec_tpu_torch.resilience import lockdep as lockdep_mod
from adversarial_spec_tpu_torch.serve.protocol import SHED_REASONS, TIERS

# Floor for the retry-after estimate's drain rate (tokens/s): before
# the first completion lands there is no measured rate, and a zero
# rate would tell clients to retry never.
_MIN_DRAIN_RATE = 1024.0


def estimate_tokens(request: ChatRequest, params: SamplingParams) -> int:
    """Admission-time cost estimate for one opponent unit: prompt
    tokens (the 4-chars-per-token rule every engine's accounting uses)
    plus the full decode budget — an upper bound on purpose; the
    ledger releases the estimate and charges the actual on
    completion."""
    prompt = (len(request.system) + len(request.user)) // 4
    return max(1, prompt) + max(1, int(params.max_new_tokens))


def estimate_prefill_tokens(request: ChatRequest) -> int:
    """The PREFILL share of the admission estimate (prompt tokens
    only, same 4-chars-per-token rule) — the disaggregated fleet's
    routing threshold input and the prefill-pool backlog signal."""
    return max(1, (len(request.system) + len(request.user)) // 4)


@dataclass(frozen=True)
class ShedDecision:
    """A typed admission refusal: the reason names WHY (a
    ``SHED_REASONS`` member), ``retry_after_s`` names WHEN the backlog
    is expected to have drained enough to try again."""

    reason: str
    retry_after_s: float
    message: str


class Unit:
    """One opponent request from one debate, as the scheduler sees it:
    the unit of fair-share interleave, preemption, and quota
    enforcement. Resolution is a (completion, done-event) pair the
    gate's ``chat`` blocks on."""

    __slots__ = (
        "debate",
        "tenant",
        "tier",
        "index",
        "request",
        "params",
        "engine",
        "consumer",
        "on_stream",
        "submission",
        "est_tokens",
        "enqueued_t",
        "attempts",
        "preempt_requested",
        "cancelled_by_caller",
        "preempt_partials",
        "state",
        "completion",
        "done",
    )

    def __init__(
        self,
        *,
        debate: str,
        tenant: str,
        tier: str,
        index: int,
        request: ChatRequest,
        params: SamplingParams,
        engine,
        consumer=None,
        on_stream=None,
        submission=None,
    ) -> None:
        assert tier in TIERS, tier
        self.debate = debate
        self.tenant = tenant
        self.tier = tier
        self.index = index
        self.request = request
        self.params = params
        self.engine = engine
        self.consumer = consumer
        self.on_stream = on_stream
        self.submission = submission
        self.est_tokens = estimate_tokens(request, params)
        self.enqueued_t = 0.0
        self.attempts = 0
        self.preempt_requested = False
        self.cancelled_by_caller = False
        self.preempt_partials: list[str] = []
        self.state = "created"
        self.completion: Completion | None = None
        self.done = threading.Event()


class ServeScheduler:
    """The daemon's control plane: admission ledger, per-tenant stride
    queues, brownout state machine, and the unit lifecycle. One lock;
    engine execution happens outside it (serve/gate.py)."""

    def __init__(self, clock=time.monotonic) -> None:
        self._clock = clock
        self._lock = lockdep_mod.make_lock("ServeScheduler._lock")
        self._cond = threading.Condition(self._lock)
        # tier -> tenant -> FIFO of queued units.
        self._queues: dict[str, dict[str, deque[Unit]]] = {
            t: {} for t in TIERS
        }
        # Stride passes per (tier, tenant); a new tenant joins at the
        # tier's current minimum so it cannot claim ancient credit.
        self._passes: dict[tuple[str, str], float] = {}
        # Units currently dispatched to the engine, keyed by id(unit).
        # LIFECYCLE-OWNED: written only by _start_unit (acquisition)
        # and _release_unit (the one release surgery).
        self._running: dict[int, Unit] = {}
        # Admission ledger: per-debate reserved token estimates (the
        # backlog), per-tenant outstanding debate counts, per-tenant
        # quota remainders (armed when config.tenant_quota_tokens > 0).
        self._reserved: dict[str, int] = {}
        # The PREFILL share of each reservation (role-aware elasticity:
        # the autoscaler scales the prefill pool on this sub-ledger,
        # the decode pool on the remainder). Kept beside _reserved,
        # released with it.
        self._reserved_prefill: dict[str, int] = {}
        self._debate_tenant: dict[str, str] = {}
        # Per-active-debate opponent pools (admission metadata): the
        # autoscaler's model-mix observer — a warming replica preloads
        # the hottest models counted here.
        self._debate_models: dict[str, list[str]] = {}
        self._outstanding: dict[str, int] = {}
        self._quota: dict[str, int] = {}
        # Capacity provider (fleet/autoscale.py): a callable returning
        # the routable replica count. The admission backlog cap and the
        # brownout thresholds scale by it — an elastic fleet that just
        # grew ADMITS more instead of browning out; None (the default,
        # and every pre-elastic deployment) keeps the static cap.
        self._capacity_fn = None
        self.brownout = False
        self._prev_gamma: int | None = None
        self.draining = False
        # Past the drain deadline: every unit submitted from now on
        # resolves IMMEDIATELY as drained (a late-starting debate
        # thread must never block on a queue nobody will serve).
        self._drain_forced = False
        self._stopped = False
        # Measured drain rate for retry-after estimates.
        self._charged_tokens = 0
        self._started_t = clock()

    # -- small helpers (callers hold the lock unless noted) ----------------

    def _backlog(self) -> int:
        return sum(self._reserved.values())

    def set_capacity_provider(self, fn) -> None:
        """Install (or clear, ``None``) the fleet-capacity observer:
        ``fn()`` returns the routable replica count; the effective
        backlog cap is ``max_backlog_tokens × max(1, fn())``."""
        with self._cond:
            self._capacity_fn = fn
            self._cond.notify_all()

    def _capacity_tokens(self, cfg) -> int:
        """The EFFECTIVE backlog cap: per-replica cap × routable
        replicas. Defensive on the provider — a capacity read must
        never take the admission path down."""
        base = cfg.max_backlog_tokens
        fn = self._capacity_fn
        if fn is None:
            return base
        try:
            factor = max(1, int(fn()))
        except Exception:
            factor = 1
        return base * factor

    def _drain_rate(self) -> float:
        elapsed = max(self._clock() - self._started_t, 1e-3)
        return max(self._charged_tokens / elapsed, _MIN_DRAIN_RATE)

    def _emit(self, op: str, *, tenant: str = "", tier: str = "interactive",
              debate: str = "", index: int = -1, reason: str = "",
              tokens: int = 0, trace_id: str = "", span_id: str = "",
              arrival_s: float = 0.0) -> None:
        if obs_mod.config().enabled:
            obs_mod.hot.serve_op(op).inc()
            obs_mod.hot.serve_backlog.set(float(self._backlog()))
            obs_mod.emit(
                obs_mod.ServeEvent(
                    op=op,
                    tenant=tenant,
                    tier=tier,
                    debate=debate,
                    index=index,
                    reason=reason,
                    tokens=tokens,
                    backlog_tokens=self._backlog(),
                    arrival_s=arrival_s,
                    trace_id=trace_id,
                    span_id=span_id,
                )
            )

    def _quota_remaining(self, tenant: str) -> int | None:
        """None = quotas unarmed (config 0)."""
        base = serve_mod.config().tenant_quota_tokens
        if base <= 0:
            return None
        if tenant not in self._quota:
            self._quota[tenant] = base
        return self._quota[tenant]

    def refill_quota(self, tenant: str, tokens: int) -> int:
        """Add tokens to a tenant's quota; returns the new remainder.
        Wakes the pump: a queued unit whose dispatch was about to shed
        on quota dispatches instead — the refill-race contract."""
        with self._cond:
            remaining = self._quota_remaining(tenant)
            if remaining is None:
                return -1
            self._quota[tenant] = remaining + max(0, int(tokens))
            self._cond.notify_all()
            return self._quota[tenant]

    # -- admission ---------------------------------------------------------

    def try_admit(
        self, tenant: str, tier: str, debate: str, est_tokens: int,
        models: list[str] | tuple[str, ...] = (),
        prefill_tokens: int = 0,
        arrival_s: float = 0.0,
    ) -> ShedDecision | None:
        """Admit one debate (reserving its estimate in the backlog
        ledger) or refuse it with a typed shed. Shed order under
        pressure is the contract docs/serving.md documents: drain >
        brownout (batch only) > queue depth > backlog > quota —
        brownout pauses batch ADMISSIONS one step before the hard caps
        start refusing interactive traffic. The backlog cap scales
        with fleet capacity (``set_capacity_provider``): with an
        elastic fleet, scale-out RAISES it before brownout would
        engage. ``models`` is admission metadata — the debate's
        opponent pool, feeding the autoscaler's model-mix observer."""
        cfg = serve_mod.config()
        with self._cond:
            cap_tokens = self._capacity_tokens(cfg)
            retry = est_tokens / self._drain_rate()
            shed: ShedDecision | None = None
            if self.draining:
                shed = ShedDecision(
                    "draining", retry, "daemon is draining; resubmit to "
                    "the replacement instance"
                )
            elif self.brownout and tier == "batch":
                shed = ShedDecision(
                    "brownout",
                    self._backlog() / self._drain_rate(),
                    "batch tier paused during brownout",
                )
            elif (
                self._outstanding.get(tenant, 0) >= cfg.max_queue_depth
            ):
                shed = ShedDecision(
                    "queue_full",
                    self._backlog() / self._drain_rate()
                    / max(len(self._outstanding), 1),
                    f"tenant {tenant!r} has "
                    f"{self._outstanding.get(tenant, 0)} debates "
                    f"outstanding (cap {cfg.max_queue_depth})",
                )
            elif self._backlog() + est_tokens > cap_tokens:
                shed = ShedDecision(
                    "backlog",
                    (self._backlog() + est_tokens - cap_tokens)
                    / self._drain_rate(),
                    f"estimated backlog {self._backlog()} + {est_tokens} "
                    f"tokens exceeds cap {cap_tokens}",
                )
            else:
                remaining = self._quota_remaining(tenant)
                if remaining is not None and remaining <= 0:
                    shed = ShedDecision(
                        "quota",
                        retry,
                        f"tenant {tenant!r} token quota exhausted "
                        "(refill to resume)",
                    )
            if shed is not None:
                serve_mod.stats.shed_debates += 1
                if obs_mod.config().enabled:
                    obs_mod.hot.serve_shed(shed.reason).inc()
                self._emit(
                    "shed", tenant=tenant, tier=tier, debate=debate,
                    reason=shed.reason, tokens=est_tokens,
                    arrival_s=arrival_s,
                )
                return shed
            self._outstanding[tenant] = self._outstanding.get(tenant, 0) + 1
            self._reserved[debate] = est_tokens
            if prefill_tokens > 0:
                self._reserved_prefill[debate] = min(
                    int(prefill_tokens), est_tokens
                )
            self._debate_tenant[debate] = tenant
            if models:
                self._debate_models[debate] = [str(m) for m in models]
            serve_mod.stats.accepted_debates += 1
            self._emit(
                "accepted", tenant=tenant, tier=tier, debate=debate,
                tokens=est_tokens, arrival_s=arrival_s,
            )
            self._update_brownout()
            return None

    def finish_debate(self, debate: str) -> None:
        """Debate-level bookkeeping at round end (the driver calls this
        after ``run_round`` returns, success or not): the residual
        reservation releases, the tenant's outstanding count drops, and
        freed capacity may exit brownout."""
        with self._cond:
            if debate not in self._debate_tenant:
                return  # idempotent: already finished (or never admitted)
            self._reserved.pop(debate, None)
            self._reserved_prefill.pop(debate, None)
            self._debate_models.pop(debate, None)
            tenant = self._debate_tenant.pop(debate, "")
            if tenant:
                self._outstanding[tenant] = max(
                    0, self._outstanding.get(tenant, 0) - 1
                )
            serve_mod.stats.completed_debates += 1
            self._emit("finished", tenant=tenant, debate=debate)
            self._update_brownout()
            self._cond.notify_all()

    # -- queueing + fair-share pick ----------------------------------------

    def submit_units(self, units: list[Unit]) -> None:
        """Queue opponent units for fair-share dispatch (the gate's
        ``chat`` calls this from the debate thread, then blocks on the
        units' done events)."""
        now = self._clock()
        with self._cond:
            if self._drain_forced or self._stopped:
                # The drain deadline passed (or the scheduler stopped):
                # resolve immediately — queueing would strand the
                # submitting debate thread on a queue nobody serves
                # (ungated raw-engine use after shutdown was the
                # alternative failure; neither is acceptable).
                for u in units:
                    self._drain_unit(u)
                self._cond.notify_all()
                return
            for u in units:
                u.enqueued_t = now
                u.state = "queued"
                q = self._queues[u.tier].setdefault(u.tenant, deque())
                q.append(u)
                key = (u.tier, u.tenant)
                if key not in self._passes:
                    tier_passes = [
                        v for (t, _), v in self._passes.items()
                        if t == u.tier
                    ]
                    self._passes[key] = min(tier_passes) if tier_passes else 0.0
                self._emit(
                    "queued", tenant=u.tenant, tier=u.tier,
                    debate=u.debate, index=u.index, tokens=u.est_tokens,
                    trace_id=u.request.trace_id, span_id=u.request.span_id,
                )
            self._cond.notify_all()

    def _pick_tenant(self, tier: str) -> str | None:
        """The runnable tenant with the minimum stride pass."""
        tenants = [
            t for t, q in self._queues[tier].items() if q
        ]
        if not tenants:
            return None
        return min(tenants, key=lambda t: (self._passes[(tier, t)], t))

    def _pop_runnable(self) -> Unit | None:
        """Pop the next unit in fair order: interactive strictly before
        batch, min-pass tenant within the tier. Quota-exhausted units
        shed HERE (dispatch-time enforcement: exhaustion mid-round
        sheds the remaining opponents; the round still commits)."""
        for tier in TIERS:  # ("interactive", "batch"): strict priority
            while True:
                tenant = self._pick_tenant(tier)
                if tenant is None:
                    break
                unit = self._queues[tier][tenant].popleft()
                remaining = self._quota_remaining(tenant)
                if remaining is not None and remaining <= 0:
                    self._shed_unit(
                        unit, "quota",
                        f"tenant {tenant!r} token quota exhausted "
                        "mid-round (refill to resume)",
                    )
                    continue
                return unit
        return None

    def next_batch(self, timeout: float = 0.1) -> list[Unit] | None:
        """The pump's pick: the fair-order head unit plus any same-
        model/same-params units that follow it in fair order, up to
        ``max_dispatch_batch`` (N rows of one batched decode on the
        real engine). Returns [] on timeout (pump re-polls), None once
        the scheduler is stopped (pump exits)."""
        cfg = serve_mod.config()
        with self._cond:
            first = self._pop_runnable()
            while first is None:
                if self._stopped:
                    return None
                if not self._cond.wait(timeout=timeout):
                    return []
                first = self._pop_runnable()
            batch = [first]
            while len(batch) < cfg.max_dispatch_batch:
                nxt = self._peek_matching(first)
                if nxt is None:
                    # The fair head would force a model swap: pull
                    # same-model work forward from the dispatching
                    # tenant's own queue before allowing it.
                    nxt = self._steal_same_model(first)
                if nxt is None:
                    break
                batch.append(nxt)
            for u in batch:
                self._start_unit(u)
            return batch

    def _peek_matching(self, first: Unit) -> Unit | None:
        """Pop the NEXT fair-order unit only when it can ride the same
        engine dispatch (same engine, model, params): fairness is never
        skipped around — a non-matching fair head ends the batch."""
        tenant = self._pick_tenant(first.tier)
        if tenant is None:
            return None
        q = self._queues[first.tier][tenant]
        head = q[0]
        if (
            head.engine is first.engine
            and head.request.model == first.request.model
            and head.params == first.params
        ):
            remaining = self._quota_remaining(tenant)
            if remaining is not None and remaining <= 0:
                return None  # quota shed happens on its own pick
            return q.popleft()
        return None

    def _steal_same_model(self, first: Unit) -> Unit | None:
        """Weight-swap-aware coalescing (engine/weightres.py): when the
        next fair-order unit runs a DIFFERENT model, scan the
        dispatching tenant's own queue for a same-(engine, model,
        params) unit and pull it into this dispatch — same-model
        opponent units coalesce before a swap is allowed. Scoped to
        ``first``'s own (tier, tenant) queue so stride fairness between
        tenants is untouched; counted into ``perf.weights``
        (``coalesced_units``) so the reorder is declared, not
        inferred."""
        if not weightres_mod.config().enabled:
            return None
        remaining = self._quota_remaining(first.tenant)
        if remaining is not None and remaining <= 0:
            return None
        q = self._queues[first.tier].get(first.tenant)
        if not q:
            return None
        for i, unit in enumerate(q):
            if (
                unit.engine is first.engine
                and unit.request.model == first.request.model
                and unit.params == first.params
            ):
                del q[i]
                weightres_mod.stats.coalesced_units += 1
                return unit
        return None

    def _start_unit(self, unit: Unit) -> None:
        """Acquisition: the only writer of ``_running`` besides the
        release surgery."""
        unit.state = "running"
        unit.attempts += 1
        self._running[id(unit)] = unit
        serve_mod.stats.units_dispatched += 1
        if obs_mod.config().enabled:
            obs_mod.hot.serve_queue_wait.observe(
                max(0.0, self._clock() - unit.enqueued_t)
            )
        self._emit(
            "running", tenant=unit.tenant, tier=unit.tier,
            debate=unit.debate, index=unit.index, tokens=unit.est_tokens,
            trace_id=unit.request.trace_id, span_id=unit.request.span_id,
        )

    # -- preemption policy -------------------------------------------------

    def should_preempt(self, unit: Unit) -> bool:
        """Policy: cancel this RUNNING batch unit when an interactive
        unit has out-waited its grace (the composed stream consumer
        consults this at every delivery — the engine's own delivery
        cadence is the polling clock, no timers). Interactive units are
        never preempted."""
        if unit.tier != "batch":
            return False
        cfg = serve_mod.config()
        grace = cfg.preempt_grace_s
        if cfg.interactive_ttft_slo_ms > 0.0 and grace <= 0.0:
            # Preempt BEFORE the breach: half the TTFT budget.
            grace = cfg.interactive_ttft_slo_ms / 1000.0 / 2.0
        now = self._clock()
        with self._lock:
            for q in self._queues["interactive"].values():
                if q and now - q[0].enqueued_t >= grace:
                    return True
        return False

    # -- completion + the lifecycle surgeries ------------------------------

    def on_dispatch_complete(
        self, batch: list[Unit], completions: list[Completion]
    ) -> None:
        """The pump reports one engine dispatch's outcome: charge the
        stride passes and quotas with the ACTUAL tokens paid, then
        route every unit through its lifecycle exit."""
        with self._cond:
            for unit, comp in zip(batch, completions):
                u = comp.usage
                paid = max(
                    0,
                    (u.input_tokens - u.cached_tokens) + u.output_tokens,
                )
                key = (unit.tier, unit.tenant)
                self._passes[key] = self._passes.get(key, 0.0) + paid
                remaining = self._quota_remaining(unit.tenant)
                if remaining is not None:
                    self._quota[unit.tenant] = remaining - paid
                self._charged_tokens += paid
                serve_mod.stats.tokens_charged += paid
                if (
                    comp.cancelled
                    and unit.preempt_requested
                    and not unit.cancelled_by_caller
                ):
                    self._preempt_unit(unit, comp)
                else:
                    self._finish_unit(unit, comp)
            self._update_brownout()
            self._cond.notify_all()

    def _finish_unit(self, unit: Unit, comp: Completion) -> None:
        """Exit: normal resolution (includes caller-cancelled units —
        an early-convergence cancel is a CLEAN result)."""
        serve_mod.stats.units_completed += 1
        self._release_unit(unit, "finished", comp)

    def _shed_unit(self, unit: Unit, reason: str, msg: str) -> None:
        """Exit: typed mid-round shed (quota exhaustion at dispatch).
        The unit resolves with a NON-transient error completion so the
        round driver records the failure and commits the round instead
        of burning its retry ladder on a policy decision."""
        assert reason in SHED_REASONS, reason
        serve_mod.stats.units_shed += 1
        if obs_mod.config().enabled:
            obs_mod.hot.serve_shed(reason).inc()
        self._release_unit(
            unit,
            "shed",
            Completion(error=f"shed ({reason}): {msg}", transient=False),
            reason=reason,
        )

    def _preempt_unit(self, unit: Unit, comp: Completion) -> None:
        """Exit + re-entry: a policy-cancelled batch unit releases
        through the surgery (its engine slot already released through
        the batcher's ``_release_slot`` with partial KV salvaged), then
        re-queues at the HEAD of its tenant's queue so it resumes as
        soon as interactive pressure clears. The partial transcript is
        kept — the mock re-run must reproduce it as a byte prefix."""
        serve_mod.stats.units_preempted += 1
        serve_mod.stats.preempted_partial_tokens += comp.usage.output_tokens
        unit.preempt_partials.append(comp.text)
        self._release_unit(unit, "preempted", None, reason="tier_pressure")
        unit.preempt_requested = False
        unit.state = "queued"
        unit.enqueued_t = self._clock()
        self._queues[unit.tier].setdefault(
            unit.tenant, deque()
        ).appendleft(unit)
        serve_mod.stats.units_readmitted += 1
        self._emit(
            "queued", tenant=unit.tenant, tier=unit.tier,
            debate=unit.debate, index=unit.index, reason="readmitted",
            trace_id=unit.request.trace_id, span_id=unit.request.span_id,
        )

    def _drain_unit(self, unit: Unit) -> None:
        """Exit: drain-deadline shed of a queued unit. The error is
        non-transient (no retry ladder) and the debate's journal keeps
        every ALREADY-completed opponent durable — resubmitting the
        same session+spec+round replays them with zero engine work."""
        serve_mod.stats.units_drained += 1
        self._release_unit(
            unit,
            "drained",
            Completion(
                error="drained: daemon shutting down (journal-committed "
                "opponents replay on resubmit)",
                transient=False,
            ),
            reason="draining",
        )

    def _release_unit(
        self,
        unit: Unit,
        outcome: str,
        comp: Completion | None,
        reason: str = "",
    ) -> None:
        """THE release surgery (GL-LIFECYCLE machine 3): every unit
        exit funnels through here — running-set removal, backlog
        release, lifecycle event, and resolution of the gate's wait.
        ``comp`` None (preemption) releases WITHOUT resolving: the
        unit re-queues and its reservation survives until it truly
        resolves. Caller holds the lock."""
        self._running.pop(id(unit), None)
        if comp is not None:
            if unit.debate in self._reserved:
                self._reserved[unit.debate] = max(
                    0, self._reserved[unit.debate] - unit.est_tokens
                )
            unit.state = outcome
            unit.completion = comp
        else:
            unit.state = outcome
        self._emit(
            outcome, tenant=unit.tenant, tier=unit.tier,
            debate=unit.debate, index=unit.index, reason=reason,
            tokens=(comp.usage.output_tokens if comp is not None else 0),
            trace_id=unit.request.trace_id, span_id=unit.request.span_id,
        )
        if comp is not None:
            unit.done.set()

    # -- brownout ----------------------------------------------------------

    def _update_brownout(self) -> None:
        """Hysteresis state machine over the backlog ledger. Entering
        lowers speculation γ (the declared degradation) and pauses
        batch admissions; exiting restores γ. Caller holds the lock.
        Thresholds are fractions of the EFFECTIVE capacity
        (``_capacity_tokens``): a scale-out that lands mid-brownout
        raises the exit threshold past the backlog and the next
        admission/finish exits brownout — capacity arriving IS the
        recovery path, one notch before shedding ever starts."""
        cfg = serve_mod.config()
        backlog = self._backlog()
        cap_tokens = self._capacity_tokens(cfg)
        if (
            not self.brownout
            and backlog >= cfg.brownout_enter_fraction * cap_tokens
        ):
            self.brownout = True
            serve_mod.stats.brownout_entries += 1
            self._prev_gamma = self._set_gamma(cfg.brownout_gamma)
            self._emit("brownout_enter", tokens=backlog)
        elif (
            self.brownout
            and backlog <= cfg.brownout_exit_fraction * cap_tokens
        ):
            self.brownout = False
            serve_mod.stats.brownout_exits += 1
            if self._prev_gamma is not None:
                self._set_gamma(self._prev_gamma)
                self._prev_gamma = None
            self._emit("brownout_exit", tokens=backlog)

    @staticmethod
    def _set_gamma(gamma: int) -> int:
        """Swap the process speculation γ; returns the previous value.
        The engine re-reads it at its next dispatch (``GpuEngine.chat``
        resolves the speculation config per call), so the verify span
        shortens from the next batch on."""
        prev = spec_mod.config().gamma
        spec_mod.configure(gamma=max(1, int(gamma)))
        return prev

    # -- drain + shutdown --------------------------------------------------

    def begin_drain(self) -> None:
        """Stop admissions (typed ``draining`` sheds); dispatch
        CONTINUES so in-flight debates finish — the graceful half of
        the drain contract."""
        with self._cond:
            self.draining = True
            self._cond.notify_all()

    def force_drain(self) -> int:
        """The drain deadline passed: shed every queued unit (typed,
        journal-resumable) and flag every running unit for preemption-
        style cancellation so the pump's current dispatch returns
        promptly. Returns the number of units drained."""
        n = 0
        with self._cond:
            self.draining = True
            self._drain_forced = True
            for tier in TIERS:
                for q in self._queues[tier].values():
                    while q:
                        self._drain_unit(q.popleft())
                        n += 1
            for unit in list(self._running.values()):
                unit.preempt_requested = True
            self._cond.notify_all()
        return n

    def drain_cancelled(self, unit: Unit, comp: Completion) -> None:
        """A running unit cancelled BY force_drain resolves here (the
        pump routes it in): drained, not preempted — no re-queue."""
        with self._cond:
            serve_mod.stats.units_drained += 1
            self._release_unit(
                unit,
                "drained",
                Completion(
                    text=comp.text,
                    error="drained: daemon shutting down mid-decode "
                    "(partial kept; journal-committed opponents replay "
                    "on resubmit)",
                    transient=False,
                    usage=comp.usage,
                ),
                reason="draining",
            )
            self._cond.notify_all()

    def stop(self) -> None:
        """Final shutdown: force-drain whatever remains (queued units
        shed typed, running units flagged for cancel, future submits
        resolve drained on arrival), then stop the pump — no gate
        thread can be left blocked on a queue nobody serves."""
        self.force_drain()
        with self._cond:
            self._stopped = True
            self._cond.notify_all()

    # -- introspection -----------------------------------------------------

    def idle(self) -> bool:
        with self._lock:
            return not self._running and not any(
                q for qs in self._queues.values() for q in qs.values()
            )

    def pressure_snapshot(self) -> dict:
        """The autoscaler's observer (fleet/autoscale.py): the backlog
        ledger, the effective capacity it is measured against, the
        pressure flags, the ACTIVE affinity keys (admitted debate ids
        — the least-affine scale-in victim is picked by who primarily
        owns fewest of these), and the model mix (model → active-
        debate count, hottest first feeds the warm-replica residency
        preload). One lock acquire; safe from any thread."""
        with self._lock:
            mix: dict[str, int] = {}
            for models in self._debate_models.values():
                for m in models:
                    mix[m] = mix.get(m, 0) + 1
            prefill_backlog = sum(self._reserved_prefill.values())
            return {
                "backlog_tokens": self._backlog(),
                # The per-role split (fleet disaggregation): prefill is
                # the sub-ledger of prompt-token reservations, decode
                # the remainder — the autoscaler sizes each pool off
                # its own half.
                "prefill_backlog_tokens": prefill_backlog,
                "decode_backlog_tokens": max(
                    0, self._backlog() - prefill_backlog
                ),
                "capacity_tokens": self._capacity_tokens(
                    serve_mod.config()
                ),
                "brownout": self.brownout,
                "draining": self.draining,
                "active_keys": list(self._reserved),
                "model_mix": dict(
                    sorted(mix.items(), key=lambda kv: (-kv[1], kv[0]))
                ),
            }

    def state_snapshot(self) -> dict:
        """The ``stats`` protocol op's scheduler view."""
        with self._lock:
            return {
                "backlog_tokens": self._backlog(),
                "brownout": self.brownout,
                "draining": self.draining,
                "running_units": len(self._running),
                "queued_units": {
                    tier: {t: len(q) for t, q in qs.items() if q}
                    for tier, qs in self._queues.items()
                },
                "outstanding_debates": {
                    t: n for t, n in self._outstanding.items() if n
                },
                "quota_remaining": dict(self._quota),
                "drain_rate_tokens_per_s": round(self._drain_rate(), 1),
            }
