"""Round orchestration: fan a spec out to N opponents, collect responses.

The PyTorch port's copy of ``adversarial_spec_tpu/debate/core.py``. It
resolves engines through the port's ``engine/dispatch.py`` at call time
(``mock://`` → ``MockEngine``, ``tpu://`` → ``GpuEngine``), where the
reference binds its own ``get_engine`` at import.

Reference hot path: ``run_critique`` → ``call_models_parallel`` →
ThreadPoolExecutor(thread per model) → per-model HTTP/subprocess call
(scripts/debate.py:798-888, models.py:681-722). TPU-native restructure
(SURVEY §1 "TPU mapping"): opponents are *grouped by engine* and each group is
executed as ONE batched ``chat`` call — on the TPU engine that is N rows of a
single sharded decode over the mesh, not N threads. The retry loop survives
(it now covers recompile/OOM/transient device errors instead of HTTP 429s)
with the reference's exact policy: 3 attempts, exponential backoff 1s/2s/4s
(models.py:46-47), errors captured rather than raised, and rounds degrading
gracefully when some opponents fail (debate.py:845-853).

On top of that policy sits the per-model circuit breaker
(resilience/breaker.py): every completion outcome feeds the model's
breaker, and a model whose breaker is OPEN is degraded up front — zero
engine calls, zero retry budget — until its cooldown elapses and a
half-open probe re-admits it. Persistent failure costs one errored
response per round instead of 3 retries x backoff.

Launched one process per host (``cli critique`` on every host under the
env contract), every process runs the round and its engine calls are
collectives, so every process must take the same branches. The branches
that read a clock (the round deadline, the breakers' cooldowns) decide
through ``_agreed``: true when true on any process.
"""

from __future__ import annotations

import dataclasses
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

from adversarial_spec_tpu_torch import obs as obs_mod
from adversarial_spec_tpu_torch.debate import journal as journal_mod
from adversarial_spec_tpu_torch.debate import prompts
from adversarial_spec_tpu_torch.debate.parsing import (
    StreamScanner,
    detect_agreement,
    extract_spec,
    has_malformed_spec,
)
from adversarial_spec_tpu_torch.debate.types import ModelResponse, RoundResult
from adversarial_spec_tpu_torch.engine import streaming as stream_mod
from adversarial_spec_tpu_torch.engine import dispatch
from adversarial_spec_tpu_torch.engine.types import ChatRequest, Completion, SamplingParams
from adversarial_spec_tpu_torch.resilience import breaker as breaker_mod
from adversarial_spec_tpu_torch.resilience import faults as faults_mod
from adversarial_spec_tpu_torch.resilience.faults import FaultKind, classify_message
from adversarial_spec_tpu_torch.utils.tracing import Tracer

MAX_RETRIES = 3
RETRY_BASE_DELAY = 1.0
# A watchdog-expired opponent gets ONE hedged re-admission on this
# fraction of its original per-request deadline — the slot already
# burnt a full deadline's worth of decode, so the second chance must
# not double the round's worst-case wall.
HEDGE_BUDGET_FACTOR = 0.5


def _agreed(flag: bool) -> bool:
    """A decision that reads a clock (a deadline passed, a breaker's
    cooldown over), taken alike by every process of a launch one process
    a host: true when it is true on any process
    (``parallel/collectives.py`` ``agree_any``). One process: ``flag``.
    A process that never imported torch has no process group, and mock
    opponents import none."""
    if "torch.distributed" not in sys.modules:
        return flag
    from adversarial_spec_tpu_torch.parallel.collectives import agree_any

    return agree_any(flag)


@dataclass
class RoundConfig:
    """Everything that shapes one critique round's prompts and decode."""

    doc_type: str = "generic"
    focus: str | None = None
    persona: str | None = None
    preserve_intent: bool = False
    press: bool = False
    context_files: list[str] = field(default_factory=list)
    sampling: SamplingParams = field(default_factory=SamplingParams)
    # Per-model circuit breakers; None = the process default registry.
    # Tests pass their own (fake clock, tight thresholds).
    breakers: breaker_mod.BreakerRegistry | None = None
    # Crash-safe round journal (debate/journal.py RoundJournal, armed by
    # the CLI when a session is active and --journal is on; None = no
    # durability). run_round logs round-start + per-opponent completion
    # records through it and serves already-completed opponents from a
    # replay on resume.
    journal: object | None = None
    # Fleet placement identity (fleet/hashring.py): ONE stable id per
    # debate, so every round of this debate consistent-hashes onto the
    # replica already holding its prefix KV. The CLI sets it to the
    # session id; "" falls back to hashing the round's spec — rounds
    # of an unnamed one-shot debate still co-locate with each other
    # only while the spec's hash is stable.
    debate_id: str = ""
    # Trace-minting scope (obs/trace.py daemon scopes): "" keeps the
    # CLI's process-wide counter (tier-1 pins exact ids on it); the
    # serve daemon sets its per-debate id so concurrent rounds mint
    # from their OWN counters — deterministic per debate,
    # collision-free across the debates of one long-lived process.
    trace_scope: str = ""
    # Injected for tests; defaults to real sleep for backoff.
    sleep = staticmethod(time.sleep)


def load_context_files(paths: list[str]) -> str:
    """Concatenate supporting context files into a prompt block.

    Parity: reference scripts/models.py:130-146 — repeatable ``--context``
    flag, each file labeled, missing files raise with a clear message.
    """
    if not paths:
        return ""
    blocks = []
    for p in paths:
        path = Path(p)
        if not path.is_file():
            raise FileNotFoundError(f"context file not found: {p}")
        blocks.append(f"--- CONTEXT FILE: {path.name} ---\n{path.read_text()}")
    return "\n\n".join(blocks) + "\n\n"


def build_request(
    model: str, spec: str, round_num: int, cfg: RoundConfig
) -> ChatRequest:
    """Assemble one opponent's system+user messages."""
    system = prompts.get_system_prompt(
        doc_type=cfg.doc_type,
        focus=cfg.focus,
        persona=cfg.persona,
        preserve_intent=cfg.preserve_intent,
    )
    template = (
        prompts.PRESS_PROMPT_TEMPLATE if cfg.press else prompts.REVIEW_PROMPT_TEMPLATE
    )
    user = load_context_files(cfg.context_files) + template.format(
        round=round_num, spec=spec
    )
    return ChatRequest(model=model, system=system, user=user)


def _early_cancel_consumer():
    """One chat call's early-convergence stream consumer: an
    incremental marker scanner per batch row (parsing.StreamScanner
    over EARLY_CANCEL_MARKERS). The moment a row's verdict is
    decidable — its marker's last character arrives, however the
    stream was chunked — it returns False and the engine cancels that
    request mid-decode. The truncated transcript contains the full
    marker, so ``detect_agreement`` on it gives exactly the verdict
    the full text would; everything past the marker is decode the
    debate never reads (the matched-ceiling study's point: round
    COUNT, not round length, drives quality). Built fresh per attempt:
    a retried request streams from scratch."""
    scanners: dict[int, StreamScanner] = {}

    def consume(row: int, text: str) -> bool:
        sc = scanners.get(row)
        if sc is None:
            sc = scanners[row] = StreamScanner()
        return sc.feed(text) is None

    return consume


def _journal_fault(e: BaseException) -> None:
    """A journal failure must never kill the round: classify and count
    it (the injector's ``crash`` seam keeps its name; real I/O errors
    land at seam ``journal``), then move on — the round merely loses
    durability for that one record."""
    faults_mod.record(
        faults_mod.classify(e), getattr(e, "seam", None) or "journal"
    )


def _journal_safe(fn, *args, **kwargs) -> None:
    try:
        fn(*args, **kwargs)
    except Exception as e:
        _journal_fault(e)


def _to_response(
    model: str, comp: Completion, latency_s: float, span_id: str = ""
) -> ModelResponse:
    if not comp.ok:
        return ModelResponse(
            model=model,
            error=comp.error,
            usage=comp.usage,
            latency_s=latency_s,
            span_id=span_id,
        )
    resp = ModelResponse(
        model=model,
        critique=comp.text,
        agreed=detect_agreement(comp.text),
        revised_spec=extract_spec(comp.text),
        usage=comp.usage,
        latency_s=latency_s,
        span_id=span_id,
    )
    if has_malformed_spec(comp.text):
        # Parity: warn-not-crash on malformed [SPEC] (models.py:633-637);
        # surfaced via the response so the CLI can print the warning.
        resp.critique += "\n\n[warning: unterminated [SPEC] tag in response]"
    return resp


def run_round(
    spec: str,
    models: list[str],
    round_num: int = 1,
    cfg: RoundConfig | None = None,
) -> RoundResult:
    """Execute one critique round across all opponents.

    Opponents are grouped by serving engine; each group is one batched chat
    call. Transient per-request failures are retried with exponential
    backoff (3 attempts total, sleeping 1 s then 2 s between them — the
    reference's policy); retries re-batch only the failed requests, and a
    nonzero ``sampling.timeout_s`` bounds the whole round (no retry starts
    past the deadline).

    REENTRANT: the serve daemon runs many of these concurrently, one
    per debate thread. Everything mutable here is either local, lock-
    protected (breakers), per-session (journal), or thread-local (the
    ambient trace scope) — and ``cfg.trace_scope`` gives each debate
    its own id counter so concurrent rounds never collide.
    """
    cfg = cfg or RoundConfig()
    # The debate layer's own tracer: per-opponent chat walls + attempt
    # counters, merged into the CLI's round tracer (Tracer.merge) so the
    # engine-level and debate-level spans compose into one report.
    tracer = Tracer()
    breakers = (
        cfg.breakers
        if cfg.breakers is not None
        else breaker_mod.default_registry()
    )
    deadline = (
        time.monotonic() + cfg.sampling.timeout_s
        if cfg.sampling.timeout_s > 0
        else None
    )
    # Causal tracing (obs/trace.py): ONE trace per round, ONE span per
    # opponent request, minted HERE — above any engine choice — so the
    # mock and real serving paths carry byte-identical ids for the same
    # invocation sequence. The ids ride the requests by value; the
    # ambient scope below covers emitters that don't know their request.
    trace_id = obs_mod.trace.mint_trace(
        round_num, scope=cfg.trace_scope or None
    )
    # Fleet routing key (fleet/router.py): the whole debate shares one
    # affinity key, so a fleet places all its rounds on one replica —
    # where the document prefix's KV already lives.
    affinity = cfg.debate_id or journal_mod.spec_sha(spec)[:16]
    requests = [
        dataclasses.replace(
            build_request(m, spec, round_num, cfg),
            trace_id=trace_id,
            span_id=obs_mod.trace.mint_span(trace_id, i),
            affinity_key=affinity,
        )
        for i, m in enumerate(models)
    ]

    results: list[ModelResponse | None] = [None] * len(requests)

    # Crash recovery (debate/journal.py): replay the session's
    # write-ahead journal and serve opponents whose completion records
    # are already durable — zero engine work, byte-identical
    # transcripts (the record feeds the same ``_to_response`` the live
    # path uses). Everything else — errored, partial, never started —
    # re-issues below; the breaker snapshot restored onto the registry
    # still vetoes models whose circuit was open when the process died.
    # Journaling is best-effort by contract: any journal failure is
    # contained (``_journal_safe``) and the round proceeds unjournaled.
    journal = cfg.journal
    replayed: dict[int, dict] = {}
    if journal is not None:
        try:
            journal.ensure_round_start(
                round_num,
                spec,
                models,
                {
                    "doc_type": cfg.doc_type,
                    "focus": cfg.focus,
                    "persona": cfg.persona,
                    "preserve_intent": cfg.preserve_intent,
                    "press": cfg.press,
                },
                trace_id=trace_id,
            )
            replayed = journal.replay(round_num, spec, models)
        except Exception as e:
            _journal_fault(e)
            replayed = {}
    for i, rec in sorted(replayed.items()):
        comp, rec_latency = journal_mod.completion_from_record(rec)
        results[i] = _to_response(
            models[i], comp, rec_latency, requests[i].span_id
        )
        tracer.count("journal.served", 1)
        tracer.count(
            "journal.salvaged_decode_tokens",
            float(results[i].usage.output_tokens),
        )
        if obs_mod.config().enabled:
            obs_mod.emit(
                obs_mod.JournalEvent(
                    op="serve",
                    rtype="completion",
                    round_num=round_num,
                    index=i,
                    trace_id=trace_id,
                    span_id=requests[i].span_id,
                )
            )

    # Group indices by engine so co-resident models batch together. A
    # model whose circuit breaker is open degrades HERE — no engine call,
    # no retry budget — and rejoins after its cooldown's half-open probe.
    groups: dict[int, tuple[object, list[int]]] = {}
    for i, req in enumerate(requests):
        if results[i] is not None:
            continue  # served from the journal above
        if not _agreed(breakers.allow(req.model)):
            remaining = breakers.cooldown_remaining(req.model)
            results[i] = ModelResponse(
                model=req.model,
                error=(
                    "circuit open: skipped after repeated faults "
                    f"(probe in {remaining:.0f}s)"
                ),
                span_id=req.span_id,
            )
            continue
        engine = dispatch.get_engine(req.model)
        groups.setdefault(id(engine), (engine, []))[1].append(i)

    if journal is not None and replayed:
        n_reissued = sum(len(ix) for _, ix in groups.values())
        obs_mod.emit(
            obs_mod.RecoveryEvent(
                round_num=round_num,
                served=len(replayed),
                reissued=n_reissued,
                records=getattr(journal, "replay_records", len(replayed)),
                skipped=getattr(journal, "replay_skipped", 0),
                trace_id=trace_id,
            )
        )
        if obs_mod.config().enabled:
            obs_mod.metrics.counter(
                "advspec_recovery_requests_total",
                help="opponents resolved on a journal replay, by source",
                source="journal",
            ).inc(len(replayed))
            obs_mod.metrics.counter(
                "advspec_recovery_requests_total", source="reissued"
            ).inc(n_reissued)

    # The round's ambient trace scope: every event emitted below this
    # frame — engine fan-in counters, scheduler steps, prefix-cache and
    # tier ops, retrace compiles — inherits the round's trace_id unless
    # its emitter stamped a more specific span. Round/opponent SpanEvents
    # are ORDERING markers (wall_s 0): the debate layer's walls are real
    # host time, which would break the mock round's byte-deterministic
    # JSONL pin — the measured per-request decomposition lives in the
    # engine-emitted request spans (and, for humans, in the report's
    # latency_s), not here.
    obs_mod.trace.set_ambient(trace_id, "")
    obs_mod.emit(
        obs_mod.SpanEvent(name="round", phase="begin", trace_id=trace_id)
    )
    for i, req in enumerate(requests):
        obs_mod.emit(
            obs_mod.SpanEvent(
                name="opponent",
                phase="begin",
                req_id=i,
                trace_id=trace_id,
                span_id=req.span_id,
            )
        )
        if results[i] is not None:
            # Breaker-open degrade resolved this opponent above with
            # zero engine calls — close its span immediately so the
            # stream never carries a begun-but-never-ended opponent
            # for a request that already has its response.
            obs_mod.emit(
                obs_mod.SpanEvent(
                    name="opponent",
                    phase="end",
                    req_id=i,
                    trace_id=trace_id,
                    span_id=req.span_id,
                )
            )
    try:
        for engine, indices in groups.values():
            # Streaming early cancellation (docs/streaming.md): when
            # armed AND the engine's chat exposes the consumer seam,
            # each request streams through a marker scanner and stops
            # the moment its verdict is decidable. Engines without the
            # seam (test fakes, the dense fallback) serve the blocking
            # path unchanged.
            stream_ok = stream_mod.armed() and stream_mod.consumer_supported(
                engine
            )

            def _chat(batch, sampling, engine=engine, stream_ok=stream_ok):
                return (
                    engine.chat(
                        batch, sampling, consumer=_early_cancel_consumer()
                    )
                    if stream_ok
                    else engine.chat(batch, sampling)
                )

            def _resolve(i: int, comp: Completion, latency: float) -> None:
                """Final resolution of one opponent: build the response,
                make the outcome durable (a clean completion becomes a
                replayable journal record THE MOMENT it resolves; an
                evicted request's salvaged partial text is journaled
                for diagnosis, never replayed), close its span."""
                results[i] = _to_response(
                    requests[i].model, comp, latency, requests[i].span_id
                )
                if journal is not None:
                    if comp.ok:
                        _journal_safe(
                            journal.log_completion,
                            round_num,
                            i,
                            requests[i].model,
                            comp,
                            latency,
                            trace_id=trace_id,
                            span_id=requests[i].span_id,
                        )
                    elif comp.text:
                        _journal_safe(
                            journal.log_partial,
                            round_num,
                            i,
                            requests[i].model,
                            comp,
                            trace_id=trace_id,
                            span_id=requests[i].span_id,
                        )
                obs_mod.emit(
                    obs_mod.SpanEvent(
                        name="opponent",
                        phase="end",
                        req_id=i,
                        trace_id=trace_id,
                        span_id=requests[i].span_id,
                    )
                )

            hedge_armed = cfg.sampling.request_deadline_s > 0
            # (index, original completion, its latency): watchdog-
            # expired opponents awaiting their one hedged re-admission.
            hedge_pending: list[tuple[int, Completion, float]] = []
            pending = list(indices)
            for attempt in range(MAX_RETRIES):
                batch = [requests[i] for i in pending]
                t0 = time.monotonic()
                completions = _chat(batch, cfg.sampling)
                latency = time.monotonic() - t0
                tracer.add_span("engine_chat", latency)
                still_pending = []
                for i, comp in zip(pending, completions):
                    # The group's wall IS each rider's wall: rows of one
                    # batched decode finish together from the caller's
                    # view.
                    tracer.add_span(f"opponent/{requests[i].model}", latency)
                    tracer.count(f"attempts.{requests[i].model}", 1)
                    # Every attempt's outcome feeds the model's breaker:
                    # threshold consecutive failures open it. EXCEPT a
                    # serving-layer SHED (daemon quota/drain policy) —
                    # the model did nothing wrong, and a drain storm
                    # counting as N failures per opponent would open
                    # every circuit in the pool (found by the SIGTERM
                    # drain drill).
                    fail_kind = (
                        None
                        if comp.ok
                        else classify_message(comp.error or "")
                    )
                    if comp.ok:
                        breakers.record(requests[i].model, ok=True)
                    elif fail_kind is not FaultKind.SHED:
                        breakers.record(
                            requests[i].model, ok=False, kind=fail_kind
                        )
                    # A watchdog-expired request does NOT re-enter the
                    # 3-attempt backoff ladder (its per-request deadline
                    # already bounded it once; full retries would pay up
                    # to 3 more deadlines plus backoff): it gets exactly
                    # ONE hedged re-admission on a tightened budget
                    # after this group resolves — and only while its
                    # breaker still allows the model.
                    if (
                        hedge_armed
                        and not comp.ok
                        and classify_message(comp.error or "")
                        is FaultKind.TIMEOUT
                    ):
                        if _agreed(breakers.allow(requests[i].model)):
                            hedge_pending.append((i, comp, latency))
                        else:
                            _resolve(i, comp, latency)
                    # Retry only while the breaker still allows the
                    # model: a failed half-open probe reopens the circuit
                    # and must cost ONE attempt, not the full 3x backoff
                    # budget it exists to avoid.
                    elif (
                        not comp.ok
                        and comp.transient
                        and attempt < MAX_RETRIES - 1
                        and _agreed(breakers.allow(requests[i].model))
                    ):
                        still_pending.append(i)
                    else:
                        _resolve(i, comp, latency)
                pending = still_pending
                if not pending:
                    break
                if deadline is not None and _agreed(time.monotonic() >= deadline):
                    break  # round budget exhausted: no further retries
                cfg.sleep(RETRY_BASE_DELAY * (2**attempt))
            for i in pending:  # exhausted retries
                _resolve(i, Completion(error="retries exhausted"), 0.0)
            if hedge_pending and (
                deadline is not None and _agreed(time.monotonic() >= deadline)
            ):
                # Round budget exhausted: keep the watchdog partials.
                for i, orig, orig_lat in hedge_pending:
                    _resolve(i, orig, orig_lat)
            elif hedge_pending:
                # The single hedged re-admission: one more batched chat
                # for every deadline-evicted opponent, under a deadline
                # tightened to HEDGE_BUDGET_FACTOR of the original —
                # the freed slots re-admit immediately, and a model
                # that is genuinely hung (not merely slow) costs one
                # tightened deadline more, never another full ladder.
                tightened = dataclasses.replace(
                    cfg.sampling,
                    request_deadline_s=(
                        cfg.sampling.request_deadline_s
                        * HEDGE_BUDGET_FACTOR
                    ),
                )
                batch = [requests[i] for i, _, _ in hedge_pending]
                t0 = time.monotonic()
                completions = _chat(batch, tightened)
                latency = time.monotonic() - t0
                tracer.add_span("engine_chat", latency)
                for (i, orig, orig_lat), comp in zip(
                    hedge_pending, completions
                ):
                    tracer.add_span(f"opponent/{requests[i].model}", latency)
                    tracer.count(f"attempts.{requests[i].model}", 1)
                    tracer.count(f"hedge.{requests[i].model}", 1)
                    if comp.ok:
                        breakers.record(requests[i].model, ok=True)
                        _resolve(i, comp, latency)
                    else:
                        hedge_kind = classify_message(comp.error or "")
                        if hedge_kind is not FaultKind.SHED:
                            breakers.record(
                                requests[i].model, ok=False, kind=hedge_kind
                            )
                        # The hedge lost too: keep the ORIGINAL partial
                        # (more salvaged text, the first failure's true
                        # latency). No third attempt.
                        _resolve(i, orig, orig_lat)
    finally:
        obs_mod.emit(
            obs_mod.SpanEvent(name="round", phase="end", trace_id=trace_id)
        )
        obs_mod.trace.set_ambient("", "")

    return RoundResult(
        responses=[r for r in results if r is not None],
        round_num=round_num,
        tracer=tracer,
        trace_id=trace_id,
    )
