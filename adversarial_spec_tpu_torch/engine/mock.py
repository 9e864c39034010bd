"""Scripted mock engine — the fake backend at the engine seam.

The PyTorch port's copy of ``adversarial_spec_tpu/engine/mock.py``. It
implements the same ``Engine`` interface as ``GpuEngine``, so the whole
debate loop — CLI, rounds, parsing, convergence, sessions, cost — runs
unmodified on the CPU with scripted critiques, and its ``--json`` reports
match the reference mock's. The lower KV tiers (host RAM, disk store;
``engine/kvtier.py``) attach as the reference's do, and so does the
fleet's disaggregated handoff (``prefill`` publishes a request's blocks
to the shared store, ``prefetch`` probes it), which only this engine
has.

Model-id grammar (query params configure behavior):

- ``mock://agree``                      — replies [AGREE] immediately.
- ``mock://critic``                     — critiques forever, revising the spec.
- ``mock://critic?agree_after=3``       — critiques rounds 1-2, agrees from 3.
- ``mock://tasks``                      — emits structured [TASK] blocks
                                          (for export-tasks flows).
- ``mock://error``                      — permanent failure every call.
- ``mock://flaky?fail=2``               — transient failures on the first 2
                                          calls, then behaves like ``critic``.
- any id with ``&tps=N``                — simulates N tokens/sec decode speed
                                          in the reported usage (no sleeping).
- agreeing ids with ``&agree_tail=N``   — append N deterministic filler
                                          remarks AFTER the [AGREE] marker:
                                          the decode early cancellation
                                          exists to avoid paying for
                                          (bench.py --mode cancel).

Streaming parity works the same way (engine/streaming.py): a consumer
passed to ``chat`` receives the reply in fixed-width character chunks
(markers split across deliveries, like real token boundaries), and a
consumer returning False truncates the reply at that chunk boundary —
the transcript is the blocking reply's byte-identical prefix. The
cancel is accounted in ``perf.stream`` (tokens saved = the full reply's
remainder) and emits the scheduler's exact schema (CancelEvent, the
``cancelled`` lifecycle state, the request span closing with a
``cancelled`` phase), so the whole cancellation pipeline pins
deterministically on CPU.

The round number is recovered from the round template's "Debate round {N}"
header (prompts.REVIEW_PROMPT_TEMPLATE), the same information a real opponent
sees.

Prefix-cache parity: every chat request is routed through the SAME
``PageAllocator`` + ``PrefixCache`` machinery the TPU scheduler uses
(engine/prefix_cache.py) — the mock "tokenizer" chunks the prompt text
into fixed-width pieces, so hit-rates and tokens-saved are deterministic
on CPU and tier-1 tests can pin them without a TPU. There is no device
pool here: the cache tracks accounting only, and ``Usage.cached_tokens``
/ the process-wide stats reflect what a real engine would have skipped.

Tiered-KV parity works the same way (engine/kvtier.py): the mock's
prefix cache carries the SAME host/disk tiers the scheduler attaches —
LRU-evicted blocks demote (payload ``None``; the state machine is
content-free), tiered lookups continue past the device radix, promoted
and rehydrated blocks count as cached, and the disk store (keyed by a
mock-namespace fingerprint) persists across engine instances, so
restart-rehydration hit rates pin deterministically on CPU.

Trace parity works the same way (obs/trace.py): each request's chat
runs under its own ambient trace scope, so every event the accounting
emits stamps the round/opponent ids minted by the debate layer, and the
per-request span set (queued/prefill/decode under a ``request``
envelope) carries SYNTHETIC walls on the tokens/1024 second-scale —
the tools/trace_view.py waterfall and its checked decomposition pin
byte-deterministically on CPU, SLO breach capture included.

Weight-residency parity works the same way (engine/weightres.py): under
an EXPLICIT ``ADVSPEC_HBM_BUDGET_BYTES`` (the bench/test trigger — the
simulation stays off otherwise, so pre-residency mock event streams are
byte-identical), each distinct mock model id occupies a nominal 64 MiB
of "HBM": a round's model groups serve RESIDENT-FIRST, an over-budget
load demotes (or, with ``--no-weight-res``, frees) the LRU model, and a
demoted model's next turn promotes instead of re-loading — with
synthetic walls on exact binary fractions (load = bytes/1 GiB/s,
promote = load/8, demote = load/16), so the thrash-vs-resident
weight-load seconds, swap events, and the ``perf.weights`` payload pin
byte-deterministically on CPU.

Interleave parity works the same way (engine/interleave.py): the first
request of a ``chat`` batch prefills with nothing resident to overlap
(stalled), every later request's prefill rides the residents' decode
(overlapped, when the fused loop is enabled). Synthetic seconds are
``tokens / 1024`` — exact binary fractions, so the stalled + overlapped
== prefill invariant the CLI's ``perf.interleave`` block promises is
pinnable with ``==`` on CPU.
"""

from __future__ import annotations

import re
from urllib.parse import parse_qs, urlparse

from adversarial_spec_tpu_torch import obs as obs_mod
from adversarial_spec_tpu_torch.debate.usage import Usage
from adversarial_spec_tpu_torch.engine import streaming as stream_mod
from adversarial_spec_tpu_torch.engine import weightres as weightres_mod
from adversarial_spec_tpu_torch.engine.types import ChatRequest, Completion, SamplingParams

_ROUND_RE = re.compile(r"Debate round (\d+)")

# Weight-residency simulation scale: nominal HBM bytes per distinct
# mock model, and the synthetic transfer rates (exact binary fractions
# so every derived wall pins with == on CPU). A "load" moves the bytes
# at 1 GiB/s, a promotion at 8 GiB/s (host RAM is that much closer than
# a checkpoint conversion), a demotion at 16 GiB/s (async gather).
_MODEL_BYTES = 64 << 20
_GIB = 1 << 30

# Streaming delivery granularity: the reply streams to the consumer in
# fixed-width character chunks. Width 5 on purpose — "[AGREE]" is 7
# characters, so the verdict marker routinely SPLITS across deliveries,
# which is exactly the case the incremental scanner
# (debate/parsing.StreamScanner) must handle.
_STREAM_CHUNK_CHARS = 5

# Mock prefix-cache geometry. A "token" is _TOKEN_CHARS characters of
# system+user text (matching _estimate_tokens' 4-chars-per-token rule, so
# cached_tokens is on the same scale as input_tokens); a page is
# _PAGE_TOKENS tokens — fine enough that a grown spec's unchanged head
# mostly re-hits, coarse enough to keep the radix index small.
_TOKEN_CHARS = 4
_PAGE_TOKENS = 16
_POOL_PAGES = 8192

_CRITIQUES = [
    "The error-handling section does not define behavior when the backing "
    "store is unavailable; specify a timeout, retry policy, and user-facing "
    "failure mode.",
    "Success metrics are unmeasurable as written; attach a concrete metric "
    "and measurement window to each goal.",
    "The API section omits versioning; define how breaking changes reach "
    "old clients.",
    "No capacity assumptions are stated; add expected request rate and data "
    "growth, and size the design against 10x those numbers.",
    "The rollout section lacks a rollback trigger; define the metric "
    "threshold that aborts the rollout.",
]


def _estimate_tokens(text: str) -> int:
    """Cheap whitespace-ish token estimate (parity: the reference estimates
    tokens for CLI providers that report none, scripts/models.py:274-454)."""
    return max(1, len(text) // 4)


class MockEngine:
    """Deterministic scripted engine; safe to share across calls."""

    def __init__(self) -> None:
        # Per-model-id call counter, for flaky/fail-N behaviors. Mutated
        # only from the (single-threaded) debate core.
        self._calls: dict[str, int] = {}
        # Prefix-cache accounting (lazy: only when the cache is enabled).
        self._allocator = None
        self._prefix = None
        self._seq = 0
        # Weight-residency accounting (lazy: only under an explicit
        # ADVSPEC_HBM_BUDGET_BYTES — see module docstring).
        self._weights = None

    @property
    def ledger(self):
        """The residency ledger (the engine-seam name the chaos/check
        paths share with TpuEngine); None until the simulation armed."""
        return self._weights

    def _sim_residency(self, requests: list[ChatRequest]) -> None:
        """Drive the weight-residency state machine for this chat's
        model groups, deterministically (see module docstring): groups
        serve resident-first, over-budget loads demote-or-free the LRU
        model, demoted models promote on their next turn. Accounting
        only — replies are computed per request in submission order
        either way, so transcripts are byte-identical with the
        simulation on, off, or thrashing."""
        budget = weightres_mod.mock_budget_bytes()
        if budget is None:
            return
        if self._weights is None:
            self._weights = weightres_mod.WeightLedger()
        led = self._weights
        models: list[str] = []
        for r in requests:
            if r.model not in models:
                models.append(r.model)
        models = led.resident_first(models)
        for gi, model in enumerate(models):
            if led.is_resident(model):
                led.touch(model)
                continue
            # Make room first (the engine's evict-before-materialize
            # rule): every over-budget resident demotes or frees.
            while (
                led.resident_models
                and (led.resident_models + 1) * _MODEL_BYTES > budget
            ):
                victim = led.lru_resident_alias()
                if victim is None:
                    break
                if weightres_mod.paging_armed():
                    led.demote_model(
                        victim,
                        None,
                        _MODEL_BYTES,
                        _MODEL_BYTES / (16 * _GIB),
                    )
                else:
                    led.free_model(victim)
            # Groups after the first ride the previous group's decode
            # (the engine's prefetch-thread overlap, deterministically).
            overlapped = gi > 0
            if led.is_host(model):
                led.promote_model(
                    model,
                    _MODEL_BYTES,
                    _MODEL_BYTES / (8 * _GIB),
                    overlapped=overlapped,
                )
            else:
                led.admit_load(
                    model, _MODEL_BYTES, _MODEL_BYTES / _GIB
                )

    def validate(self, model: str) -> str | None:
        if not model.startswith("mock://"):
            return f"not a mock model id: {model}"
        return None

    @staticmethod
    def _account_interleave(
        n_tokens: int, overlapped: bool, req_index: int = 0
    ) -> None:
        """Deterministic CPU mirror of the scheduler's fused-step
        telemetry: this request's prefill either stalled the (synthetic)
        batch or rode an earlier resident's decode. Synthetic seconds
        are tokens/1024 — exact in float, so perf.interleave's
        ``stalled + overlapped == prefill`` invariant pins with ==.

        Emits the SAME observability schema the real scheduler does
        (StepEvent + step/prefill/TTFT metrics), with the synthetic
        seconds as the observed values — so the whole obs pipeline
        (events JSONL, Prometheus text) pins byte-deterministically on
        CPU without a TPU in the loop."""
        from adversarial_spec_tpu_torch.engine import interleave as interleave_mod

        overlapped = overlapped and interleave_mod.config().enabled
        synth_s = n_tokens / 1024.0
        interleave_mod.stats.record_prefill_time(
            synth_s, overlapped=overlapped
        )
        interleave_mod.stats.record_step(
            fused=overlapped, prefill_only=not overlapped
        )
        if obs_mod.config().enabled:
            obs_mod.hot.prefill_chunk.observe(synth_s)
            obs_mod.hot.ttft.observe(synth_s)
            obs_mod.emit(
                obs_mod.StepEvent(
                    kind="fused" if overlapped else "prefill",
                    n_live=req_index if overlapped else 0,
                    admission_slot=req_index,
                    prefill_tokens=n_tokens,
                )
            )

    @staticmethod
    def _account_spec(
        req: ChatRequest, text: str, req_index: int = 0
    ) -> None:
        """Deterministic CPU mirror of the scheduler's per-slot
        prompt-lookup speculation: step through this reply's token
        chunks exactly the way the batcher's verify loop would — draft
        γ tokens after the most recent [prev, cur] bigram match in the
        context (prompt + emitted so far), accept the longest prefix
        matching the actual continuation, emit accepted+1 — and record
        the SAME stats/events schema (``perf.spec``, SpecEvents, the
        tokens-per-step and acceptance histograms), so the whole
        speculation pipeline pins on CPU without a TPU. The mock
        "model" is greedy and its output IS the target distribution's
        argmax, so prompt-lookup acceptance here is exact string
        matching — high on the [SPEC] revision (a near-copy of the
        prompt), low on fresh prose, zero when the bigram never
        recurs.

        Tokenization here is whitespace words, NOT the prefix-cache
        accounting's fixed 4-char chunks: a fixed-offset chunking of
        the reply never aligns with the prompt's chunking of the same
        substring (the copy sits at an arbitrary offset mod 4), so
        chunk-wise acceptance would be identically zero. A real BPE
        re-tokenizes a copied substring to the same ids regardless of
        its byte offset — word splitting is the offset-stable mock of
        that property."""
        from adversarial_spec_tpu_torch.engine import spec as spec_mod

        if not spec_mod.config().enabled:
            return
        gamma = spec_mod.config().gamma
        span = gamma + 1
        ctx = (req.system + "\n" + req.user).split()
        out = text.split()
        # Most-recent-bigram index over the growing context, the host
        # analog of speculative._draft's reverse scan. A bigram is
        # registered only once it is INTERIOR (a newer token landed
        # after it): the bigram ending at the context's final index IS
        # the query — indexing it too would make every lookup find
        # itself and every draft empty.
        last: dict[tuple[str, str], int] = {
            (ctx[m - 1], ctx[m]): m for m in range(1, len(ctx) - 1)
        }
        steps = drafted = accepted = 0
        i = 0
        obs_on = obs_mod.config().enabled
        while i < len(out):
            n_allowed = min(gamma, len(out) - i - 1)
            k = 0
            if n_allowed > 0 and len(ctx) >= 2:
                m = last.get((ctx[-2], ctx[-1]))
                if m is not None:
                    draft = ctx[m + 1 : m + 1 + gamma]
                    while (
                        k < n_allowed
                        and k < len(draft)
                        and draft[k] == out[i + k]
                    ):
                        k += 1
            n_emit = k + 1
            for tok in out[i : i + n_emit]:
                if len(ctx) >= 2:
                    last[(ctx[-2], ctx[-1])] = len(ctx) - 1
                ctx.append(tok)
            i += n_emit
            steps += 1
            drafted += n_allowed
            accepted += k
            spec_mod.stats.record_step(n_allowed, k, n_emit)
            # Synthetic step wall: ONE batched forward per verify step,
            # 1/1024 s (the same tokens/1024 second-scale the interleave
            # accounting uses), split by the position-share convention.
            spec_mod.stats.record_wall(
                (1 / 1024) / (span + 1), (1 / 1024) * span / (span + 1)
            )
            if obs_on:
                obs_mod.hot.spec_tokens_per_step.observe(float(n_emit))
                obs_mod.emit(
                    obs_mod.SpecEvent(
                        slot=req_index,
                        req_id=req_index,
                        drafted=n_allowed,
                        accepted=k,
                        emitted=n_emit,
                    )
                )
        if obs_on and drafted:
            obs_mod.hot.spec_acceptance.observe(accepted / drafted)

    @staticmethod
    def _emit_lifecycle(
        req_index: int,
        in_tokens: int,
        cached: int,
        out_tokens: int,
        span_id: str = "",
        cancelled: bool = False,
    ) -> None:
        """The scheduler's RequestEvent lifecycle, deterministically:
        queued → admitted → prefill → decode → finished, one synthetic
        slot per request, plus the scheduler's per-request causal-trace
        spans (queued/prefill/decode under a ``request`` envelope) with
        SYNTHETIC walls on the same tokens/1024 second-scale the
        interleave accounting uses — so the waterfall decomposition
        (prefill + decode == request service wall, the sum
        ``tools/trace_view.py`` checks) pins EXACTLY on CPU. Same
        schema, pinnable bytes. The SLO gates see the synthetic walls
        too, so breach capture pins without a TPU."""
        if not obs_mod.config().enabled:
            return
        transitions = (
            ("queued", in_tokens),
            ("admitted", in_tokens),
            ("prefill", in_tokens - cached),
            ("decode", out_tokens),
            ("cancelled" if cancelled else "finished", out_tokens),
        )
        prefill_s = (in_tokens - cached) / 1024.0
        decode_s = out_tokens / 1024.0
        # A cancelled request's envelope closes with the ``cancelled``
        # phase and its service wall SO FAR — still exactly
        # prefill + decode, so trace_view's decomposition check covers
        # cancelled requests (the scheduler's truncated span set).
        spans = (
            ("request", "begin", 0.0),
            ("queued", "begin", 0.0),
            ("queued", "end", 0.0),
            ("prefill", "begin", 0.0),
            ("prefill", "end", prefill_s),
            ("decode", "begin", 0.0),
            ("decode", "end", decode_s),
            (
                "request",
                "cancelled" if cancelled else "end",
                prefill_s + decode_s,
            ),
        )
        for state, tokens in transitions:
            obs_mod.emit(
                obs_mod.RequestEvent(
                    req_id=req_index,
                    state=state,
                    slot=req_index,
                    tokens=tokens,
                    cached_tokens=cached,
                    # Only the queue transition carries the arrival
                    # stamp (0.0 unless ADVSPEC_OBS_ARRIVALS armed —
                    # the byte-determinism pins see all zeros).
                    arrival_s=(
                        obs_mod.arrival_now() if state == "queued" else 0.0
                    ),
                )
            )
        for name, phase, wall in spans:
            obs_mod.emit(
                obs_mod.SpanEvent(
                    name=name,
                    phase=phase,
                    req_id=req_index,
                    slot=req_index,
                    wall_s=wall,
                    span_id=span_id,
                )
            )
        if not cancelled:
            # Cancelled requests count through advspec_cancelled_total
            # (emitted by the caller), not the finished outcome.
            obs_mod.hot.req_finished.inc()
        obs_mod.slo_check("ttft", span_id, prefill_s)
        obs_mod.slo_check("round", span_id, prefill_s + decode_s)

    def _ensure_prefix(self) -> None:
        """Build the allocator + prefix cache (and attach the KV tiers
        when armed) on first use — also reachable through ``prefetch``,
        so a COLD decode replica can probe the shared store before its
        first request ever admits."""
        from adversarial_spec_tpu_torch.engine import prefix_cache as prefix_mod

        if self._prefix is not None:
            return
        from adversarial_spec_tpu_torch.engine import kvtier as kvtier_mod
        from adversarial_spec_tpu_torch.engine.kvcache import PageAllocator

        self._allocator = PageAllocator(_POOL_PAGES, _PAGE_TOKENS)
        self._prefix = prefix_mod.PrefixCache(
            self._allocator,
            max_pages=prefix_mod.config().max_pages,
        )
        if kvtier_mod.armed():
            # Same tier state machine as the scheduler, accounting
            # only: nominal block bytes (no KV exists here) and a
            # mock-namespace store fingerprint, so a real engine
            # can never rehydrate accounting-only entries.
            tiers = kvtier_mod.build_for(
                _PAGE_TOKENS * 64,
                ("mock", _TOKEN_CHARS, _PAGE_TOKENS),
            )
            if tiers is not None:
                self._prefix.attach_tiers(tiers)

    def _account_prefix(
        self,
        req: ChatRequest,
        overlapped: bool = False,
        req_index: int = 0,
    ) -> int:
        """Run this request's prompt through the real allocator + prefix
        cache (accounting only — no KV exists here) and return the token
        count served from cache. Counts prefilled/saved tokens into the
        process-wide stats either way, so cache-on/off runs compare."""
        from adversarial_spec_tpu_torch.engine import prefix_cache as prefix_mod

        text = req.system + "\x1f" + req.user
        tokens = [
            text[i : i + _TOKEN_CHARS]
            for i in range(0, len(text), _TOKEN_CHARS)
        ]
        if not prefix_mod.config().enabled:
            prefix_mod.stats.record_prefill(len(tokens), 0)
            self._account_interleave(len(tokens), overlapped, req_index)
            return 0
        self._ensure_prefix()
        # The cap is per-round CLI config; follow it on a live cache.
        self._prefix.max_pages = prefix_mod.config().max_pages
        alloc, cache = self._allocator, self._prefix
        if cache.tiers is not None:
            matched, pages, tier_hits = cache.lookup_tiered(tokens)
        else:
            matched, pages = cache.lookup(tokens)
            tier_hits = []
        seq = self._seq
        self._seq += 1
        alloc.new_sequence(seq)
        try:
            from adversarial_spec_tpu_torch.engine.kvcache import OutOfPages

            if matched:
                alloc.adopt(seq, pages, matched)
            try:
                cache.extend_evicting(seq, len(tokens) - matched)
            except OutOfPages:
                # Genuinely full even with an empty cache: account a
                # full prefill (a real engine would still serve the
                # request; only the reuse bookkeeping is skipped).
                prefix_mod.stats.record_prefill(len(tokens), 0)
                self._account_interleave(len(tokens), overlapped, req_index)
                return 0
            # Lower-tier blocks continuing the device match "promote":
            # the state machine is the scheduler's exactly — a hit that
            # lost the race (host LRU overflow between lookup and here)
            # degrades to accounted prefill.
            promoted = 0
            consumed = []
            for hit in tier_hits:
                ok, _payload = cache.tiers.materialize(hit)
                if not ok:
                    break
                promoted += len(hit.tokens)
                consumed.append(hit)
            # Consume BEFORE the radix insert (the scheduler's rule):
            # insert's cap enforcement may re-demote tail blocks into
            # the host tier, and consuming afterwards would pop them.
            for hit in consumed:
                cache.tiers.consume(hit, slot=req_index)
            n_full = len(tokens) // _PAGE_TOKENS
            if n_full:
                cache.insert(
                    tokens[: n_full * _PAGE_TOKENS],
                    alloc.table(seq)[:n_full],
                )
        finally:
            alloc.free_sequence(seq)
        if cache.tiers is not None:
            # The mock has no drive loop: settle (disk write-through of
            # the blocks just inserted) lands right here.
            cache.tiers.settle()
        cached = matched + promoted
        prefix_mod.stats.record_prefill(len(tokens) - cached, cached)
        self._account_interleave(len(tokens) - cached, overlapped, req_index)
        return cached

    @staticmethod
    def _chain_walk(req: ChatRequest) -> list[str]:
        """The request's full-page chain hashes, computed from the
        prompt text alone — exactly the chains ``lookup_tiered`` walks
        on the decode side, so they are the handoff hint's currency."""
        from adversarial_spec_tpu_torch.engine import kvtier as kvtier_mod

        text = req.system + "\x1f" + req.user
        tokens = [
            text[i : i + _TOKEN_CHARS]
            for i in range(0, len(text), _TOKEN_CHARS)
        ]
        chains: list[str] = []
        chain = ""
        for b in range(len(tokens) // _PAGE_TOKENS):
            key = tuple(tokens[b * _PAGE_TOKENS : (b + 1) * _PAGE_TOKENS])
            chain = kvtier_mod.chain_hash(chain, key)
            chains.append(chain)
        return chains

    def prefill(
        self, requests: list[ChatRequest], params: SamplingParams
    ) -> list[dict]:
        """Disaggregated prefill — the handoff's shipping half: run
        admission + prefix/tier accounting ONLY (no reply decodes),
        settle the produced blocks write-through to the shared disk
        store, and return each request's durable chain hashes. The
        decode-side replica prefetches those chains and its first step
        starts from a tier hit; a request whose blocks did not all
        land reports only the durable prefix, so the router's
        adopt-vs-degrade decision is store-accurate."""
        out: list[dict] = []
        for i, req in enumerate(requests):
            with obs_mod.trace_scope(req.trace_id, req.span_id):
                cached = self._account_prefix(
                    req, overlapped=i > 0, req_index=i
                )
                chains = self._chain_walk(req)
                tiers = (
                    self._prefix.tiers if self._prefix is not None else None
                )
                durable = (
                    tiers.publish_chains(chains, slot=i)
                    if tiers is not None
                    else []
                )
                in_tokens = _estimate_tokens(req.system) + _estimate_tokens(
                    req.user
                )
                out.append(
                    {
                        "chains": list(durable),
                        "blocks": len(durable),
                        "tokens": in_tokens,
                        "cached": cached,
                        "new_tokens": max(in_tokens - cached, 0),
                    }
                )
        return out

    def prefetch(self, chains) -> int:
        """Decode-side handoff hint: how many of the shipped chains
        this engine's tier store can already serve (the promotion
        itself happens on the adopting request's own tiered lookup —
        this is the ahead-of-admission probe)."""
        from adversarial_spec_tpu_torch.engine import prefix_cache as prefix_mod

        if not prefix_mod.config().enabled:
            return 0
        self._ensure_prefix()
        tiers = self._prefix.tiers
        if tiers is None:
            return 0
        return tiers.prefetch_chains(chains)

    def chat(
        self,
        requests: list[ChatRequest],
        params: SamplingParams,
        consumer=None,
    ) -> list[Completion]:
        # Request 0 prefills into an empty batch (stalled); every later
        # request's prefill would ride the residents' decode in the
        # fused scheduler loop (overlapped) — the deterministic CPU
        # analog of admit-while-decoding.
        if obs_mod.config().enabled:
            obs_mod.hot.mock_chat_requests.inc(len(requests))
        self._sim_residency(requests)
        return [
            self._one(
                req, params, overlapped=i > 0, req_index=i,
                consumer=consumer,
            )
            for i, req in enumerate(requests)
        ]

    def _one(
        self,
        req: ChatRequest,
        params: SamplingParams,
        overlapped: bool = False,
        req_index: int = 0,
        consumer=None,
    ) -> Completion:
        # The request's ambient trace scope: every event this request's
        # accounting emits (cache/tier/step/spec) stamps with its
        # trace/span, exactly as the scheduler scopes admissions.
        with obs_mod.trace_scope(req.trace_id, req.span_id):
            return self._one_traced(
                req, params, overlapped, req_index, consumer
            )

    @staticmethod
    def _stream_text(req_index: int, text: str, consumer) -> tuple[str, bool]:
        """Deterministic CPU mirror of the batcher's streaming
        delivery: the reply streams in ``_STREAM_CHUNK_CHARS``-wide
        chunks (each call the text SO FAR — the engine-seam contract),
        and a consumer returning False truncates the reply at that
        chunk boundary, so the transcript is the blocking reply's
        byte-identical prefix. Deliveries are accounted exactly the
        way the scheduler's ``_deliver_stream`` does — one
        ``record_delivery`` per callback that carried NEW (estimated)
        tokens — so ``perf.stream`` deliveries/streamed_tokens mean
        the same thing on both engines. Returns (possibly truncated
        text, cancelled?). A raising consumer disables streaming for
        the rest of the reply — the scheduler's containment rule."""
        pos = 0
        last_tokens = 0
        while pos < len(text):
            pos = min(pos + _STREAM_CHUNK_CHARS, len(text))
            cur_tokens = _estimate_tokens(text[:pos])
            if cur_tokens > last_tokens:
                stream_mod.stats.record_delivery(cur_tokens - last_tokens)
                last_tokens = cur_tokens
            try:
                keep = bool(consumer(req_index, text[:pos]))
            except Exception:
                return text, False
            if not keep:
                return text[:pos], True
        return text, False

    def _one_traced(
        self,
        req: ChatRequest,
        params: SamplingParams,
        overlapped: bool = False,
        req_index: int = 0,
        consumer=None,
    ) -> Completion:
        parsed = urlparse(req.model)
        behavior = parsed.netloc or parsed.path.lstrip("/")
        opts = {k: v[-1] for k, v in parse_qs(parsed.query).items()}
        self._calls[req.model] = self._calls.get(req.model, 0) + 1
        n_call = self._calls[req.model]

        m = _ROUND_RE.search(req.user)
        round_num = int(m.group(1)) if m else 1

        if behavior == "tasks":
            cached = self._account_prefix(req, overlapped, req_index)
            text = (
                "[TASK]\ntitle: Define data model\ndescription: Schema and "
                "migrations for the core entities.\npriority: critical\n"
                "dependencies:\nestimate: 1d\n[/TASK]\n"
                "[TASK]\ntitle: Implement API\ndescription: CRUD endpoints "
                "with validation and error handling.\npriority: high\n"
                "dependencies: Define data model\nestimate: 2d\n[/TASK]\n"
                "[TASK]\ntitle: Add observability\ndescription: Metrics, "
                "structured logs, and alerts for the API.\npriority: medium\n"
                "dependencies: Implement API\nestimate: 1d\n[/TASK]"
            )
            out_tokens = _estimate_tokens(text)
            in_tokens = _estimate_tokens(req.system) + _estimate_tokens(
                req.user
            )
            self._account_spec(req, text, req_index)
            self._emit_lifecycle(
                req_index, in_tokens, cached, out_tokens, req.span_id
            )
            return Completion(
                text=text,
                usage=Usage(
                    # system + user, like the critic branch: the prefix
                    # accounting covers both, and cached_tokens must
                    # stay a subset of input_tokens.
                    input_tokens=in_tokens,
                    output_tokens=out_tokens,
                    decode_tokens=out_tokens,
                    cached_tokens=cached,
                ),
            )
        if behavior == "error":
            return Completion(
                error=f"mock permanent failure (call {n_call})", transient=False
            )
        if behavior == "flaky":
            fail_n = int(opts.get("fail", "1"))
            if n_call <= fail_n:
                return Completion(
                    error=f"mock transient failure {n_call}/{fail_n}",
                    transient=True,
                )
            behavior = "critic"

        agree_after = int(opts.get("agree_after", "0"))
        cached = self._account_prefix(req, overlapped, req_index)
        if behavior == "agree" or (agree_after and round_num >= agree_after):
            text = "[AGREE]\nNo remaining objections; the document is ready."
            tail = int(opts.get("agree_tail", "0"))
            if tail > 0:
                # Deterministic verbosity AFTER the verdict marker —
                # exactly the decode early cancellation converts back
                # into served capacity (bench.py --mode cancel).
                text += "\n\nExtended remarks:" + "".join(
                    f"\n- remark {k}: the document remains acceptable "
                    "in every reviewed dimension."
                    for k in range(1, tail + 1)
                )
        else:
            crit = _CRITIQUES[(round_num - 1) % len(_CRITIQUES)]
            spec = _extract_document(req.user)
            revised = spec + f"\n\n## Revision note (round {round_num})\n" + crit
            text = (
                f"1. {crit}\n\n[SPEC]\n{revised}\n[/SPEC]"
            )

        full_tokens = min(_estimate_tokens(text), params.max_new_tokens)
        cancelled = False
        if consumer is not None and stream_mod.config().enabled:
            stream_mod.stats.record_request()
            text, cancelled = self._stream_text(req_index, text, consumer)
        out_tokens = min(_estimate_tokens(text), params.max_new_tokens)
        tps = float(opts.get("tps", "0"))
        in_tokens = _estimate_tokens(req.system) + _estimate_tokens(req.user)
        stream_saved = 0
        if cancelled:
            stream_saved = max(full_tokens - out_tokens, 0)
            stream_mod.stats.record_cancel(out_tokens, stream_saved)
            if obs_mod.config().enabled:
                obs_mod.hot.cancel("early_converge").inc()
                obs_mod.hot.cancel_tokens_saved.observe(float(stream_saved))
                obs_mod.emit(
                    obs_mod.CancelEvent(
                        req_id=req_index,
                        slot=req_index,
                        reason="early_converge",
                        tokens_emitted=out_tokens,
                        tokens_saved=stream_saved,
                        span_id=req.span_id,
                    )
                )
        # Speculation accounting runs over the DELIVERED text only: the
        # batcher never decodes past a cancel either.
        self._account_spec(req, text, req_index)
        self._emit_lifecycle(
            req_index, in_tokens, cached, out_tokens, req.span_id,
            cancelled=cancelled,
        )
        usage = Usage(
            input_tokens=in_tokens,
            output_tokens=out_tokens,
            decode_tokens=out_tokens,
            decode_time_s=out_tokens / tps if tps > 0 else 0.0,
            cached_tokens=cached,
        )
        return Completion(text=text, usage=usage, cancelled=cancelled)


def _extract_document(user_prompt: str) -> str:
    start = user_prompt.find("--- DOCUMENT ---")
    end = user_prompt.find("--- END DOCUMENT ---")
    if start == -1 or end == -1:
        return user_prompt.strip()
    return user_prompt[start + len("--- DOCUMENT ---") : end].strip()
