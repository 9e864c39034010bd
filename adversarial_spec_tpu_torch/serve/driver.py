"""One daemon debate, end to end: the reentrant round-driver wrapper.

Each accepted ``debate`` request runs on its own worker thread through
the SAME ``run_round`` the CLI uses — breakers, retries, hedging,
journal replay, trace propagation all included — scoped by:

- a :class:`~adversarial_spec_tpu_torch.serve.gate.Submission` context, so
  every ``chat`` the round issues is scheduled fair-share under the
  request's (tenant, tier) identity;
- a per-debate trace scope (``RoundConfig.trace_scope``), so
  concurrent rounds mint collision-free ids from their own counters;
- an optional per-session round journal: a ``session``-carrying
  request is crash/drain-durable — completed opponents fsync the
  moment they resolve, and resubmitting the same session+spec+round
  replays them with zero engine work (the drain contract's
  "journal-commits in-flight debates").

Breaker authority in the daemon: the PROCESS
registry stays authoritative across every debate — an opponent model
that opened its circuit in one tenant's round is skipped in every
round of every tenant until its cooldown probe, and the registry's
one-probe-at-a-time rule means concurrent tenants cannot each burn a
probe on the same dead model. The per-debate view is SNAPSHOTTED at
round commit into the result payload (``breakers``), which is what a
client persists alongside its session — exactly the role
``SessionState.breakers`` plays for the CLI.
"""

from __future__ import annotations

import time

from adversarial_spec_tpu_torch import serve as serve_mod
from adversarial_spec_tpu_torch.debate import journal as journal_mod
from adversarial_spec_tpu_torch.debate.core import RoundConfig, run_round
from adversarial_spec_tpu_torch.engine.types import SamplingParams
from adversarial_spec_tpu_torch.resilience import breaker as breaker_mod
from adversarial_spec_tpu_torch.serve import gate
from adversarial_spec_tpu_torch.serve.sched import ServeScheduler


def estimate_debate_tokens(payload: dict) -> int:
    """Admission-time cost estimate for a whole debate request: per-
    opponent prompt estimate (spec + template overhead, the 4-chars-
    per-token rule) plus the decode budget, times the pool size."""
    spec = payload.get("spec", "")
    models = payload.get("models", [])
    max_new = int(payload.get("max_new_tokens") or 1024)
    per_opp = max(1, len(spec) // 4) + 256 + max_new
    return per_opp * max(1, len(models))


def estimate_debate_prefill_tokens(payload: dict) -> int:
    """The PREFILL share of the debate estimate (prompt tokens only,
    no decode budget) — the scheduler's per-role backlog split and the
    disaggregated router's handoff threshold both read this scale."""
    spec = payload.get("spec", "")
    models = payload.get("models", [])
    per_opp = max(1, len(spec) // 4) + 256
    return per_opp * max(1, len(models))


def _params_from_payload(payload: dict) -> SamplingParams:
    return SamplingParams(
        max_new_tokens=int(payload.get("max_new_tokens") or 1024),
        greedy=bool(payload.get("greedy", False)),
    )


def run_debate(
    payload: dict,
    sched: ServeScheduler,
    *,
    debate_id: str,
    journal_dir=None,
    on_stream=None,
    accept_t: float | None = None,
) -> dict:
    """Execute one validated ``debate`` request (serve/protocol.py
    schema) and return the result-event payload. Runs on a daemon
    worker thread; MUST release the debate's admission reservation on
    every path (the ``finally`` below) — a leaked reservation is
    permanent phantom backlog."""
    tenant = payload["tenant"]
    tier = payload.get("tier", "interactive")
    spec = payload["spec"]
    models = list(payload["models"])
    round_num = int(payload.get("round") or 1)
    session = payload.get("session") or ""

    journal = None
    if session and journal_mod.env_enabled():
        journal = journal_mod.RoundJournal(session, journal_dir=journal_dir)

    cfg = RoundConfig(
        sampling=_params_from_payload(payload),
        journal=journal,
        # Fleet placement + trace scope both key on the most stable
        # identity available: the client's session when given (resume
        # must land on the same replica AND replay the same journal),
        # else the daemon-assigned debate id.
        debate_id=session or debate_id,
        trace_scope=session or debate_id,
    )

    # TTFT is measured from ADMISSION (``accept_t``, stamped by the
    # daemon the moment the debate was accepted), not from when a
    # worker thread got free: the executor queue wait is latency the
    # client pays and the SLO gate must see.
    sub = gate.Submission(
        tenant=tenant,
        tier=tier,
        debate=debate_id,
        on_stream=on_stream,
        t0=accept_t,
    )
    t0 = accept_t if accept_t is not None else time.monotonic()
    try:
        with gate.submission(sub):
            result = run_round(spec, models, round_num=round_num, cfg=cfg)
        wall_s = time.monotonic() - t0
        if journal is not None and all(r.ok for r in result.responses):
            # Round-commit only a FULLY-resolved round: a round that
            # lost opponents to quota sheds or a drain stays
            # uncommitted, so a resubmit replays the durable
            # completions and re-issues only the gap.
            try:
                journal.log_round_commit(round_num, result.all_agreed)
            except Exception:
                pass  # durability is best-effort by contract
        breakers = breaker_mod.default_registry()
        return {
            "all_agreed": result.all_agreed,
            "round": round_num,
            "trace_id": result.trace_id,
            "tenant": tenant,
            "tier": tier,
            "wall_s": round(wall_s, 6),
            "ttft_s": round(
                sub.ttft_s if sub.ttft_s is not None else wall_s, 6
            ),
            "journal_served": int(
                result.tracer.counters.get("journal.served", 0)
            ),
            "results": [
                {
                    "model": r.model,
                    "agreed": r.agreed,
                    "response": r.critique,
                    "spec": r.revised_spec,
                    "error": r.error,
                    "span_id": r.span_id,
                    "input_tokens": r.usage.input_tokens,
                    "output_tokens": r.usage.output_tokens,
                    "cached_tokens": r.usage.cached_tokens,
                }
                for r in result.responses
            ],
            # The per-debate breaker snapshot at round commit: the
            # client's durable view of which opponents are tripped
            # (process breakers stay authoritative daemon-side).
            "breakers": breakers.snapshot_for_resume(),
            "serve": serve_mod.snapshot(),
        }
    finally:
        sched.finish_debate(debate_id)
