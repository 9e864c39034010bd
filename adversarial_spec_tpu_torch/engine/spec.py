"""Speculative-decoding config and telemetry (process-wide, host side).

Counterpart of ``adversarial_spec_tpu/engine/spec.py`` (a copy).
Prompt-lookup speculation runs in two places: the dense ``generate()``
path (engine/speculative.py) and per slot in the paged ContinuousBatcher
(engine/scheduler.py: draft from the row's own context, one
multi-position verification forward over the paged pool). This module is
the one switchboard both consult:

- **config**: ``enabled`` (CLI ``--speculative/--no-speculative``, env
  ``ADVSPEC_SPECULATIVE``, default on) and ``gamma``, the draft length per
  speculative step (CLI ``--gamma``, env ``ADVSPEC_GAMMA``, default 8),
  validated at the knob.
- **stats**: per-round speculation counters. The batcher and the mock
  engine record into them; the dense ``generate()`` records none, as in
  the reference. ``snapshot()`` is the CLI's ``perf.spec`` payload.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

from adversarial_spec_tpu_torch.engine import procconfig

DEFAULT_GAMMA = 8


def _validate_gamma(gamma: int) -> int:
    if gamma < 1:
        # Fail at the knob, not deep inside a traced accept loop (γ=0
        # would index draft[:, -1] and run 1-wide verifies that are pure
        # overhead). The env read fires at import, so the remedy is to
        # fix the env var, not a kwarg.
        raise ValueError(
            f"ADVSPEC_GAMMA must be >= 1, got {gamma}; unset ADVSPEC_GAMMA "
            "(and pass speculative=False if the goal was disabling "
            "speculation)"
        )
    return gamma


def env_enabled() -> bool:
    """The process default for the master switch (``ADVSPEC_SPECULATIVE``)."""
    return os.environ.get("ADVSPEC_SPECULATIVE", "1") != "0"


def env_gamma() -> int:
    """The process default draft length (``ADVSPEC_GAMMA``), validated."""
    return _validate_gamma(
        int(os.environ.get("ADVSPEC_GAMMA", str(DEFAULT_GAMMA)))
    )


@dataclass
class SpecConfig:
    """Process-wide knobs, set once per CLI round (or by tests)."""

    enabled: bool = True
    gamma: int = DEFAULT_GAMMA


@dataclass
class SpecStats(procconfig.StatsBase):
    """Process-wide speculation counters, aggregated across every
    batcher drain (and the mock engine's deterministic accounting).

    ``drafted_tokens`` counts draft positions that could actually have
    committed (per-row ``n_allowed`` — the budget/page-clamped draft
    width), so ``accepted / drafted`` is a true acceptance rate, not
    diluted by positions that were never eligible. ``emitted_tokens``
    additionally counts each step's bonus/rejection token.

    The draft/verify wall split is attributed by position share of the
    fused draft+verify program (the draft's bigram scan costs about one
    forward position against the span's γ+1): measuring the halves
    separately would need a profiler — the same deterministic-share
    convention the fused prefill+decode step uses.
    """

    # PER-ROW verify steps: +1 per LIVE row per dispatched program (B
    # co-resident rows ⇒ +B per program), so emitted/spec_steps is a
    # true per-row tokens-per-step. Program dispatch counts live in the
    # retrace watch / StepEvents, not here.
    spec_steps: int = 0
    drafted_tokens: int = 0  # eligible draft positions verified
    accepted_tokens: int = 0  # draft positions accepted
    emitted_tokens: int = 0  # tokens emitted by spec steps (incl. bonus)
    rolled_back_pages: int = 0  # draft pages released by rollback
    draft_time_s: float = 0.0
    verify_time_s: float = 0.0

    def record_step(self, drafted: int, accepted: int, emitted: int) -> None:
        self.spec_steps += 1
        self.drafted_tokens += drafted
        self.accepted_tokens += accepted
        self.emitted_tokens += emitted

    def record_wall(self, draft_s: float, verify_s: float) -> None:
        self.draft_time_s += draft_s
        self.verify_time_s += verify_s

    def record_rollback(self, pages: int) -> None:
        self.rolled_back_pages += pages

    def snapshot(self) -> dict:
        out = self.as_dict()
        out["acceptance_rate"] = (
            round(self.accepted_tokens / self.drafted_tokens, 4)
            if self.drafted_tokens
            else 0.0
        )
        out["tokens_per_step"] = (
            round(self.emitted_tokens / self.spec_steps, 4)
            if self.spec_steps
            else 0.0
        )
        return out


_state = procconfig.ProcState(
    SpecConfig(enabled=env_enabled(), gamma=env_gamma()),
    SpecStats(),
    coerce={"gamma": lambda g: _validate_gamma(int(g))},
)
_config = _state.config
stats = _state.stats


def config() -> SpecConfig:
    return _state.config


def configure(
    enabled: bool | None = None, gamma: int | None = None
) -> SpecConfig:
    return _state.configure(enabled=enabled, gamma=gamma)


def reset_stats() -> None:
    _state.reset_stats()


def snapshot() -> dict:
    """Stats + config, the ``perf.spec`` payload."""
    return _state.snapshot()
