"""Core result types for a debate round.

The PyTorch port's copy of ``adversarial_spec_tpu/debate/types.py``.

Behavioral parity: the reference models a per-opponent result as a
``ModelResponse`` dataclass (reference scripts/models.py:67-78) carrying the
model id, raw critique text, the agreement bit, an optional revised spec, an
optional error string, and token usage. We keep that surface but make usage a
first-class value (``Usage``) returned from pure calls and reduced at the
caller, instead of the reference's mutable module-global cost tracker
(scripts/models.py:127) which is racily updated from worker threads.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from adversarial_spec_tpu_torch.debate.usage import Usage
from adversarial_spec_tpu_torch.utils.tracing import Tracer


@dataclass
class ModelResponse:
    """Result of one opponent model's critique of the spec."""

    model: str
    critique: str = ""
    agreed: bool = False
    revised_spec: str | None = None
    error: str | None = None
    usage: Usage = field(default_factory=Usage)
    latency_s: float = 0.0
    # This opponent request's causal-trace span (obs/trace.py): joins
    # the CLI report row to the flight-recorder events and the
    # tools/trace_view.py waterfall for this exact request.
    span_id: str = ""

    @property
    def ok(self) -> bool:
        return self.error is None

    def to_dict(self) -> dict:
        return {
            "model": self.model,
            "agreed": self.agreed,
            "critique": self.critique,
            "revised_spec": self.revised_spec,
            "error": self.error,
            "usage": self.usage.to_dict(),
            "latency_s": round(self.latency_s, 3),
            "span_id": self.span_id,
        }


@dataclass
class RoundResult:
    """Aggregate of one critique round across all opponents.

    ``all_agreed`` counts only successful responses, matching the reference's
    convergence rule (scripts/debate.py:852-853): failed models degrade the
    round gracefully rather than blocking agreement.
    """

    responses: list[ModelResponse]
    round_num: int = 1
    # The debate layer's own span tracer (per-opponent chat walls,
    # retry/backoff accounting); the CLI merges it into the round-level
    # tracer via ``Tracer.merge`` so one report nests both layers.
    tracer: Tracer = field(default_factory=Tracer)
    # The round's causal trace id (obs/trace.py): every flight-recorder
    # event this round caused carries it.
    trace_id: str = ""

    @property
    def successful(self) -> list[ModelResponse]:
        return [r for r in self.responses if r.ok]

    @property
    def failed(self) -> list[ModelResponse]:
        return [r for r in self.responses if not r.ok]

    @property
    def all_agreed(self) -> bool:
        ok = self.successful
        return bool(ok) and all(r.agreed for r in ok)

    @property
    def total_usage(self) -> Usage:
        total = Usage()
        for r in self.responses:
            total = total + r.usage
        return total
