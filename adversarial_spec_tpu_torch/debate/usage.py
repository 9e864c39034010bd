"""Token-usage accounting (PyTorch port's copy of ``Usage`` and its price
lookup from ``adversarial_spec_tpu/debate/usage.py``; the caller-side
``CostTracker`` comes with the debate-layer slice).

Behavioral parity: the reference tracks per-model dollar cost in a
``CostTracker`` keyed by a static price table (scripts/models.py:81-127,
scripts/providers.py:18-45), surfaced via ``--show-cost`` and the ``--json``
output object. Local TPU models have no per-token dollar price, so the primary
currency here is tokens and device-seconds; a price table is still supported so
that mock/remote-style models report dollars and the JSON schema keeps the
reference's cost block shape.

Design departure (deliberate): the reference mutates one module-global tracker
from ThreadPoolExecutor worker threads with unsynchronized ``+=`` (a latent
lost-update race, scripts/models.py:90-107 under :699). Here ``Usage`` is an
immutable-ish value returned by each engine call; the caller folds them into a
``CostTracker`` single-threaded. This is also the JAX-idiomatic shape: pure
functions returning values, reduction at the caller.
"""

from __future__ import annotations

from dataclasses import dataclass

# Per-1M-token (input, output) dollar prices. TPU-local models cost $0 —
# their "cost" is device time, reported separately. The mock provider uses a
# nonzero price so cost-path logic stays exercised in CPU-only CI.
MODEL_COSTS: dict[str, tuple[float, float]] = {
    "mock://": (1.0, 2.0),
    "tpu://": (0.0, 0.0),
}
DEFAULT_COST: tuple[float, float] = (0.0, 0.0)


def model_cost_rates(model: str) -> tuple[float, float]:
    """Longest-prefix lookup so families share a price entry."""
    best = DEFAULT_COST
    best_len = -1
    for prefix, rates in MODEL_COSTS.items():
        if model.startswith(prefix) and len(prefix) > best_len:
            best, best_len = rates, len(prefix)
    return best


@dataclass
class Usage:
    """Token and time accounting for one model call (or a sum of calls)."""

    input_tokens: int = 0
    output_tokens: int = 0
    # Wall-clock seconds spent inside the engine (prefill + decode).
    device_time_s: float = 0.0
    # Decode-only throughput bookkeeping for the north-star metric.
    decode_tokens: int = 0
    decode_time_s: float = 0.0
    # Prompt tokens served from the prefix KV cache (subset of
    # input_tokens) and this request's own prefill wall-clock — the
    # per-request view of the cache's effect (engine/prefix_cache.py).
    cached_tokens: int = 0
    prefill_time_s: float = 0.0

    @property
    def total_tokens(self) -> int:
        return self.input_tokens + self.output_tokens

    def cost_for(self, model: str) -> float:
        in_rate, out_rate = model_cost_rates(model)
        return (self.input_tokens * in_rate + self.output_tokens * out_rate) / 1e6

    def __add__(self, other: "Usage") -> "Usage":
        return Usage(
            input_tokens=self.input_tokens + other.input_tokens,
            output_tokens=self.output_tokens + other.output_tokens,
            device_time_s=self.device_time_s + other.device_time_s,
            decode_tokens=self.decode_tokens + other.decode_tokens,
            decode_time_s=self.decode_time_s + other.decode_time_s,
            cached_tokens=self.cached_tokens + other.cached_tokens,
            prefill_time_s=self.prefill_time_s + other.prefill_time_s,
        )

    def to_dict(self) -> dict:
        return {
            "input_tokens": self.input_tokens,
            "output_tokens": self.output_tokens,
            "total_tokens": self.total_tokens,
            "cached_tokens": self.cached_tokens,
            "device_time_s": round(self.device_time_s, 4),
            "prefill_time_s": round(self.prefill_time_s, 4),
            "decode_time_s": round(self.decode_time_s, 4),
        }
