"""Streaming-token config and telemetry (process-wide, host side).

Counterpart of the config and stats of
``adversarial_spec_tpu/engine/streaming.py``. The ContinuousBatcher
(engine/scheduler.py) delivers each request's tokens-so-far to a
host-side consumer at the drive loop's existing fetch points (the
per-step flags or spec-counts read, admission handoff, slot completion),
and a consumer returning ``False`` cancels the request mid-decode: the
computed KV's full pages are salvaged into the prefix cache and the slot
frees through the same release surgery as completion.

- **config**: ``enabled`` (env ``ADVSPEC_STREAM``, default on) gates
  token delivery (the reference's ``early_cancel`` switch belongs to the
  debate layer, which is not ported yet).
- **stats**: per-round streaming counters; ``snapshot()`` is the
  ``perf.stream`` payload. ``tokens_saved`` records the budget remainder
  (``max_new_tokens − emitted``) of each cancel, an upper bound on the
  decode actually avoided.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

from adversarial_spec_tpu_torch.engine import procconfig


@dataclass
class StreamConfig:
    """Process-wide knobs, set once per round (or by tests)."""

    enabled: bool = True


@dataclass
class StreamStats(procconfig.StatsBase):
    """Process-wide streaming counters, aggregated across every drain."""

    requests_streamed: int = 0
    deliveries: int = 0  # consumer callbacks that carried new tokens
    streamed_tokens: int = 0  # tokens delivered through consumers
    cancels: int = 0
    cancelled_emitted_tokens: int = 0  # tokens emitted before each cancel
    tokens_saved: int = 0  # budget tokens never decoded thanks to cancel

    def record_request(self) -> None:
        self.requests_streamed += 1

    def record_delivery(self, n_tokens: int) -> None:
        self.deliveries += 1
        self.streamed_tokens += n_tokens

    def record_cancel(self, emitted: int, saved: int) -> None:
        self.cancels += 1
        self.cancelled_emitted_tokens += emitted
        self.tokens_saved += saved

    def snapshot(self) -> dict:
        out = self.as_dict()
        denom = self.streamed_tokens + self.tokens_saved
        out["saved_fraction"] = (
            round(self.tokens_saved / denom, 4) if denom else 0.0
        )
        return out


_state = procconfig.ProcState(
    StreamConfig(enabled=os.environ.get("ADVSPEC_STREAM", "1") != "0"),
    StreamStats(),
)
stats = _state.stats


def config() -> StreamConfig:
    return _state.config


def configure(enabled: bool | None = None) -> StreamConfig:
    return _state.configure(enabled=enabled)


def reset_stats() -> None:
    _state.reset_stats()


def snapshot() -> dict:
    """Stats + config, the ``perf.stream`` payload."""
    return _state.snapshot()
