"""Streaming-token config and telemetry (process-wide, host side).

Counterpart of ``adversarial_spec_tpu/engine/streaming.py`` (a copy). The
ContinuousBatcher (engine/scheduler.py) delivers each request's
tokens-so-far to a host-side consumer at the drive loop's existing fetch
points (the per-step flags or spec-counts read, admission handoff, slot
completion), and a consumer returning ``False`` cancels the request
mid-decode: the computed KV's full pages are salvaged into the prefix
cache and the slot frees through the same release surgery as completion.
The mock engine (engine/mock.py) streams its scripted replies the same way.

- **config**: ``enabled`` (CLI ``--stream/--no-stream``, env
  ``ADVSPEC_STREAM``, default on) gates token delivery; ``early_cancel``
  (CLI ``--early-cancel/--no-early-cancel``, env ``ADVSPEC_EARLY_CANCEL``,
  default on) additionally arms the debate layer's marker-driven
  cancellation (debate/core.py builds the consumers when ``armed()``).
- **stats**: per-round streaming counters; ``snapshot()`` is the
  ``perf.stream`` payload. The batcher's ``tokens_saved`` records the
  budget remainder (``max_new_tokens − emitted``) of each cancel, an
  upper bound on the decode actually avoided; the mock records the exact
  remainder of its scripted reply.
"""

from __future__ import annotations

import inspect
import os
from dataclasses import dataclass

from adversarial_spec_tpu_torch.engine import procconfig


def env_enabled() -> bool:
    """The process default for the master switch (``ADVSPEC_STREAM``)."""
    return os.environ.get("ADVSPEC_STREAM", "1") != "0"


def env_early_cancel() -> bool:
    """The process default for marker-driven cancellation
    (``ADVSPEC_EARLY_CANCEL``)."""
    return os.environ.get("ADVSPEC_EARLY_CANCEL", "1") != "0"


@dataclass
class StreamConfig:
    """Process-wide knobs, set once per CLI round (or by tests)."""

    enabled: bool = True
    early_cancel: bool = True


@dataclass
class StreamStats(procconfig.StatsBase):
    """Process-wide streaming counters, aggregated across every batcher
    drain (and the mock engine's deterministic accounting).

    ``streamed_tokens`` counts tokens DELIVERED through consumers (a
    cancelled request contributes only its emitted prefix), so
    ``tokens_saved / (streamed_tokens + tokens_saved)`` — the snapshot's
    ``saved_fraction`` — is the fraction of the round's streamed decode
    the cancellations avoided paying for.

    ``tokens_saved`` semantics per engine: the REAL batcher records the
    budget remainder (``max_new_tokens − emitted``) — the reserved
    decode capacity the cancel returned to the pool, an UPPER bound on
    the decode actually avoided, since where EOS would have landed is
    unknowable once decoding stops. The MOCK engine scripts its own
    reply, so it records the exact remainder of the reply the consumer
    never read; its ``saved_fraction`` (the cancel bench's headline) is
    therefore exact, not an upper bound.
    """

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
    StreamConfig(enabled=env_enabled(), early_cancel=env_early_cancel()),
    StreamStats(),
)
_config = _state.config
stats = _state.stats


def config() -> StreamConfig:
    return _state.config


def configure(
    enabled: bool | None = None, early_cancel: bool | None = None
) -> StreamConfig:
    return _state.configure(enabled=enabled, early_cancel=early_cancel)


def reset_stats() -> None:
    _state.reset_stats()


def snapshot() -> dict:
    """Stats + config, the ``perf.stream`` payload."""
    return _state.snapshot()


def armed() -> bool:
    """True when the debate layer should build early-cancel consumers:
    streaming AND marker cancellation both enabled."""
    return _state.config.enabled and _state.config.early_cancel


def consumer_supported(engine) -> bool:
    """True when the engine's ``chat`` accepts the streaming
    ``consumer`` kwarg (the Engine protocol's streaming extension).
    Inspected rather than assumed so test fakes and out-of-tree engines
    with the original 2-argument signature keep working unmodified —
    they simply serve the blocking path."""
    try:
        return "consumer" in inspect.signature(engine.chat).parameters
    except (TypeError, ValueError):
        return False
