"""Fused-step / pipelined-drive-loop config and telemetry (host side).

Counterpart of ``adversarial_spec_tpu/engine/interleave.py``. The port's
``ContinuousBatcher`` (engine/scheduler.py) has two drive loops. The
fused + pipelined loop (``enabled=True``) runs the in-flight admission's
prompt chunk and every resident row's decode (or verify) step in each
iteration (Sarathi-style piggybacked chunked prefill) and keeps up to
``pipeline_depth`` steps in flight: each step's flags are copied to
pinned host memory behind a CUDA event, and the host applies step N-1's
flags while step N runs (``--pipeline-depth``, env
``ADVSPEC_PIPELINE_DEPTH``; default 2, the double buffer; 1 = fused but
synchronous). ``enabled=False`` (env ``ADVSPEC_INTERLEAVE=0``) selects the
reference's legacy serialized loop: one prompt-chunk dispatch, then one
decode dispatch, each with its host sync.

The counters are the reference's:

- ``stalled_prefill_s``: admission prefill wall-clock the batch waited on
  (standalone chunks with nothing to overlap, and the admission-handoff
  scatter+sample);
- ``overlapped_prefill_s``: prefill wall-clock attributed to chunks that
  rode inside a fused step;
- ``sync_points``: host syncs. In the port these also count the decode
  loop's per-step ``active.any()`` read (the reference's on-device
  ``while_loop`` condition), so the figure is the port's real number of
  host round trips.

``prefill_time_s`` is by construction the sum of the two buckets.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

from adversarial_spec_tpu_torch.engine import procconfig

# The drive loop keeps at most this many device steps in flight. Depth 1
# degenerates to "fused but synchronous" (fetch each step right after
# dispatch); depth 2 is the double buffer.
MAX_PIPELINE_DEPTH = 2


@dataclass
class InterleaveConfig:
    """Process-wide knobs, set once per round (or by tests)."""

    enabled: bool = True
    pipeline_depth: int = MAX_PIPELINE_DEPTH


@dataclass
class InterleaveStats(procconfig.StatsBase):
    """Process-wide counters, aggregated across every batcher. ``reset``
    zeroes in place so engines holding a reference keep counting into
    the same object."""

    fused_steps: int = 0  # dispatches carrying prefill AND decode
    decode_steps: int = 0  # decode-only dispatches
    prefill_steps: int = 0  # standalone (stalled) prefill chunks
    sync_points: int = 0  # sanctioned host syncs (handoff/fault/timeout)
    stalled_prefill_s: float = 0.0
    overlapped_prefill_s: float = 0.0

    def record_step(self, *, fused: bool, prefill_only: bool = False) -> None:
        if fused:
            self.fused_steps += 1
        elif prefill_only:
            self.prefill_steps += 1
        else:
            self.decode_steps += 1

    def record_prefill_time(self, seconds: float, *, overlapped: bool) -> None:
        if overlapped:
            self.overlapped_prefill_s += seconds
        else:
            self.stalled_prefill_s += seconds

    def record_sync(self) -> None:
        self.sync_points += 1

    def snapshot(self) -> dict:
        out = self.as_dict()
        out["prefill_time_s"] = (
            self.stalled_prefill_s + self.overlapped_prefill_s
        )
        return out


def _depth_from_env() -> int:
    try:
        d = int(os.environ.get("ADVSPEC_PIPELINE_DEPTH", MAX_PIPELINE_DEPTH))
    except ValueError:
        d = MAX_PIPELINE_DEPTH
    return clamp_depth(d)


def clamp_depth(depth) -> int:
    """A requested depth clamped to [1, MAX_PIPELINE_DEPTH]."""
    return max(1, min(int(depth), MAX_PIPELINE_DEPTH))


_state = procconfig.ProcState(
    InterleaveConfig(
        enabled=os.environ.get("ADVSPEC_INTERLEAVE", "1") != "0",
        pipeline_depth=_depth_from_env(),
    ),
    InterleaveStats(),
    coerce={"pipeline_depth": clamp_depth},
)
stats = _state.stats


def config() -> InterleaveConfig:
    return _state.config


def configure(
    enabled: bool | None = None, pipeline_depth: int | None = None
) -> InterleaveConfig:
    return _state.configure(enabled=enabled, pipeline_depth=pipeline_depth)


def reset_stats() -> None:
    _state.reset_stats()


def snapshot() -> dict:
    """Stats + config, the ``perf.interleave`` payload."""
    return _state.snapshot()
