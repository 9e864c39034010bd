"""Resilience subsystem: fault taxonomy, circuit breakers, chaos injection.

The PyTorch port's copy of ``adversarial_spec_tpu/resilience/__init__.py``.

A TPU-native serving stack fails in ways HTTP never does — OOM mid-decode,
device loss, preemption — and the reference's whole failure story
(per-model retry with backoff, graceful round degradation) only covers the
debate seam. This package gives every layer a shared vocabulary and policy:

- ``faults``    — the structured taxonomy (`FaultKind`) and the single
                  ``classify()`` every seam uses, plus process-wide fault
                  counters for tracing.
- ``breaker``   — per-model circuit breakers (closed/open/half-open with
                  probe-on-recovery) consulted by ``debate.core.run_round``
                  so persistently failing opponents are skipped, not
                  retried 3x every round.
- ``injector``  — first-class fault injection at the generate /
                  scheduler-chunk / KV-alloc / checkpoint-load seams,
                  configured via ``--chaos`` or ``ADVSPEC_CHAOS`` — chaos
                  testing as a supported mode, not a monkeypatch.

Fault *isolation* lives where the state lives: ``engine/scheduler.py``
evicts only the affected slot (partial tokens + ``fault_kind`` on its
``SchedResult``) and keeps the rest of the batch decoding.
"""

from adversarial_spec_tpu_torch.resilience.faults import FaultKind, classify

__all__ = ["FaultKind", "classify"]
