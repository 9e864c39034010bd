"""Speculative-decoding switchboard (process-wide, host side).

Counterpart of the config half of ``adversarial_spec_tpu/engine/spec.py``
(and the ``configure`` mechanics of ``engine/procconfig.py`` it uses):
``enabled`` (env ``ADVSPEC_SPECULATIVE``, default on) and ``gamma``, the
draft length per speculative step (env ``ADVSPEC_GAMMA``, default 8),
validated at the knob. ``generate()`` reads it when its ``speculative``
argument is None. The reference's speculation counters serve the paged
batcher, which is not ported yet.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

DEFAULT_GAMMA = 8


def _validate_gamma(gamma: int) -> int:
    if gamma < 1:
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
    """Process-wide knobs, set once per round (or by tests)."""

    enabled: bool = True
    gamma: int = DEFAULT_GAMMA


_config = SpecConfig(enabled=env_enabled(), gamma=env_gamma())


def config() -> SpecConfig:
    return _config


def configure(
    enabled: bool | None = None, gamma: int | None = None
) -> SpecConfig:
    """Assign every non-None knob (``gamma`` validated)."""
    if enabled is not None:
        _config.enabled = bool(enabled)
    if gamma is not None:
        _config.gamma = _validate_gamma(int(gamma))
    return _config
