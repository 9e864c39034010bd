"""Retrace watch: count jit compiles per program; flag unexpected ones.

The PyTorch port's copy of ``adversarial_spec_tpu/obs/retrace.py``.

GL-RETRACE (tools/graftlint) statically proves the scheduler's jit
static args are bounded; this is its runtime counterpart. Every chunk
dispatch reports its program name + the host-side dispatch key (the
static-arg/shape tuple the trace cache keys on, as the caller knows it).
Compiles are detected two ways:

- **cache-miss probe**: when the jitted callable exposes a trace-cache
  size (``_cache_size()`` on PjitFunction), a growth between dispatches
  IS a compile — exact, including recompiles the host key missed;
- **key novelty** (fallback): a never-seen dispatch key means a compile
  on any correct cache.

A compile whose dispatch key was ALREADY seen is an **unexpected
recompile** — some argument the host believed static/stable wasn't
(weak_type flips, dtype drift, a donated-buffer shape change). Those
are exactly the silent 100x slowdowns the report must surface, so they
are flagged per program and totalled in ``snapshot()``.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class _ProgramWatch:
    keys: set = field(default_factory=set)
    compiles: int = 0
    unexpected: int = 0
    dispatches: int = 0
    last_cache_size: int | None = None


def _cache_size(fn) -> int | None:
    if fn is None:
        return None
    probe = getattr(fn, "_cache_size", None)
    if probe is None:
        return None
    try:
        return int(probe())
    except Exception:
        return None


class RetraceWatch:
    """Per-program compile accounting. Host-side dict ops per dispatch;
    emits a CompileEvent (via the callback installed by obs.__init__)
    only when a compile actually happened."""

    def __init__(self, emit=None) -> None:
        self._programs: dict[str, _ProgramWatch] = {}
        self._emit = emit  # callable(CompileEvent) | None

    def observe(self, program: str, key: tuple, fn=None) -> bool:
        """Record one dispatch of ``program`` with host dispatch ``key``
        (call AFTER the dispatch so a cache-size probe sees the new
        entry). Returns True when a compile was detected."""
        w = self._programs.get(program)
        if w is None:
            w = self._programs[program] = _ProgramWatch()
        w.dispatches += 1
        new_key = key not in w.keys
        w.keys.add(key)
        size = _cache_size(fn)
        if size is not None:
            compiled = w.last_cache_size is None or size > w.last_cache_size
            w.last_cache_size = size
        else:
            compiled = new_key
        if not compiled:
            return False
        w.compiles += 1
        unexpected = not new_key
        if unexpected:
            w.unexpected += 1
        if self._emit is not None:
            from adversarial_spec_tpu_torch.obs.events import CompileEvent

            self._emit(
                CompileEvent(
                    program=program,
                    key=repr(key),
                    n_compiles=w.compiles,
                    unexpected=unexpected,
                )
            )
        return True

    def reset(self) -> None:
        """Per-invocation reset: zero the COUNTS but keep the compile
        baselines (seen keys, last cache size). The jit trace caches
        live for the process — TpuEngine keeps one batcher per model
        across rounds — so forgetting the baselines would report the
        first warm dispatch of every round as a fresh compile."""
        for w in self._programs.values():
            w.compiles = 0
            w.unexpected = 0
            w.dispatches = 0

    def clear(self) -> None:
        """Forget baselines too (cold-start accounting — test isolation;
        only correct when the process's jit caches are also considered
        cold, e.g. fresh shapes per test)."""
        self._programs.clear()

    def snapshot(self) -> dict:
        """Per-program compile counts + the unexpected-recompile flags
        the ``perf.obs`` report surfaces."""
        programs = {
            name: {
                "compiles": w.compiles,
                "distinct_keys": len(w.keys),
                "dispatches": w.dispatches,
                "unexpected_recompiles": w.unexpected,
            }
            for name, w in sorted(self._programs.items())
        }
        return {
            "programs": programs,
            "unexpected_recompiles": sum(
                w.unexpected for w in self._programs.values()
            ),
        }
