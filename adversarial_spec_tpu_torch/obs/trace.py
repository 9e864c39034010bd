"""Causal request tracing: trace/span ids + the ambient stamping context.

The PyTorch port's copy of ``adversarial_spec_tpu/obs/trace.py``.

The metrics registry answers "how much", the flight recorder answers
"what was the batcher doing" — this module answers "to whom": every
flight-recorder event carries a ``trace_id`` (one per debate round) and
a ``span_id`` (one per opponent request), so a ``FaultEvent`` or a TTFT
sample ties back to the exact round and opponent that caused it.

Id model
--------

- ``trace_id`` — minted once per debate round by the debate layer
  (``run_round``): ``tr-<round:03d>-<n:02d>`` where ``n`` is a
  process-wide counter, reset per CLI invocation (``reset()``). Minting
  is DETERMINISTIC: the same invocation sequence yields byte-identical
  ids on the mock and real engines alike (the debate layer mints before
  any engine is chosen), which is what lets tier-1 pin trace parity on
  CPU.
- ``span_id`` — minted per opponent request as ``<trace_id>/s<i:02d>``
  (``i`` = the request's index in the round). A span id embeds its
  trace id, so a span alone resolves to exactly one round + opponent.

Daemon scopes (``advspec serve``)
---------------------------------

One process-wide counter is exactly right for the CLI's one-invocation-
one-round world and exactly wrong for a long-lived daemon running many
concurrent debates: two debates minting round 1 would collide on
``tr-001-01``, and the per-invocation ``reset()`` cascade would zero a
counter mid-flight for every other debate. ``mint_trace(scope=...)``
is the daemon-safe variant: each scope (one debate/session id) gets
its OWN counter and an 8-hex scope suffix —
``tr-<round:03d>-<n:02d>-<8hex(scope)>`` — so ids are deterministic
PER DEBATE, collision-free ACROSS debates, and a reset of one scope's
counter (``reset_scope``) never touches another's.

Propagation is by VALUE down the serving stack (``ChatRequest`` →
``SchedRequest`` → per-slot batcher state) and by AMBIENT context for
emit sites that do not know their request (prefix-cache CacheEvents,
tier SwapEvents, retrace CompileEvents): ``obs.emit`` stamps any event
whose ``trace_id``/``span_id`` fields are empty from the ambient pair
set here. The ambient pair is THREAD-LOCAL: the CLI's single-threaded
drive loop behaves exactly as before, and the serve daemon's
thread-per-debate round drivers each stamp their own round's ids
instead of stomping a module global (the collision this scoping fixes).
Minting takes a small lock for the same reason.

``reset()`` clears the counters and the calling thread's ambient pair;
it rides ``obs.reset_stats()`` so one CLI invocation's trace state can
never leak into the next (one invocation = one round). The daemon
deliberately does NOT run the per-invocation reset cascade mid-serve —
it resets once at startup and relies on scoped minting after that.
"""

from __future__ import annotations

import hashlib
import threading
from contextlib import contextmanager


class _Ambient(threading.local):
    """The current (trace_id, span_id) pair ``obs.emit`` stamps from.

    Thread-local: each serve-daemon debate thread carries its own
    ambient pair (its round's ids), while the single-threaded CLI pays
    one attribute load exactly as before.
    """

    def __init__(self) -> None:
        self.trace = ""
        self.span = ""


ambient = _Ambient()
_trace_counter = 0
# Per-scope counters for daemon minting (scope = one debate/session id).
_scope_counters: dict[str, int] = {}


def _make_mint_lock():
    """Minting lock through the lockdep seam, ``metrics=False`` (a
    histogram observe would re-enter obs). Lazy import — obs loads
    before resilience in some import orders, and minting must work
    either way."""
    try:
        from adversarial_spec_tpu_torch.resilience import lockdep
    except ImportError:  # pragma: no cover - partial-init fallback
        return threading.Lock()
    return lockdep.make_lock("trace._mint_lock", metrics=False)


_mint_lock = _make_mint_lock()


def _scope_suffix(scope: str) -> str:
    return hashlib.sha256(scope.encode("utf-8")).hexdigest()[:8]


def mint_trace(
    round_num: int = 0, seed: int | None = None, scope: str | None = None
) -> str:
    """Mint the next trace id for ``round_num``.

    Counter-based and deterministic: the n-th mint of a process (post
    ``reset()``) always yields the same id, so mock and real rounds of
    the same shape carry byte-identical ids. ``seed`` (optional) mixes
    an 8-hex suffix in for callers that need ids unique across
    processes; the CLI round path leaves it None so tier-1 can pin
    exact ids. ``scope`` (optional, the serve daemon's variant) mints
    from that scope's OWN counter with an 8-hex scope suffix — ids stay
    deterministic per debate and collision-free across the concurrent
    debates of one long-lived process.
    """
    global _trace_counter
    with _mint_lock:
        if scope is not None:
            n = _scope_counters.get(scope, 0) + 1
            _scope_counters[scope] = n
            return f"tr-{round_num:03d}-{n:02d}-{_scope_suffix(scope)}"
        _trace_counter += 1
        n = _trace_counter
    tid = f"tr-{round_num:03d}-{n:02d}"
    if seed is not None:
        suffix = hashlib.sha256(
            f"{seed}:{round_num}:{n}".encode()
        ).hexdigest()[:8]
        tid = f"{tid}-{suffix}"
    return tid


def mint_span(trace_id: str, index: int) -> str:
    """Span id for opponent request ``index`` of ``trace_id``. Embeds
    the trace id so a span alone resolves to one round + opponent."""
    return f"{trace_id}/s{index:02d}"


def trace_of(span_id: str) -> str:
    """The trace id a span id embeds ('' for an empty/foreign id)."""
    return span_id.rsplit("/s", 1)[0] if "/s" in span_id else ""


def set_ambient(trace_id: str = "", span_id: str = "") -> None:
    ambient.trace = trace_id
    ambient.span = span_id


def get_ambient() -> tuple[str, str]:
    return ambient.trace, ambient.span


@contextmanager
def scope(trace_id: str, span_id: str = ""):
    """Temporarily set the ambient pair (restores the previous pair on
    exit, even through exceptions) — the scheduler wraps admission and
    per-slot work in this so prefix-cache/tier/retrace emits inside
    stamp the request that caused them. Thread-local, so a daemon
    debate thread's scope never leaks into a concurrent debate's."""
    prev_trace, prev_span = ambient.trace, ambient.span
    ambient.trace = trace_id
    ambient.span = span_id
    try:
        yield
    finally:
        ambient.trace = prev_trace
        ambient.span = prev_span


def reset_scope(scope_id: str) -> None:
    """Drop ONE scope's counter (a debate retired from the daemon) —
    other scopes' counters are untouched, which is the whole point of
    scoped minting (a per-invocation global reset mid-serve would
    restart every concurrent debate's ids)."""
    with _mint_lock:
        _scope_counters.pop(scope_id, None)


def reset() -> None:
    """Per-invocation reset: counters back to zero, the calling
    thread's ambient cleared. Rides ``obs.reset_stats()`` (no-leak
    across CLI invocations). The serve daemon calls this ONCE at
    startup, never mid-serve."""
    global _trace_counter
    with _mint_lock:
        _trace_counter = 0
        _scope_counters.clear()
    ambient.trace = ""
    ambient.span = ""
