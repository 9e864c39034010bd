"""Tracing and profiling (the PyTorch port's copy of
``adversarial_spec_tpu/utils/tracing.py``; ``maybe_profile`` traces with
``torch.profiler`` where the reference used ``jax.profiler``).

SURVEY §5: the reference has no tracing at all (its nearest analog is the
cost tracker), but per-round wall-clock and tokens/sec/chip are this
framework's north-star metric, so tracing is first-class here:

- ``Tracer`` — lightweight span timers building a per-round phase
  breakdown (validate / prefill / decode / parse ...), nestable, with a
  machine-readable report that the CLI attaches to ``--json`` output.
  Spans carry CALL COUNTS (a span entered twice reports both the
  accumulated seconds and how many entries produced them, so averages
  are computable) and a NESTED TREE mirroring the entry stack; tracers
  compose via ``merge()`` — the debate layer's per-opponent spans and
  the engine's per-request spans graft into one report.
- ``maybe_profile`` — wraps a block in a ``torch.profiler`` trace when a
  directory is given and writes it there as a Chrome trace (open it in
  Perfetto or ``chrome://tracing``), no-op otherwise.

Kept deliberately pure-Python and allocation-light: a span is two
``time.monotonic`` calls and a dict entry.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field


def _tree_node(children: dict, name: str) -> dict:
    node = children.get(name)
    if node is None:
        node = children[name] = {"total_s": 0.0, "count": 0, "children": {}}
    return node


def _merge_tree(dst: dict, src: dict) -> None:
    for name, node in src.items():
        d = _tree_node(dst, name)
        d["total_s"] += node["total_s"]
        d["count"] += node["count"]
        _merge_tree(d["children"], node["children"])


def _round_tree(children: dict) -> dict:
    return {
        name: {
            "total_s": round(node["total_s"], 4),
            "count": node["count"],
            "children": _round_tree(node["children"]),
        }
        for name, node in children.items()
    }


@dataclass
class Tracer:
    """Named wall-clock spans with counters, for one logical operation."""

    spans: dict[str, float] = field(default_factory=dict)
    counters: dict[str, float] = field(default_factory=dict)
    # Entries per span name: spans[k] / span_counts[k] is the average.
    span_counts: dict[str, int] = field(default_factory=dict)
    # Nested span tree mirroring the entry stack ("round" > "chat" ...):
    # {name: {"total_s", "count", "children": {...}}}.
    tree: dict = field(default_factory=dict)
    _t0: float = field(default_factory=time.monotonic)
    _stack: list = field(default_factory=list)

    @contextlib.contextmanager
    def span(self, name: str):
        start = time.monotonic()
        self._stack.append(name)
        path = tuple(self._stack)
        try:
            yield
        finally:
            self._stack.pop()
            self._record_span(name, time.monotonic() - start, path)

    def _record_span(
        self, name: str, seconds: float, path: tuple | None = None
    ) -> None:
        self.spans[name] = self.spans.get(name, 0.0) + seconds
        self.span_counts[name] = self.span_counts.get(name, 0) + 1
        children = self.tree
        for part in path or (name,):
            node = _tree_node(children, part)
            children = node["children"]
        node["total_s"] += seconds
        node["count"] += 1

    def add_span(self, name: str, seconds: float) -> None:
        """Record an externally measured duration as one span entry
        (flat + root of the tree) — for durations produced by another
        layer (per-opponent chat latencies, per-request engine walls)
        that never ran under this tracer's context manager."""
        self._record_span(name, seconds)

    def count(self, name: str, value: float) -> None:
        self.counters[name] = self.counters.get(name, 0.0) + value

    def count_many(self, values: dict[str, float]) -> None:
        """Merge a counter dict (e.g. the resilience subsystem's fault
        counts or breaker transition totals) into this tracer."""
        for name, value in values.items():
            self.count(name, value)

    def merge(self, other: "Tracer", prefix: str = "") -> None:
        """Fold another tracer's spans/counters/tree into this one.
        With ``prefix``, flat keys gain ``prefix/`` and the tree grafts
        under a ``prefix`` node — how the debate layer's per-opponent
        spans and the engine's per-request spans compose into the one
        report the CLI emits."""

        def key(k: str) -> str:
            return f"{prefix}/{k}" if prefix else k

        for k, v in other.spans.items():
            self.spans[key(k)] = self.spans.get(key(k), 0.0) + v
        for k, v in other.span_counts.items():
            self.span_counts[key(k)] = self.span_counts.get(key(k), 0) + v
        for k, v in other.counters.items():
            self.counters[key(k)] = self.counters.get(key(k), 0.0) + v
        if prefix:
            node = _tree_node(self.tree, prefix)
            _merge_tree(node["children"], other.tree)
            node["total_s"] += sum(
                n["total_s"] for n in other.tree.values()
            )
            node["count"] += sum(n["count"] for n in other.tree.values())
        else:
            _merge_tree(self.tree, other.tree)

    def rate(self, tokens_key: str, time_key: str) -> float:
        t = self.spans.get(time_key, 0.0)
        return self.counters.get(tokens_key, 0.0) / t if t > 0 else 0.0

    def report(self) -> dict:
        total = time.monotonic() - self._t0
        out: dict = {
            "total_s": round(total, 4),
            "spans": {k: round(v, 4) for k, v in self.spans.items()},
        }
        if self.span_counts:
            out["span_counts"] = dict(self.span_counts)
        if self.tree:
            out["span_tree"] = _round_tree(self.tree)
        if self.counters:
            out["counters"] = {
                k: round(v, 2) for k, v in self.counters.items()
            }
        return out


@contextlib.contextmanager
def maybe_profile(trace_dir: str | None):
    """``torch.profiler`` trace of the block, written into ``trace_dir``
    as ``trace.json`` (Chrome trace format) when given; no-op otherwise.
    The card's activity is traced too when CUDA is available."""
    if not trace_dir:
        yield
        return
    import os

    import torch

    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))
