"""Process-wide metrics registry: counters, gauges, fixed-bucket histograms.

The PyTorch port's copy of ``adversarial_spec_tpu/obs/metrics.py``.

The serving path grew one ad-hoc stats module per subsystem
(``resilience.faults``, ``prefix_cache.stats``, ``interleave.stats``);
this registry is the shared substrate the next perf PRs are measured
with — ONE process-wide home for named metrics with:

- a stable ``snapshot()`` dict (sorted keys, plain scalars — the
  ``perf.obs`` building block);
- Prometheus text exposition (``render_prometheus()``) so an operator
  can scrape a serving host with zero extra plumbing;
- per-invocation ``reset()`` semantics matching the existing pattern:
  values zero in place, so engines holding a metric handle keep
  recording into the same object across rounds.

Deliberately pure stdlib and jax-free: the mock engine records the same
metric names with synthetic deterministic values, so the whole catalog
pins on CPU. No wall-clock timestamps ever enter a metric — rendered
output is byte-deterministic given deterministic observations.
"""

from __future__ import annotations

import math
import threading
from dataclasses import dataclass, field

# Fixed default latency buckets (seconds). Chosen to straddle the
# serving path's real scales: sub-ms host bookkeeping, ms-scale chunk
# dispatches, and multi-second model loads. Fixed buckets (vs adaptive)
# keep exposition byte-stable across runs.
LATENCY_BUCKETS_S = (
    0.0005,
    0.001,
    0.0025,
    0.005,
    0.01,
    0.025,
    0.05,
    0.1,
    0.25,
    0.5,
    1.0,
    2.5,
    5.0,
    10.0,
    30.0,
)

# Ratio-shaped histograms (utilization, hit rates) bucket on [0, 1].
RATIO_BUCKETS = (0.1, 0.25, 0.5, 0.75, 0.9, 0.95, 0.99, 1.0)

# The quantiles every histogram exposes in snapshot()/render_prometheus()
# — THE shared percentile vocabulary (load_replay, the SLO gates, and
# bench.py report the same three, so a latency tail reads the same
# everywhere).
QUANTILES = (0.5, 0.95, 0.99)


def percentile(samples, q: float) -> float:
    """Exact nearest-rank percentile of a sample list (sorted copy made
    here) — THE one sample-percentile implementation: the overload
    drill's SLO gate (tools/chaos_run.py), bench.py's per-arm TTFT
    tails, and tools/load_replay.py all report through this instead of
    each hand-rolling an off-by-one index. Returns 0.0 on an empty
    sample set (a quantile of nothing is not a latency)."""
    xs = sorted(float(v) for v in samples)
    if not xs:
        return 0.0
    q = min(max(float(q), 0.0), 1.0)
    rank = max(1, math.ceil(q * len(xs)))
    return xs[rank - 1]


def _fmt(v: float) -> str:
    """Deterministic Prometheus value formatting: integral floats render
    as integers (``3`` not ``3.0``), the rest via repr (shortest
    round-trip form — stable for a given float)."""
    f = float(v)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _label_str(labels: tuple[tuple[str, str], ...]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in labels)
    return "{" + inner + "}"


@dataclass
class Counter:
    """Monotonic counter. ``inc`` only; ``reset`` zeroes in place."""

    value: float = 0.0

    def inc(self, v: float = 1.0) -> None:
        self.value += v

    def reset(self) -> None:
        self.value = 0.0


@dataclass
class Gauge:
    """Last-write-wins scalar."""

    value: float = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def reset(self) -> None:
        self.value = 0.0


@dataclass
class Histogram:
    """Fixed-bucket histogram (cumulative on render, like Prometheus).

    ``buckets`` holds upper bounds in ascending order; observations
    above the last bound land only in the implicit +Inf bucket.
    """

    buckets: tuple = LATENCY_BUCKETS_S
    counts: list[int] = field(default_factory=list)
    sum: float = 0.0
    count: int = 0

    def __post_init__(self) -> None:
        if not self.counts:
            self.counts = [0] * len(self.buckets)

    def observe(self, v: float) -> None:
        v = float(v)
        self.sum += v
        self.count += 1
        for i, bound in enumerate(self.buckets):
            if v <= bound:
                self.counts[i] += 1
                break

    def cumulative(self) -> list[int]:
        out, running = [], 0
        for c in self.counts:
            running += c
            out.append(running)
        return out

    def quantile(self, q: float) -> float:
        """Bucket-interpolated quantile estimate (Prometheus
        ``histogram_quantile`` semantics): find the bucket holding the
        q·count-th observation and interpolate linearly between its
        bounds. Observations past the last bound clamp to the last
        bound — a fixed-bucket histogram cannot see further. 0.0 when
        empty."""
        if self.count <= 0:
            return 0.0
        q = min(max(float(q), 0.0), 1.0)
        rank = q * self.count
        running = 0
        for i, bound in enumerate(self.buckets):
            prev = running
            running += self.counts[i]
            if running >= rank and self.counts[i] > 0:
                lo = self.buckets[i - 1] if i > 0 else 0.0
                frac = (rank - prev) / self.counts[i]
                return lo + (bound - lo) * min(max(frac, 0.0), 1.0)
        return float(self.buckets[-1]) if self.buckets else 0.0

    def reset(self) -> None:
        self.counts = [0] * len(self.buckets)
        self.sum = 0.0
        self.count = 0


def _registry_lock():
    """The registry lock through the lockdep seam, ``metrics=False``:
    every histogram observe takes THIS lock, so instrumenting it would
    recurse. Lazy import — obs loads before resilience in some import
    orders, and the registry must construct either way."""
    try:
        from adversarial_spec_tpu_torch.resilience import lockdep
    except ImportError:  # pragma: no cover - partial-init fallback
        return threading.Lock()
    return lockdep.make_lock("MetricsRegistry._lock", metrics=False)


class MetricsRegistry:
    """Named metrics with optional labels; one instance per process.

    ``counter("x", seam="generate")`` returns the same Counter object on
    every call with the same name+labels — handles are cacheable and
    reset-in-place keeps them live across rounds. A name is permanently
    one kind: re-registering ``x`` as a gauge after a counter raises
    (silent kind drift would corrupt the exposition).
    """

    def __init__(self) -> None:
        self._lock = _registry_lock()
        # name -> (kind, help, {labels_tuple: metric})
        self._families: dict[str, tuple[str, str, dict]] = {}

    def _get(self, kind: str, name: str, help_: str, labels: dict, factory):
        key = tuple(sorted((k, str(v)) for k, v in labels.items()))
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = (kind, help_, {})
                self._families[name] = fam
            elif fam[0] != kind:
                raise ValueError(
                    f"metric {name!r} already registered as {fam[0]}, "
                    f"not {kind}"
                )
            metric = fam[2].get(key)
            if metric is None:
                metric = factory()
                fam[2][key] = metric
            return metric

    def counter(self, name: str, help: str = "", **labels) -> Counter:
        return self._get("counter", name, help, labels, Counter)

    def gauge(self, name: str, help: str = "", **labels) -> Gauge:
        return self._get("gauge", name, help, labels, Gauge)

    def histogram(
        self, name: str, help: str = "", buckets: tuple | None = None, **labels
    ) -> Histogram:
        b = tuple(buckets) if buckets is not None else LATENCY_BUCKETS_S
        return self._get(
            "histogram", name, help, labels, lambda: Histogram(buckets=b)
        )

    def reset(self) -> None:
        """Zero every metric IN PLACE (handles stay valid — the
        resilience/interleave reset contract)."""
        with self._lock:
            for _, _, series in self._families.values():
                for metric in series.values():
                    metric.reset()

    def snapshot(self) -> dict:
        """Stable dict of every series: ``name{labels}`` → scalar for
        counters/gauges, ``{count, sum, p50, p95, p99}`` for histograms
        (bucket-estimated quantiles — see ``Histogram.quantile``).
        Sorted keys."""
        out: dict = {}
        with self._lock:
            for name in sorted(self._families):
                kind, _, series = self._families[name]
                for key in sorted(series):
                    metric = series[key]
                    k = name + _label_str(key)
                    if kind == "histogram":
                        out[k] = {
                            "count": metric.count,
                            "sum": round(metric.sum, 6),
                            "p50": round(metric.quantile(0.5), 6),
                            "p95": round(metric.quantile(0.95), 6),
                            "p99": round(metric.quantile(0.99), 6),
                        }
                    else:
                        out[k] = (
                            int(metric.value)
                            if float(metric.value).is_integer()
                            else metric.value
                        )
        return out

    def render_prometheus(self) -> str:
        """Prometheus text exposition format v0.0.4. Families sort by
        name and series by labels, so output is byte-deterministic for
        deterministic observations (no timestamps are ever emitted)."""
        lines: list[str] = []
        with self._lock:
            for name in sorted(self._families):
                kind, help_, series = self._families[name]
                if help_:
                    lines.append(f"# HELP {name} {help_}")
                lines.append(f"# TYPE {name} {kind}")
                for key in sorted(series):
                    metric = series[key]
                    if kind == "histogram":
                        cum = metric.cumulative()
                        total = metric.count
                        for bound, c in zip(metric.buckets, cum):
                            lbl = key + (("le", _fmt(bound)),)
                            lines.append(
                                f"{name}_bucket{_label_str(lbl)} {c}"
                            )
                        lbl = key + (("le", "+Inf"),)
                        lines.append(
                            f"{name}_bucket{_label_str(lbl)} {total}"
                        )
                        lines.append(
                            f"{name}_sum{_label_str(key)} {_fmt(metric.sum)}"
                        )
                        lines.append(
                            f"{name}_count{_label_str(key)} {total}"
                        )
                        for q in QUANTILES:
                            suffix = f"p{int(q * 100)}"
                            val = round(metric.quantile(q), 6)
                            lines.append(
                                f"{name}_{suffix}{_label_str(key)} "
                                f"{_fmt(val)}"
                            )
                    else:
                        lines.append(
                            f"{name}{_label_str(key)} {_fmt(metric.value)}"
                        )
        return "\n".join(lines) + ("\n" if lines else "")
