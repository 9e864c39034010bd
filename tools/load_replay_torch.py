"""Trace-replay load harness + capacity-frontier sweep for the PyTorch
port's serve daemon (``python -m adversarial_spec_tpu_torch.cli serve``):
the port's counterpart of ``tools/load_replay.py``, with the same
functions, flags, output lines and payload keys over
``adversarial_spec_tpu_torch`` (it imports nothing of the JAX package).

Three layers, each usable alone:

1. **Trace acquisition** — either synthesize a heavy-tailed
   multi-tenant arrival trace from a seeded spec (lognormal
   inter-arrivals, Zipf tenant skew, mixed interactive/batch tiers,
   lognormal prompt shapes), or reconstruct one from a flight-recorder
   JSONL dump (``--events-out`` / ``obs.dump_events``) recorded with
   ``ADVSPEC_OBS_ARRIVALS=1``. The reader follows the journal
   tolerant-reader discipline: a torn final line is discarded, a
   foreign or invalid line is skipped ALONE — one bad byte never
   poisons the rest of a recording.

2. **Open-loop replay** — drive an in-process serve daemon over the
   unix socket (``serve/client.py``) with schedule-faithful arrivals
   at k× the recorded rate: each submit fires at its scheduled
   offset whether or not the server has kept up (a slow server must
   never slow the arrival process — that is what "open loop" means,
   and what closed-loop harnesses get wrong about overload). Measures
   p50/p95/p99 TTFT, round latency, shed fraction, and brownout
   occupancy (sampled via the stats op's ``pressure`` snapshot from a
   second connection).

3. **Frontier sweep** — binary-search k until the configured SLO
   breaches; the highest non-breaching accepted-debates/s per knob arm
   is the CAPACITY FRONTIER, written as a BENCH-style payload
   (``BENCH_capacity.json``'s shape) that ``tools/bench_trend.py``
   schema-enforces (``_CAPACITY_REQUIRED``).

Round-trip property (the replay-fidelity pin): requests use a
CANONICAL SHAPE ENCODING — a fixed 2-opponent pool, fixed per-tier
decode budget, spec length a multiple of 4 rendered by
``canonical_spec`` — chosen so the admission estimate
(``driver.estimate_debate_tokens``) is INVERTIBLE: a recorded serve
event's ``(tokens, tier)`` reconstructs the exact spec text, so
record → reconstruct → replay at 1× reproduces byte-identical
transcripts on the deterministic mock engine.

The pool defaults to the reference's two ``mock://`` ids. ``replay_once``
and the estimate functions take ``models=`` so a caller can replay the
same trace against a pool of two ``tpu://`` ids served by ``GpuEngine``:
only the pool's SIZE enters the estimate, so any two-model pool keeps it
invertible. With the default pool every output equals the reference's.

Usage:
    python tools/load_replay_torch.py --smoke                # tiny seeded sweep
    python tools/load_replay_torch.py --rate 2.0 --json      # one run at 2x
    python tools/load_replay_torch.py --replay events.jsonl  # recorded trace
    python tools/load_replay_torch.py --sweep --bench-out capacity.json
"""

from __future__ import annotations

import argparse
import asyncio
import json
import math
import os
import random
import sys
import tempfile
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from adversarial_spec_tpu_torch import obs as obs_mod  # noqa: E402
from adversarial_spec_tpu_torch import serve as serve_mod  # noqa: E402
from adversarial_spec_tpu_torch.obs.metrics import percentile  # noqa: E402
from adversarial_spec_tpu_torch.serve import driver  # noqa: E402
from adversarial_spec_tpu_torch.serve.client import ServeClient  # noqa: E402
from adversarial_spec_tpu_torch.serve.daemon import ServeDaemon  # noqa: E402

# -- canonical shape encoding ---------------------------------------------
#
# Everything below is FIXED so the admission estimate is an injective
# function of (spec_chars, tier) and therefore invertible from a
# recorded serve event. Changing any constant breaks replay of older
# recordings — version the recording format before touching these.

MODELS = ("mock://critic?v=0", "mock://critic?v=1")
TIER_MAX_NEW = {"interactive": 96, "batch": 384}
MIN_SPEC_CHARS = 128
MAX_SPEC_CHARS = 4096

_SPEC_HEADER = (
    "## Goals\nServe heavy replayed traffic within the SLO.\n"
    "## Constraints\n"
)
_SPEC_FILLER = "The daemon SHALL shed typed, never collapse. "


def canonical_spec(spec_chars: int) -> str:
    """The deterministic spec text of EXACTLY ``spec_chars`` characters
    (clamped to the canonical range, rounded down to a multiple of 4 so
    the 4-chars-per-token estimate divides evenly)."""
    n = max(MIN_SPEC_CHARS, min(int(spec_chars), MAX_SPEC_CHARS))
    n -= n % 4
    body = _SPEC_HEADER + _SPEC_FILLER * (
        1 + max(0, n - len(_SPEC_HEADER)) // len(_SPEC_FILLER)
    )
    return body[:n]


def est_tokens_for(
    spec_chars: int, tier: str, *, models: tuple | list = MODELS
) -> int:
    """The admission estimate the daemon will compute for a canonical
    request to the pool ``models`` — via the REAL estimator, never a
    reimplementation."""
    return driver.estimate_debate_tokens(
        {
            "spec": canonical_spec(spec_chars),
            "models": list(models),
            "max_new_tokens": TIER_MAX_NEW[tier],
        }
    )


def spec_chars_from_est(
    est_tokens: int, tier: str, *, models: tuple | list = MODELS
) -> int | None:
    """Invert ``est_tokens_for``: recorded estimate + tier → canonical
    spec length (only the pool's size enters). None when the estimate
    cannot come from a canonical request (foreign recording) — the
    tolerant reader skips those."""
    if est_tokens % len(models):
        return None
    per_opp = est_tokens // len(models)
    spec_tokens = per_opp - 256 - TIER_MAX_NEW.get(tier, 0)
    if tier not in TIER_MAX_NEW or spec_tokens < MIN_SPEC_CHARS // 4:
        return None
    chars = spec_tokens * 4
    if chars > MAX_SPEC_CHARS:
        return None
    return chars


@dataclass
class ReplayRequest:
    """One scheduled arrival: WHEN (offset from trace start), WHO
    (tenant/tier), and HOW BIG (canonical spec length)."""

    arrival_s: float
    tenant: str
    tier: str
    spec_chars: int

    @property
    def spec(self) -> str:
        return canonical_spec(self.spec_chars)

    @property
    def max_new_tokens(self) -> int:
        return TIER_MAX_NEW[self.tier]


# -- trace synthesis -------------------------------------------------------


@dataclass
class SynthSpec:
    """Seeded generator spec for a heavy-tailed multi-tenant trace.

    Defaults model the mixed corpus the matched-ceiling scouting paper
    motivates: bursty lognormal inter-arrivals (sigma 1.0 → heavy
    tail), Zipf-skewed tenants (one hot tenant, a long cold tail), a
    batch minority, and lognormal prompt sizes."""

    seed: int = 0
    requests: int = 64
    tenants: int = 4
    zipf_s: float = 1.2
    mean_interarrival_s: float = 0.02
    interarrival_sigma: float = 1.0
    batch_fraction: float = 0.25
    mean_spec_chars: float = 512.0
    spec_sigma: float = 0.6


def synthesize(spec: SynthSpec) -> list[ReplayRequest]:
    """Deterministic trace from a seed: same spec → same requests,
    byte for byte (the seed-determinism pin)."""
    rng = random.Random(spec.seed)
    weights = [1.0 / (r + 1) ** spec.zipf_s for r in range(spec.tenants)]
    # lognormal with mean spec.mean_interarrival_s: mu shifts so the
    # heavy tail does not also inflate the average offered rate.
    mu = math.log(spec.mean_interarrival_s) - spec.interarrival_sigma**2 / 2
    smu = math.log(spec.mean_spec_chars) - spec.spec_sigma**2 / 2
    out: list[ReplayRequest] = []
    t = 0.0
    for _ in range(spec.requests):
        t += rng.lognormvariate(mu, spec.interarrival_sigma)
        tenant = rng.choices(range(spec.tenants), weights=weights)[0]
        tier = "batch" if rng.random() < spec.batch_fraction else "interactive"
        chars = int(rng.lognormvariate(smu, spec.spec_sigma))
        out.append(
            ReplayRequest(
                arrival_s=round(t, 6),
                tenant=f"t{tenant}",
                tier=tier,
                # canonical_spec clamps + rounds; store the canonical
                # value so est inversion round-trips exactly.
                spec_chars=len(canonical_spec(chars)),
            )
        )
    return out


# -- trace reconstruction (tolerant reader) --------------------------------


def read_recording(path: str | Path) -> tuple[list[ReplayRequest], dict]:
    """Reconstruct the arrival trace from a flight-recorder JSONL dump.

    Journal tolerant-reader discipline (debate/journal.py): a torn
    final line (no trailing newline — a crashed writer) is discarded;
    a line that fails to parse, has a foreign event type, or carries a
    non-canonical shape is skipped ALONE and counted, never fatal.
    Only serve ``accepted``/``shed`` events with a positive
    ``arrival_s`` enter the trace (those are the admission edges the
    daemon stamps when ``ADVSPEC_OBS_ARRIVALS=1``).

    Returns (requests sorted by arrival, reader report)."""
    raw = Path(path).read_bytes()
    lines = raw.split(b"\n")
    torn = 0
    if lines and lines[-1] == b"":
        lines.pop()
    elif lines:
        lines.pop()  # torn tail: incomplete write, discard
        torn = 1
    reqs: list[ReplayRequest] = []
    skipped = 0
    for line in lines:
        if not line.strip():
            continue
        try:
            obj = json.loads(line)
        except (ValueError, UnicodeDecodeError):
            skipped += 1
            continue
        if not isinstance(obj, dict) or obj.get("type") != "serve":
            continue  # foreign/other event types: not ours to judge
        if obj.get("op") not in ("accepted", "shed"):
            continue
        arrival = obj.get("arrival_s")
        if not isinstance(arrival, (int, float)) or arrival <= 0:
            continue  # unarmed recording (or pre-arrival version)
        tier = obj.get("tier", "")
        tokens = obj.get("tokens", 0)
        if not isinstance(tokens, int):
            skipped += 1
            continue
        chars = spec_chars_from_est(tokens, tier)
        if chars is None:
            skipped += 1  # non-canonical shape: foreign workload
            continue
        reqs.append(
            ReplayRequest(
                arrival_s=float(arrival),
                tenant=str(obj.get("tenant", "t0")),
                tier=tier,
                spec_chars=chars,
            )
        )
    reqs.sort(key=lambda r: r.arrival_s)
    if reqs:
        base = reqs[0].arrival_s  # re-base: first arrival = t0
        for r in reqs:
            r.arrival_s = round(r.arrival_s - base, 6)
    report = {"requests": len(reqs), "skipped": skipped, "torn_tail": torn}
    return reqs, report


def tenant_rates(reqs: list[ReplayRequest]) -> dict[str, float]:
    """Per-tenant mean arrival rate (requests/s) over the trace span —
    the summary line obs_dump prints for armed recordings."""
    if not reqs:
        return {}
    span = max(r.arrival_s for r in reqs) - min(r.arrival_s for r in reqs)
    span = max(span, 1e-6)
    counts: dict[str, int] = {}
    for r in reqs:
        counts[r.tenant] = counts.get(r.tenant, 0) + 1
    return {t: round(c / span, 3) for t, c in sorted(counts.items())}


# -- open-loop replay ------------------------------------------------------


@dataclass
class SLOSpec:
    """The breach condition the frontier is defined against."""

    ttft_p95_s: float = 0.5
    max_shed_fraction: float = 0.02


@dataclass
class ServeKnobs:
    """The admission-side knob arm under sweep. ``replicas`` scales the
    backlog cap through the scheduler's capacity provider — the same
    mechanism the elastic fleet uses, so "replica count 1 vs 3" is an
    honest single-process stand-in for a fleet arm."""

    replicas: int = 1
    max_queue_depth: int = 8
    max_backlog_tokens: int = 24_000
    label: str = ""

    def name(self) -> str:
        return self.label or f"replicas={self.replicas}"


@dataclass
class RunResult:
    metrics: dict = field(default_factory=dict)
    transcripts: list = field(default_factory=list)


class _PressurePoller(threading.Thread):
    """Samples the stats op's ``pressure`` snapshot on a SECOND
    connection while the storm runs — brownout occupancy is the
    fraction of samples with brownout set (the wire-level view the
    stats-op fix exposes)."""

    def __init__(self, sock: str, interval_s: float = 0.025) -> None:
        super().__init__(daemon=True)
        self._sock = sock
        self._interval = interval_s
        self._halt = threading.Event()
        self.samples: list[dict] = []

    def run(self) -> None:
        try:
            client = ServeClient(self._sock, timeout_s=5)
        except OSError:
            return
        try:
            while not self._halt.is_set():
                try:
                    ev = client.stats()
                except (OSError, TimeoutError, ConnectionError):
                    return
                p = ev.get("pressure")
                if isinstance(p, dict):
                    self.samples.append(p)
                self._halt.wait(self._interval)
        finally:
            client.close()

    def stop(self) -> dict:
        self._halt.set()
        self.join(timeout=2)
        n = len(self.samples)
        if not n:
            return {"samples": 0, "brownout_occupancy": 0.0,
                    "peak_backlog_tokens": 0}
        return {
            "samples": n,
            "brownout_occupancy": round(
                sum(1 for s in self.samples if s.get("brownout")) / n, 4
            ),
            "peak_backlog_tokens": max(
                int(s.get("backlog_tokens", 0)) for s in self.samples
            ),
        }


def replay_once(
    reqs: list[ReplayRequest],
    rate: float,
    *,
    knobs: ServeKnobs | None = None,
    collect_transcripts: bool = False,
    events_out: str | None = None,
    poll_pressure: bool = True,
    collect_timeout_s: float = 120.0,
    models: tuple | list = MODELS,
) -> RunResult:
    """One open-loop replay run against a fresh in-process daemon, every
    debate to the opponent pool ``models``.

    Arrivals are SCHEDULE-FAITHFUL: request i fires at
    ``t0 + arrival_s/rate`` via a non-blocking submit; a server that
    falls behind accumulates backlog (and sheds) instead of slowing
    the arrival process. ``schedule_lateness_p99_s`` in the result is
    the fidelity check — how far behind its schedule the GENERATOR
    ran (socket-buffer pushback only, normally sub-millisecond).
    """
    knobs = knobs or ServeKnobs()
    rate = max(float(rate), 1e-6)
    old = serve_mod.config()
    old_cfg = {
        "max_queue_depth": old.max_queue_depth,
        "max_backlog_tokens": old.max_backlog_tokens,
        "tenant_quota_tokens": old.tenant_quota_tokens,
        "drain_deadline_s": old.drain_deadline_s,
    }
    serve_mod.reset_stats()
    serve_mod.configure(
        max_queue_depth=knobs.max_queue_depth,
        max_backlog_tokens=knobs.max_backlog_tokens,
        tenant_quota_tokens=0,
        drain_deadline_s=10.0,
    )
    if events_out:
        # Arm arrivals + a ring large enough for the whole run; the
        # reset re-bases the arrival epoch so offsets start near 0.
        obs_mod.configure(enabled=True, arrivals=True, recorder_size=65536)
        obs_mod.reset_stats()
    result = RunResult()
    try:
        with tempfile.TemporaryDirectory(prefix="advspec-replay-") as td:
            sock = os.path.join(td, "serve.sock")
            ready = threading.Event()
            daemon = ServeDaemon(sock, sessions_dir=os.path.join(td, "s"))
            if knobs.replicas > 1:
                daemon.sched.set_capacity_provider(lambda: knobs.replicas)
            th = threading.Thread(
                target=lambda: asyncio.run(daemon.run(ready=ready)),
                daemon=True,
            )
            th.start()
            if not ready.wait(10):
                raise RuntimeError("replay daemon did not come up")
            poller = None
            if poll_pressure:
                poller = _PressurePoller(sock)
                poller.start()
            client = ServeClient(sock, timeout_s=collect_timeout_s)
            try:
                lateness: list[float] = []
                submitted: list[tuple[str, ReplayRequest]] = []
                t0 = time.monotonic()
                for r in reqs:
                    target = t0 + r.arrival_s / rate
                    delay = target - time.monotonic()
                    if delay > 0:
                        time.sleep(delay)
                    rid = client.submit_debate(
                        r.spec,
                        list(models),
                        tenant=r.tenant,
                        tier=r.tier,
                        stream=False,
                        max_new_tokens=r.max_new_tokens,
                    )
                    lateness.append(max(0.0, time.monotonic() - target))
                    submitted.append((rid, r))
                # Collect AFTER the full schedule has fired (open loop:
                # reads never gate writes).
                ttfts: list[float] = []
                rounds: list[float] = []
                accepted = completed = shed = lost = 0
                shed_reasons: dict[str, int] = {}
                for rid, r in submitted:
                    evs = client.collect(rid, timeout_s=collect_timeout_s)
                    last = evs[-1]
                    if evs[0]["event"] == "accepted":
                        accepted += 1
                        opp_errors = [
                            x["error"]
                            for x in last.get("results", [])
                            if x.get("error")
                        ]
                        if (
                            last["event"] != "result"
                            or last.get("error")
                            or opp_errors
                        ):
                            lost += 1
                            if collect_transcripts:
                                result.transcripts.append(None)
                            continue
                        completed += 1
                        ttfts.append(float(last["ttft_s"]))
                        rounds.append(float(last["wall_s"]))
                        if collect_transcripts:
                            result.transcripts.append(
                                [x["response"] for x in last["results"]]
                            )
                    elif last["event"] == "shed":
                        shed += 1
                        reason = last.get("reason", "?")
                        shed_reasons[reason] = shed_reasons.get(reason, 0) + 1
                        if collect_transcripts:
                            result.transcripts.append(None)
                    else:
                        lost += 1
                        if collect_transcripts:
                            result.transcripts.append(None)
                wall = max(time.monotonic() - t0, 1e-6)
                pressure = poller.stop() if poller else {"samples": 0}
                client.drain()
            finally:
                client.close()
                if poller:
                    poller.stop()
                th.join(timeout=15)
            if events_out:
                obs_mod.dump_events(events_out)
        total = max(len(submitted), 1)
        result.metrics = {
            "arm": knobs.name(),
            "rate_multiplier": round(rate, 4),
            "offered": len(submitted),
            "offered_per_s": round(len(submitted) / wall, 3),
            "accepted": accepted,
            "completed": completed,
            "shed": shed,
            "lost": lost,
            "shed_reasons": shed_reasons,
            "shed_fraction": round(shed / total, 4),
            "debates_per_s": round(completed / wall, 3),
            "wall_s": round(wall, 3),
            "ttft_p50_s": round(percentile(ttfts, 0.5), 6),
            "ttft_p95_s": round(percentile(ttfts, 0.95), 6),
            "ttft_p99_s": round(percentile(ttfts, 0.99), 6),
            "round_p50_s": round(percentile(rounds, 0.5), 6),
            "round_p95_s": round(percentile(rounds, 0.95), 6),
            "round_p99_s": round(percentile(rounds, 0.99), 6),
            "schedule_lateness_p99_s": round(
                percentile(lateness, 0.99), 6
            ),
            "pressure": pressure,
        }
        return result
    finally:
        serve_mod.configure(**old_cfg)


def slo_breaches(metrics: dict, slo: SLOSpec) -> list[str]:
    """Typed breach list (empty = within SLO). Lost accepted work is
    ALWAYS a breach — a frontier that drops requests is not capacity."""
    out = []
    if metrics.get("lost"):
        out.append(f"lost {metrics['lost']} accepted request(s)")
    if metrics.get("ttft_p95_s", 0.0) > slo.ttft_p95_s:
        out.append(
            f"ttft_p95 {metrics['ttft_p95_s']:.4f}s > {slo.ttft_p95_s}s"
        )
    if metrics.get("shed_fraction", 0.0) > slo.max_shed_fraction:
        out.append(
            f"shed_fraction {metrics['shed_fraction']:.4f} > "
            f"{slo.max_shed_fraction}"
        )
    return out


# -- frontier sweep --------------------------------------------------------


def sweep_arm(
    reqs: list[ReplayRequest],
    knobs: ServeKnobs,
    slo: SLOSpec,
    *,
    k_start: float = 1.0,
    max_doublings: int = 4,
    bisect_iters: int = 2,
    log=lambda m: None,
) -> dict:
    """Binary-search the rate multiplier k for one knob arm: double
    from ``k_start`` until the SLO breaches (or the doubling budget
    runs out — reported as an UNBREACHED frontier, a lower bound),
    then bisect. The frontier is the measured accepted-debates/s of
    the highest non-breaching run."""

    def probe(k: float) -> tuple[dict, list[str]]:
        m = replay_once(reqs, k, knobs=knobs).metrics
        b = slo_breaches(m, slo)
        log(
            f"  {knobs.name()} k={k:g}: {m['debates_per_s']} deb/s, "
            f"ttft_p95={m['ttft_p95_s']}s, shed={m['shed_fraction']}"
            + (f" BREACH ({'; '.join(b)})" if b else "")
        )
        return m, b

    probes = 0
    good_k, good_m = 0.0, None
    bad_k = None
    k = max(k_start, 1e-3)
    for _ in range(max_doublings + 1):
        m, b = probe(k)
        probes += 1
        if b:
            bad_k = k
            break
        good_k, good_m = k, m
        k *= 2
    if bad_k is not None and good_m is not None:
        lo, hi = good_k, bad_k
        for _ in range(bisect_iters):
            mid = (lo + hi) / 2
            m, b = probe(mid)
            probes += 1
            if b:
                hi = mid
            else:
                lo, good_k, good_m = mid, mid, m
    if good_m is None:
        # Breached at k_start: the frontier is below the first probe.
        return {
            "k_at_slo": 0.0,
            "debates_per_s": 0.0,
            "breached": True,
            "probes": probes,
            "at_frontier": m,
        }
    return {
        "k_at_slo": round(good_k, 4),
        "debates_per_s": good_m["debates_per_s"],
        "breached": bad_k is not None,
        "probes": probes,
        "at_frontier": good_m,
    }


def frontier_sweep(
    reqs: list[ReplayRequest],
    arms: list[ServeKnobs],
    slo: SLOSpec,
    *,
    k_start: float = 1.0,
    max_doublings: int = 4,
    bisect_iters: int = 2,
    log=lambda m: None,
) -> dict:
    frontier = {}
    for knobs in arms:
        log(f"sweeping arm {knobs.name()}")
        frontier[knobs.name()] = sweep_arm(
            reqs,
            knobs,
            slo,
            k_start=k_start,
            max_doublings=max_doublings,
            bisect_iters=bisect_iters,
            log=log,
        )
    return frontier


def bench_payload(
    frontier: dict,
    slo: SLOSpec,
    trace_note: str,
    *,
    platform: str = "cpu",
    baseline_path: Path | None = None,
) -> dict:
    """The BENCH_capacity.json shape (bench_trend ``_CAPACITY_REQUIRED``).
    Headline = the FIRST arm's frontier (the baseline configuration);
    ``vs_baseline`` compares it against the committed file so a >10%
    frontier drop trips bench_trend."""
    first = next(iter(frontier.values()))
    value = float(first["debates_per_s"])
    vs = None
    if baseline_path and baseline_path.is_file():
        try:
            prev = json.loads(baseline_path.read_text(encoding="utf-8"))
            prev_v = float(prev.get("value", 0.0))
            if prev_v > 0:
                vs = round(value / prev_v, 4)
        except (ValueError, OSError):
            vs = None
    return {
        "metric": "serve_capacity_frontier_debates_per_s",
        "value": value,
        "unit": "accepted mock debates/s at the SLO frontier "
        "(open-loop seeded replay, first knob arm)",
        "vs_baseline": vs,
        "platform": platform,
        "within_budget": vs is None or vs >= 0.9,
        "frontier": frontier,
        "slo": {
            "ttft_p95_s": slo.ttft_p95_s,
            "max_shed_fraction": slo.max_shed_fraction,
        },
        "trace": trace_note,
        "escape_hatch": "harness-only: the daemon and scheduler are "
        "unchanged; delete BENCH_capacity.json to drop the gate",
    }


# -- CLI -------------------------------------------------------------------


def _default_arms() -> list[ServeKnobs]:
    return [ServeKnobs(replicas=1), ServeKnobs(replicas=3)]


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--replay", help="flight-recorder JSONL to replay")
    ap.add_argument("--seed", type=int, default=0, help="synthetic seed")
    ap.add_argument(
        "--requests", type=int, default=64, help="synthetic trace size"
    )
    ap.add_argument(
        "--rate", type=float, help="single run at this rate multiplier"
    )
    ap.add_argument(
        "--sweep", action="store_true", help="frontier sweep (two arms)"
    )
    ap.add_argument(
        "--smoke",
        action="store_true",
        help="tiny seeded sweep (16 requests, two doublings, one bisection)",
    )
    ap.add_argument("--slo-ttft-p95", type=float, default=0.5)
    ap.add_argument("--slo-shed", type=float, default=0.02)
    ap.add_argument("--bench-out", help="write BENCH-style payload here")
    ap.add_argument(
        "--events-out", help="dump armed flight-recorder JSONL after a "
        "--rate run (a recording replayable via --replay)"
    )
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args(argv)

    def log(msg: str) -> None:
        print(f"load_replay: {msg}", file=sys.stderr, flush=True)

    if args.replay:
        reqs, report = read_recording(args.replay)
        trace_note = (
            f"recorded {args.replay} ({report['requests']} requests, "
            f"{report['skipped']} skipped, torn_tail={report['torn_tail']})"
        )
        if not reqs:
            log(f"no replayable arrivals in {args.replay} ({report})")
            return 2
    else:
        n = 16 if args.smoke else args.requests
        reqs = synthesize(SynthSpec(seed=args.seed, requests=n))
        trace_note = f"synthetic seed={args.seed} requests={n}"
    log(f"trace: {trace_note}; tenant rates {tenant_rates(reqs)}")

    slo = SLOSpec(
        ttft_p95_s=args.slo_ttft_p95, max_shed_fraction=args.slo_shed
    )
    if args.rate is not None and not (args.sweep or args.smoke):
        res = replay_once(
            reqs, args.rate, events_out=args.events_out
        )
        breaches = slo_breaches(res.metrics, slo)
        payload = {**res.metrics, "slo_breaches": breaches}
        print(json.dumps(payload, indent=None if args.json else 2))
        return 0

    doublings, iters = (2, 1) if args.smoke else (4, 2)
    frontier = frontier_sweep(
        reqs,
        _default_arms(),
        slo,
        max_doublings=doublings,
        bisect_iters=iters,
        log=log,
    )
    payload = bench_payload(
        frontier,
        slo,
        trace_note,
        # The smoke's 16-request trace is not comparable to the
        # committed 64-request pin — its payload is schema-validated
        # only (vs_baseline null), never trend-compared.
        baseline_path=None if args.smoke else REPO / "BENCH_capacity.json",
    )
    out = json.dumps(payload, indent=2, sort_keys=True)
    if args.bench_out:
        Path(args.bench_out).write_text(out + "\n", encoding="utf-8")
        log(f"wrote {args.bench_out}")
    print(out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
