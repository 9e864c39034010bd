"""The traced run's device trace, reduced in memory.

``torch.profiler`` (host ops and device activity) runs over the first
rounds of the window. Its events are reduced at once, and nothing is
written to disk: every device interval (kernels, copies, sets), the union
of those intervals (busy time), the idle gaps between them, each gap named
by what the host thread that runs the rounds was doing at the gap's
middle (the innermost host op there, under the benchmark's own span), and
device time summed by kernel name.
"""

from __future__ import annotations

import threading
from collections import defaultdict

SHORT_GAP_S = 50e-6  # gaps shorter than this are summed under one name
NAME_CHARS = 120


class DeviceTrace:
    """Start before the traced rounds, ``stop`` after them. Host events
    are those of the thread that starts it (the profiler numbers its
    threads, so that of the benchmark's ``portbench.`` spans too)."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile

        self.tid = threading.get_native_id()
        import torch

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
        self.prof = profile(activities=acts)
        self.prof.start()

    def stop(self) -> dict:
        self.prof.stop()
        res = self.prof.profiler.kineto_results
        return reduce_events(res.events(), self.tid)


def reduce_events(events, host_tid: int) -> dict:
    """Device intervals, busy union, named idle gaps and time by kernel,
    in seconds, over the span from the first to the last event of a
    ``portbench.`` span on the host thread."""
    dev, other = [], []
    spans, threads = [], {host_tid}
    for ev in events:
        start = ev.start_ns()
        end = start + ev.duration_ns()
        if end <= start:
            continue
        name = ev.name()
        # On the card's timeline: kernels, copies, sets, and the profiler's
        # copies of the benchmark's spans (the program opens none).
        if "CUDA" in str(ev.device_type()):
            if not name.startswith("portbench."):
                dev.append((start, end, name))
        else:
            other.append((start, end, name, ev.start_thread_id()))
            if name.startswith("portbench."):
                spans.append((start, end))
                threads.add(ev.start_thread_id())
    host = [(s, e, n) for s, e, n, t in other if t in threads]
    if not spans:
        return {}
    w0, w1 = min(s for s, _ in spans), max(e for _, e in spans)
    dev = [(max(s, w0), min(e, w1), n) for s, e, n in dev if e > w0 and s < w1]
    dev.sort()
    by_name: dict[str, float] = defaultdict(float)
    for s, e, n in dev:
        by_name[n] += (e - s) * 1e-9
    busy, gaps = 0, []
    cur_s, cur_e = None, w0
    for s, e, _ in dev:
        if cur_s is None or s > cur_e:
            if cur_s is not None:
                busy += cur_e - cur_s
            if s > cur_e:
                gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_s is not None:
        busy += cur_e - cur_s
    if w1 > cur_e:
        gaps.append((cur_e, w1))
    named = _name_gaps(gaps, host)
    return {
        "window_s": (w1 - w0) * 1e-9,
        "busy_s": busy * 1e-9,
        "device_ops": sorted(by_name.items(), key=lambda kv: -kv[1]),
        "idle_gaps": sorted(named.items(), key=lambda kv: -kv[1]),
    }


def _name_gaps(gaps: list, host: list) -> dict[str, float]:
    """Idle seconds by what the host was doing: a sweep over the host
    events (nested on one thread) and the gaps' middles, both in time
    order."""
    host.sort(key=lambda h: (h[0], -h[1]))
    out: dict[str, float] = defaultdict(float)
    stack: list = []
    i = 0
    for g0, g1 in gaps:
        secs = (g1 - g0) * 1e-9
        if secs < SHORT_GAP_S:
            out[f"gaps under {int(SHORT_GAP_S * 1e6)} us"] += secs
            continue
        mid = (g0 + g1) // 2
        while i < len(host) and host[i][0] <= mid:
            while stack and stack[-1][1] < host[i][0]:
                stack.pop()
            stack.append(host[i])
            i += 1
        while stack and stack[-1][1] < mid:
            stack.pop()
        inner = stack[-1][2] if stack else "no host op"
        outer = next((h[2] for h in reversed(stack) if h[2].startswith("portbench.")),
                     "portbench.between")
        label = inner if inner == outer else f"{outer} > {inner}"
        out[label[:NAME_CHARS]] += secs
    return out
