"""The trace reduction on events made by hand: busy time is the union of
the device intervals, idle gaps are named by the innermost host op."""

from __future__ import annotations

import pytest

from portbench import tracing


class Ev:
    def __init__(self, name, start, end, kind, tid=1):
        self._n, self._s, self._e, self._k, self._t = name, start, end, kind, tid

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._e - self._s

    def device_type(self):
        return "DeviceType.CUDA" if self._k == "device" else "DeviceType.CPU"

    def start_thread_id(self):
        return self._t


US = 1000


def test_union_gaps_and_names():
    evs = [
        Ev("portbench.round", 0, 1000 * US, "host"),
        Ev("portbench.round", 0, 1000 * US, "device"),  # the span's copy on the card
        Ev("aten::mm", 100 * US, 300 * US, "host"),
        Ev("cudaStreamSynchronize", 600 * US, 900 * US, "host"),
        Ev("gemm", 0, 200 * US, "device"),
        Ev("attn", 150 * US, 250 * US, "device"),  # overlaps gemm
        Ev("Memcpy DtoD", 400 * US, 500 * US, "device"),
        Ev("gemm", 520 * US, 540 * US, "device"),
        Ev("other thread op", 0, 1000 * US, "host", tid=7),
    ]
    out = tracing.reduce_events(evs, host_tid=99)
    assert out["window_s"] == pytest.approx(1e-3)
    assert out["busy_s"] == pytest.approx((250 + 100 + 20) * 1e-6)
    assert dict(out["device_ops"])["gemm"] == pytest.approx(220e-6)
    gaps = dict(out["idle_gaps"])
    # 250-400 under aten::mm? No: mm ends at 300; the gap's middle (325)
    # is in the round alone. 500-520 is short. 540-1000's middle (770)
    # is inside the synchronize.
    assert gaps["portbench.round"] == pytest.approx(150e-6)
    assert gaps["gaps under 50 us"] == pytest.approx(20e-6)
    assert gaps["portbench.round > cudaStreamSynchronize"] == pytest.approx(460e-6)
    assert sum(gaps.values()) + out["busy_s"] == pytest.approx(out["window_s"])


def test_no_span_no_reading():
    assert tracing.reduce_events([Ev("gemm", 0, 10, "device")], host_tid=1) == {}
