"""The trace reduction on a hand-made Chrome trace."""

import pytest

from portbench import layers, trace
from types import SimpleNamespace


def ev(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


EVENTS = [
    ev(trace.WINDOW, "user_annotation", 0, 1000),
    ev("portbench.analyze_batch", "user_annotation", 0, 900),
    ev("aten::copy_", "cpu_op", 340, 90),
    ev("aten::where", "cpu_op", 600, 50),
    ev("fused_novelty_kernel", "kernel", 100, 200),
    ev("fused_novelty_kernel", "kernel", 250, 100),  # overlaps the first
    ev("Memcpy DtoH", "gpu_memcpy", 420, 80),
    ev("other_kernel", "kernel", 950, 100),  # cut at the window's end
    ev("outside", "kernel", 2000, 10),
]


def test_busy_window_and_names():
    s = trace.reduce(EVENTS)
    assert s["window_s"] == pytest.approx(1e-3)
    assert s["busy_s"] == pytest.approx((250 + 80 + 50) * 1e-6)
    assert s["kernels"] == 3
    assert trace.device_seconds(s, "fused_novelty_kernel") == pytest.approx(300e-6)
    assert trace.device_seconds(s, "polyphase_stage2_kernel") is None


def test_idle_gaps_by_cause():
    s = trace.reduce(EVENTS)
    idle = s["idle_by_cause"]
    assert idle["portbench.analyze_batch/no host op"] == pytest.approx((100 + 450) * 1e-6)
    assert idle["portbench.analyze_batch/aten::copy_"] == pytest.approx(70e-6)
    assert sum(idle.values()) == pytest.approx(1e-3 - s["busy_s"])


def test_no_window_raises():
    with pytest.raises(ValueError):
        trace.reduce(EVENTS[1:])


def test_idle_share_never_reads_zero_without_a_trace():
    ctx = SimpleNamespace(summary=None, window={"attempted": 0})
    assert layers.idle_share_pct(ctx) is None
    assert layers.launches_per_track(ctx) is None
