"""What the per-layer readers of ``portbench/metrics/`` share: the device's
idle share and launches per track from the traced window's summary, and each
track's frames from the window's answers."""

from __future__ import annotations

import numpy as np


def idle_share_pct(ctx):
    """Per cent of the traced window in which no kernel, copy or set ran."""
    s = ctx.summary
    if s is None or s["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - s["busy_s"] / s["window_s"])


def launches_per_track(ctx):
    s = ctx.summary
    if s is None or not ctx.window["attempted"]:
        return None
    return s["kernels"] / ctx.window["attempted"]


def track_samples(host: dict, sample_rate: int) -> np.ndarray:
    """Each track's samples after the silence trim, from its duration."""
    return np.round(np.asarray(host["duration_seconds"], np.float64) * sample_rate).astype(
        np.int64)


def frames(n_samples: np.ndarray, frame_size: int, hop: int) -> list:
    return [int((n - frame_size) // hop + 1) if n >= frame_size else 0 for n in n_samples]
