"""Autocorrelation tempogram (port of
``stratum_dsp_tpu/features/period/tempogram_autocorr.py``,
tempogram_autocorr.rs:79-178): for each BPM hypothesis, the mean of
novelty[i] * novelty[i + lag], lag = floor(frame_rate / (bpm/60)), read off
one zero-padded FFT autocorrelation per track."""

from __future__ import annotations

import functools

import numpy as np
import torch

from ... import tracing
from ...ops.masked import cdiv
from .tempogram_fft import next_pow2


@functools.lru_cache(maxsize=64)
def bpm_grid(min_bpm: float, max_bpm: float, resolution: float) -> np.ndarray:
    """The reference's f32-accumulated BPM grid (tempogram_autocorr.rs:128-162)."""
    grid = []
    bpm = np.float32(min_bpm)
    while bpm <= np.float32(max_bpm):
        grid.append(float(bpm))
        bpm = np.float32(bpm + np.float32(resolution))
    return np.asarray(grid, dtype=np.float32)


@functools.lru_cache(maxsize=64)
def bpm_lags(min_bpm: float, max_bpm: float, resolution: float, frame_rate: float) -> np.ndarray:
    """Per-hypothesis lags floor(frame_rate / (bpm/60)) (tempogram_autocorr.rs:133-140)."""
    grid = bpm_grid(min_bpm, max_bpm, resolution)
    return np.floor(np.float32(frame_rate) / (grid / np.float32(60.0))).astype(np.int64)


def linear_autocorrelation(x, max_lag: int):
    """ACF[l] = sum_i x[i]*x[i+l] for l <= max_lag, via rFFT, clamped >= 0."""
    nfft = next_pow2(x.shape[-1] + max_lag + 1)
    spec = torch.fft.rfft(x, n=nfft, dim=-1)
    power = spec.real * spec.real + spec.imag * spec.imag
    return torch.fft.irfft(power, n=nfft, dim=-1)[..., :max_lag + 1].clamp_min(0.0)


def autocorr_tempogram(novelty, nov_mask, n_valid, frame_rate: float, min_bpm: float,
                       max_bpm: float, resolution: float):
    """Strengths over the BPM grid: (strength [B, n_bpm], grid np[n_bpm]);
    strength = ACF[lag] / max(n_valid - lag, 0), 0 where that count is 0."""
    grid = bpm_grid(min_bpm, max_bpm, resolution)
    lags = bpm_lags(min_bpm, max_bpm, resolution, frame_rate)
    max_lag = int(lags.max()) if len(lags) else 0
    acf = linear_autocorrelation(torch.where(nov_mask, novelty, 0.0), max_lag)
    with tracing.host_read("autocorr.lags"):
        lag_t = torch.as_tensor(lags, device=novelty.device)
    count = (n_valid[:, None] - lag_t[None, :]).clamp_min(0)
    strength = torch.where(count > 0, acf[:, lag_t] / count.clamp_min(1), 0.0)
    return strength, grid


def ac_lookup_nearest(strength, grid: np.ndarray, query, tol: float):
    """Nearest grid point within ``tol`` BPM (tempogram.rs:518-529); half-grid
    queries resolve to the lower point."""
    g0 = float(grid[0])
    res = float(grid[1] - grid[0]) if len(grid) > 1 else 1.0
    idx = torch.ceil(cdiv(query - g0, res) - 0.5).to(torch.int64).clamp(0, len(grid) - 1)
    with tracing.host_read("autocorr.grid"):
        grid_t = torch.as_tensor(grid, device=strength.device)
    ok = (grid_t[idx] - query).abs() <= tol
    vals = torch.gather(strength, -1, idx.reshape(strength.shape[0], -1)).reshape(query.shape)
    return torch.where(ok, vals, 0.0)
