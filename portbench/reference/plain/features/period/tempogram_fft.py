"""FFT tempogram (port of ``stratum_dsp_tpu/features/period/tempogram_fft.py``,
tempogram_fft.rs:78-236): DC removal, per-track Hann window over the novelty
curve, zero-padded power spectrum, bins -> BPM restricted to the BPM range."""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from ...ops.masked import cdiv

EPSILON = 1e-10
MIN_RESOLUTION_BPM = 0.7  # finest BPM grid spacing (see the reference module)


def next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def padded_fft_size(n: int, frame_rate: float) -> int:
    """Next pow2 of the novelty length, padded so the BPM grid spacing
    frame_rate*60/fft_size is at most MIN_RESOLUTION_BPM."""
    need = int(np.ceil(frame_rate * 60.0 / MIN_RESOLUTION_BPM))
    return next_pow2(max(n, need))


@functools.lru_cache(maxsize=64)
def fft_bpm_bins(fft_size: int, frame_rate: float, min_bpm: float,
                 max_bpm: float) -> Tuple[int, int, np.ndarray]:
    """In-range rFFT bin span: (bin_lo, bin_hi_inclusive, bpm_values f32)."""
    freq_res = frame_rate / fft_size
    bpms = np.arange(fft_size // 2 + 1) * freq_res * 60.0
    inside = np.nonzero((bpms >= min_bpm) & (bpms <= max_bpm))[0]
    if len(inside) == 0:
        return 0, 0, np.zeros(1, np.float32)
    lo, hi = int(inside[0]), int(inside[-1])
    return lo, hi, bpms[lo:hi + 1].astype(np.float32)


def fft_tempogram_power(novelty, nov_mask, n_valid, frame_rate: float, min_bpm: float,
                        max_bpm: float, fft_size: int):
    """Power over the in-range BPM bins: (power [B, NB], bpm_values np[NB])."""
    n = novelty.shape[1]
    assert fft_size >= n
    mean = torch.where(nov_mask, novelty, 0.0).sum(dim=-1, keepdim=True) / \
        n_valid.clamp_min(1)[:, None]
    i = torch.arange(n, device=novelty.device, dtype=torch.float32)
    denom = (n_valid.to(torch.float32) - 1.0).clamp_min(1.0)[:, None]
    w = 0.5 * (1.0 - torch.cos(2.0 * np.pi * i[None, :] / denom))
    w = torch.where(n_valid[:, None] > 1, w, 1.0)
    x = torch.where(nov_mask, (novelty - mean) * w, 0.0)
    spec = torch.fft.rfft(x, n=fft_size, dim=-1)
    power = spec.real * spec.real + spec.imag * spec.imag
    lo, hi, bpms = fft_bpm_bins(fft_size, frame_rate, min_bpm, max_bpm)
    return power[:, lo:hi + 1], bpms


def fft_lookup_nearest(power, bpms: np.ndarray, query, tol: float, frame_rate: float,
                       fft_size: int):
    """Nearest in-range bin within ``tol`` BPM (tempogram.rs:518-529); half-grid
    ties resolve low. 0 where no bin is within tol."""
    step = frame_rate / fft_size * 60.0
    lo_bin = int(round((float(bpms[0]) if len(bpms) else 0.0) / step))
    idx = torch.ceil(cdiv(query, step) - 0.5).to(torch.int64)
    idx = (idx - lo_bin).clamp(0, power.shape[-1] - 1)
    bin_bpm = (idx + lo_bin).to(torch.float32) * step
    ok = (bin_bpm - query).abs() <= tol
    vals = torch.gather(power, -1, idx.reshape(power.shape[0], -1)).reshape(query.shape)
    return torch.where(ok, vals, 0.0)
