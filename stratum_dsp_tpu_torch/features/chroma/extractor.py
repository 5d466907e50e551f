"""Chroma / HPCP extraction and key-path spectrogram conditioning (port of
``stratum_dsp_tpu/features/chroma/extractor.py``; chroma/extractor.rs).

* Chroma mapping is a matmul: the bin -> pitch-class circular-Gaussian soft
  mapping (extractor.rs:393-487) is a ``[K, 12]`` projection for a given
  (sample_rate, fft_size, sigma, tuning); chroma = compressed magnitudes @ W,
  then per-frame L2. A per-track tuning gives a ``[B, K, 12]`` projection.
* HPCP (extractor.rs:556-680): the top-K spectral peaks are selected either by
  bisecting for the K-th largest peak value, the whole harmonic fan-out being
  a product with a ``[bins, 12]`` harmonic projection (one kernel on the card,
  ``ops/hpcp.py``), or exactly, by a stable sort, with the fan-out computed
  per peak.
* Conditioning (extractor.rs:1246-1501): time smoothing and the harmonic soft
  time-mask are windowed means over +-margin frames (a banded matmul); the
  median-filter HPSS mask runs on the time-downsampled, band-limited
  spectrogram.
* Tuning estimation (extractor.rs:66-170): the weighted circular mean of
  semitone residuals.
* Log-frequency (extractor.rs:701-807): the linear -> semitone-bin conversion
  is another static projection matrix.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ... import tracing
from ...ops import hpcp, masked
from .postprocess import l2_normalize_zero

A4_FREQ = 440.0
SEMITONE_OFFSET = 57.0
CHROMA_FMIN_HZ = 100.0
CHROMA_FMAX_HZ = 5000.0


def bin_freqs(sample_rate: int, fft_size: int, n_bins: int) -> np.ndarray:
    return np.arange(n_bins) * (sample_rate / fft_size)


def semitones_of_bins(sample_rate: int, fft_size: int, n_bins: int) -> np.ndarray:
    f = np.maximum(bin_freqs(sample_rate, fft_size, n_bins), 1e-6)
    return 12.0 * np.log2(f / A4_FREQ) + SEMITONE_OFFSET


def _chroma_in_band(sample_rate: int, fft_size: int, fmin_hz: float, fmax_hz: float) -> np.ndarray:
    freqs = bin_freqs(sample_rate, fft_size, fft_size // 2 + 1)
    return ((freqs >= fmin_hz) & (freqs <= min(fmax_hz, sample_rate / 2))
            & (freqs < sample_rate / 2))


@functools.lru_cache(maxsize=32)
def chroma_projection_matrix(sample_rate: int, fft_size: int, soft_mapping: bool, sigma: float,
                             tuning_offset: float = 0.0, fmin_hz: float = CHROMA_FMIN_HZ,
                             fmax_hz: float = CHROMA_FMAX_HZ) -> np.ndarray:
    """Static ``[K, 12]`` bin -> pitch-class projection (extractor.rs:393-487):
    band limit, circular-Gaussian soft mapping over the 3 nearest classes (or
    hard assignment). Applied to magnitudes already compressed by ^0.6."""
    n_bins = fft_size // 2 + 1
    semis = semitones_of_bins(sample_rate, fft_size, n_bins) - tuning_offset
    w = np.zeros((n_bins, 12), dtype=np.float32)
    in_band = _chroma_in_band(sample_rate, fft_size, fmin_hz, fmax_hz)
    pc = np.mod(semis, 12.0)
    primary = np.mod(np.round(pc), 12).astype(np.int64)
    if soft_mapping:
        sig = max(sigma, 1e-6)
        for off in (-1, 0, 1):
            cls = np.mod(primary + off, 12)
            dist = np.abs(pc - cls)
            dist = np.minimum(dist, 12.0 - dist)
            wt = np.exp(-dist * dist / (2.0 * sig * sig)) * in_band
            np.add.at(w, (np.arange(n_bins), cls), wt)
    else:
        np.add.at(w, (np.arange(n_bins), primary), in_band.astype(np.float32))
    return w


def _soft_class_weights(pc: torch.Tensor, sigma: float, soft: bool = True):
    """[(class index int64, circular-Gaussian weight)] of the pitch classes
    around the positions ``pc`` in [0, 12): the nearest class and, with
    ``soft``, its two neighbours (the nearest alone has weight 1 without)."""
    primary = torch.remainder(torch.round(pc), 12.0)
    if not soft:
        return [(primary.to(torch.int64), torch.ones_like(pc))]
    sig = max(sigma, 1e-6)
    out = []
    for off in (-1.0, 0.0, 1.0):
        cls = torch.remainder(primary + off, 12.0)
        dist = (pc - cls).abs()
        dist = torch.minimum(dist, 12.0 - dist)
        out.append((cls.to(torch.int64), torch.exp(masked.cdiv(-dist * dist, 2.0 * sig * sig))))
    return out


def chroma_projection_dynamic(sample_rate: int, fft_size: int, soft_mapping: bool, sigma: float,
                              tuning_offset: torch.Tensor, fmin_hz: float = CHROMA_FMIN_HZ,
                              fmax_hz: float = CHROMA_FMAX_HZ) -> torch.Tensor:
    """Per-track ``[B, K, 12]`` projection for tuning offsets ``[B]`` (the
    tuning-compensated form of ``chroma_projection_matrix``)."""
    n_bins = fft_size // 2 + 1
    dev = tuning_offset.device
    semis = torch.as_tensor(semitones_of_bins(sample_rate, fft_size, n_bins).astype(np.float32),
                            device=dev)
    in_band = torch.as_tensor(_chroma_in_band(sample_rate, fft_size, fmin_hz, fmax_hz)
                              .astype(np.float32), device=dev)
    pc = torch.remainder(semis[None, :] - tuning_offset.to(torch.float32)[:, None], 12.0)
    w = torch.zeros((tuning_offset.shape[0], n_bins, 12), dtype=torch.float32, device=dev)
    for cls, wt in _soft_class_weights(pc, sigma, soft_mapping):
        w.scatter_add_(-1, cls[..., None], (wt * in_band)[..., None])
    return w


def frames_to_chroma(spec: torch.Tensor, projection: torch.Tensor,
                     mag_compression: float = 0.6) -> torch.Tensor:
    """Chroma [..., 12] from magnitudes [..., K]: compress, project, L2. The
    compression runs in ``spec``'s dtype, the product in f32."""
    m = torch.pow(spec.clamp_min(0.0), mag_compression)
    return l2_normalize_zero(torch.matmul(m.to(torch.float32), projection))


def spectral_whiten(spec: torch.Tensor, smooth_bins: int) -> torch.Tensor:
    """Per-frame moving-average whitening (extractor.rs:556-580): divide by
    the local mean over an odd window, clip at 20."""
    half = (max(smooth_bins, 3) | 1) // 2
    x = spec.clamp_min(0.0)
    n = spec.shape[-1]
    c0 = F.pad(torch.cumsum(x, dim=-1), (1, 0))
    idx = torch.arange(n, device=spec.device)
    lo = (idx - half).clamp_min(0)
    hi = (idx + half).clamp_max(n - 1)
    mean = (c0[..., hi + 1] - c0[..., lo]) / (hi - lo + 1).to(torch.float32)
    return (x / (mean + 1e-12)).clamp_max(20.0)


def _harmonic_grid(sample_rate: int, fft_size: int, hi_bin: int, num_harmonics: int,
                   harmonic_decay: float, fmin: float, fmax: float):
    """Host tables of the harmonic fan-out of every bin: semitone positions
    ``[K, H]`` (f64), harmonic weights ``[H]`` and the in-band mask ``[K, H]``."""
    f0 = np.arange(hi_bin) * (sample_rate / fft_size)
    h = np.arange(1, max(num_harmonics, 1) + 1, dtype=np.float64)
    fh = f0[:, None] * h
    h_ok = (fh >= fmin) & (fh <= fmax) & (f0[:, None] > 0.0)
    hw = (float(np.clip(harmonic_decay, 0.0, 1.0)) ** (h - 1.0)) / h
    semis = 12.0 * np.log2(np.maximum(fh, 1e-6) / A4_FREQ) + SEMITONE_OFFSET
    return semis, hw, h_ok


@functools.lru_cache(maxsize=32)
def hpcp_harmonic_matrix(sample_rate: int, fft_size: int, hi_bin: int, sigma: float,
                         tuning_offset: float, num_harmonics: int, harmonic_decay: float,
                         fmin: float, fmax: float) -> np.ndarray:
    """Static ``[hi_bin, 12]`` harmonic-summation projection: row k is the
    weight a selected peak at bin k adds to each pitch class over all
    harmonics and the 3 circular-Gaussian neighbours (extractor.rs:582-680)."""
    m = np.zeros((hi_bin, 12), dtype=np.float32)
    sig = max(sigma, 1e-6)
    semis, hw, h_ok = _harmonic_grid(sample_rate, fft_size, hi_bin, num_harmonics,
                                     harmonic_decay, fmin, fmax)
    pc = np.mod(semis - tuning_offset, 12.0)
    primary = np.mod(np.round(pc), 12.0)
    rows = np.repeat(np.arange(hi_bin), hw.shape[0])
    for off in (-1.0, 0.0, 1.0):
        cls = np.mod(primary + off, 12.0)
        dist = np.abs(pc - cls)
        dist = np.minimum(dist, 12.0 - dist)
        wt = np.exp(-dist * dist / (2.0 * sig * sig)) * hw * h_ok
        np.add.at(m, (rows, cls.astype(np.int64).ravel()), wt.ravel())
    return m


def hpcp_harmonic_matrix_on(device, sample_rate: int, fft_size: int, hi_bin: int, sigma: float,
                            tuning_offset: float, num_harmonics: int, harmonic_decay: float,
                            fmin: float, fmax: float) -> torch.Tensor:
    """``hpcp_harmonic_matrix`` on ``device``, copied there once per device
    and parameters: a copy from pageable memory waits for the stream, so a
    copy per key chunk would drain it each time."""
    return _hpcp_harmonic_matrix_on(str(torch.device(device)), sample_rate, fft_size, hi_bin,
                                    sigma, tuning_offset, num_harmonics, harmonic_decay, fmin,
                                    fmax)


@functools.lru_cache(maxsize=32)
def _hpcp_harmonic_matrix_on(device: str, *params) -> torch.Tensor:
    with tracing.host_read("chroma.hpcp_matrix"):
        return torch.as_tensor(hpcp_harmonic_matrix(*params), device=device)


def hpcp_harmonic_matrix_dynamic(sample_rate: int, fft_size: int, hi_bin: int, sigma: float,
                                 tuning_offset: torch.Tensor, num_harmonics: int,
                                 harmonic_decay: float, fmin: float, fmax: float) -> torch.Tensor:
    """``hpcp_harmonic_matrix`` for tuning offsets on the device: ``[...,
    hi_bin, 12]`` with the leading dims of ``tuning_offset`` (per-track
    offsets give ``[B, hi_bin, 12]``)."""
    dev = tuning_offset.device
    semis_np, hw_np, ok_np = _harmonic_grid(sample_rate, fft_size, hi_bin, num_harmonics,
                                            harmonic_decay, fmin, fmax)
    f32 = lambda a: torch.as_tensor(a.astype(np.float32), device=dev)  # noqa: E731
    t = tuning_offset.to(torch.float32)
    pc = torch.remainder(f32(semis_np) - t[..., None, None], 12.0)  # [..., K, H]
    scale = f32(hw_np) * f32(ok_np)
    out = torch.zeros(pc.shape[:-2] + (hi_bin, 12), dtype=torch.float32, device=dev)
    for cls, wt in _soft_class_weights(pc, sigma):
        out.scatter_add_(-1, cls, wt * scale)
    return out


def frames_to_hpcp(spec, sample_rate: int, fft_size: int, sigma: float, tuning_offset,
                   peaks_per_frame: int, num_harmonics: int, harmonic_decay: float,
                   mag_power: float, enable_whitening: bool = False,
                   whitening_smooth_bins: int = 31, fmin_hz: float = CHROMA_FMIN_HZ,
                   fmax_hz: float = CHROMA_FMAX_HZ, approx_peaks: bool = True):
    """HPCP [..., 12] from magnitudes [..., K] (frame_to_hpcp_tuned_band,
    extractor.rs:528-680). ``tuning_offset`` is a float or a per-track tensor
    ``[B]`` (it only shifts semitone positions). ``approx_peaks`` selects the
    top-K peak set by a threshold found by bisection instead of a sort: the
    harmonic summation does not depend on the order, so only peaks tied with
    the K-th within the bisection's resolution can differ.

    Records a ``key.hpcp`` span around the peak pick and the harmonic
    summation, its attribute ``exact`` True where the sort picked the peaks."""
    n_bins = spec.shape[-1]
    fmin, fmax = max(fmin_hz, 20.0), min(fmax_hz, sample_rate / 2)
    if fmax <= fmin:
        return torch.zeros(spec.shape[:-1] + (12,), dtype=torch.float32, device=spec.device)
    # peaks and their usable harmonics all lie in [fmin, fmax]
    hi_bin = min(int(np.ceil(fmax / (sample_rate / fft_size))) + 2, n_bins)
    k_top = max(min(peaks_per_frame, hi_bin), 1)
    half_w = (hi_bin + 1) // 2
    exact = not (approx_peaks and k_top <= half_w)
    with tracing.span("key.hpcp", exact=exact):
        spec_b = spec[..., :hi_bin]
        sel = spectral_whiten(spec_b, whitening_smooth_bins) if (
            enable_whitening and whitening_smooth_bins >= 3) else spec_b
        p = float(np.clip(mag_power, 0.05, 1.0))
        per_track = torch.is_tensor(tuning_offset)

        if not exact:
            # one launch of csrc/hpcp_bisect.cu on the card
            if per_track:
                m = hpcp_harmonic_matrix_dynamic(sample_rate, fft_size, hi_bin, sigma,
                                                 tuning_offset, num_harmonics, harmonic_decay,
                                                 fmin, fmax)
            else:
                m = hpcp_harmonic_matrix_on(spec.device, sample_rate, fft_size, hi_bin, sigma,
                                            float(tuning_offset), num_harmonics,
                                            harmonic_decay, fmin, fmax)
            band = hpcp.peak_band(n_bins, hi_bin, sample_rate, fft_size, fmin, fmax)
            return hpcp.hpcp_bisect(spec_b, sel, band, k_top, p, m)

        freqs = bin_freqs(sample_rate, fft_size, n_bins)[:hi_bin]
        prev = torch.cat([sel[..., :1], sel[..., :-1]], dim=-1)
        nxt = torch.cat([sel[..., 1:], sel[..., -1:]], dim=-1)
        # interior of the full spectrum: bins 1 .. n_bins - 2
        static_ok = ((np.arange(hi_bin) >= 1) & (np.arange(hi_bin) < n_bins - 1)
                     & (freqs >= fmin) & (freqs <= fmax))
        with tracing.host_read("chroma.peak_band"):
            static_ok = torch.as_tensor(static_ok, device=spec.device)
        peak_ok = static_ok & (sel > prev) & (sel >= nxt)
        peak_vals = torch.where(peak_ok, sel, float("-inf"))
        raw = spec_b.clamp_min(0.0)

        # exact top-k: the larger of each (even, odd) bin pair first (two
        # neighbours are never both peaks; a tie goes to the even bin), then a
        # stable sort of the halved row, ties to the lower bin
        if k_top <= half_w:
            pv = F.pad(peak_vals, (0, hi_bin % 2), value=float("-inf"))
            raw = F.pad(raw, (0, hi_bin % 2))
            ev, od = pv[..., 0::2], pv[..., 1::2]
            take_odd = od > ev
            pv2 = torch.where(take_odd, od, ev)
            id2 = 2 * torch.arange(half_w, device=spec.device) + take_odd.to(torch.int64)
            s_neg, order = torch.sort(-pv2, dim=-1, stable=True)
            top_vals = -s_neg[..., :k_top]
            top_idx = torch.gather(id2, -1, order[..., :k_top])
        else:  # a band narrower than 2 * k_top bins
            top_vals, top_idx = masked.top_k_masked(peak_vals, peak_ok, k_top)
        raw_at_peak = torch.gather(raw, -1, top_idx)
        w0 = torch.where(torch.isfinite(top_vals), torch.pow(raw_at_peak, p), 0.0)

        f0 = top_idx.to(torch.float32) * (sample_rate / fft_size)  # [..., k_top]
        h = torch.arange(1, max(num_harmonics, 1) + 1, dtype=torch.float32, device=spec.device)
        fh = f0[..., None] * h  # [..., k_top, H]
        h_ok = (fh >= fmin) & (fh <= fmax) & (f0[..., None] > 0.0)
        hw = torch.pow(float(np.clip(harmonic_decay, 0.0, 1.0)), h - 1.0) / h
        contrib = w0[..., None].to(torch.float32) * hw * h_ok
        semis = 12.0 * torch.log2(masked.cdiv(fh.clamp_min(1e-6), A4_FREQ)) + SEMITONE_OFFSET
        if per_track:
            # per-track offsets broadcast from the left, never against [k_top, H]
            t = tuning_offset.to(torch.float32)
            tuning_offset = t.reshape(t.shape + (1,) * (semis.dim() - t.dim()))
        pc = torch.remainder(semis - tuning_offset, 12.0)
        out = torch.zeros(spec.shape[:-1] + (12,), dtype=torch.float32, device=spec.device)
        for cls, wt in _soft_class_weights(pc, sigma):
            out.scatter_add_(-1, cls.flatten(-2), (wt * contrib).flatten(-2))
        return l2_normalize_zero(out)


def windowed_time_mean(spec, fvalid, margin: int):
    """Mean over frames [t-margin, t+margin] counting valid frames only
    (smooth_spectrogram_time, extractor.rs:1246-1290); ``spec [B, T, K]``
    with invalid frames zeroed. The box sum is one banded matmul."""
    if margin <= 0:
        return spec
    t = spec.shape[-2]
    idx = torch.arange(t, device=spec.device)
    w = ((idx[:, None] - idx[None, :]).abs() <= margin).to(torch.float32)
    sums = torch.matmul(w, spec)
    cnts = torch.matmul(fvalid.to(torch.float32), w)
    return sums / cnts.clamp_min(1.0)[..., None]


def harmonic_time_mask(spec, fvalid, margin: int, mask_power: float):
    """Soft harmonic mask H = X h^p / (h^p + max(0, X-h)^p + eps)
    (harmonic_spectrogram_time_mask, extractor.rs:1306-1349)."""
    x = spec.to(torch.float32).clamp_min(0.0)
    h = windowed_time_mean(x, fvalid, margin).clamp_min(0.0)
    r = (x - h).clamp_min(0.0)
    p = max(mask_power, 1.0)
    hp, rp = (h * h, r * r) if p == 2.0 else (torch.pow(h, p), torch.pow(r, p))
    return x * (hp / (hp + rp + 1e-12))


def hpss_median_mask_downsampled(band_spec_ds: torch.Tensor, ds_counts: torch.Tensor,
                                 time_margin: int, freq_margin: int,
                                 mask_power: float) -> torch.Tensor:
    """Harmonic soft mask on the downsampled band spectrogram
    (harmonic_spectrogram_hpss_median_mask, extractor.rs:1369-1501):
    select_nth medians (index len/2) across time and across frequency, then
    M = h^p / (h^p + per^p + eps). ``band_spec_ds [B, n_ds, band]``,
    ``ds_counts [B]`` valid downsampled frames."""
    x = band_spec_ds.clamp_min(0.0)
    # the median kernel takes f32; a select-nth median is a selection, so
    # the (bf16) band spectrogram's medians come back exact in its dtype
    xf = x.float()
    h = masked.masked_select_nth_filter_1d(xf, ds_counts, time_margin, dim=1).to(x.dtype)
    per = masked.median_filter_1d_select_nth(xf, freq_margin).to(x.dtype)
    p = max(mask_power, 1.0)
    hp = torch.pow(h.clamp_min(0.0), p)
    pp = torch.pow(per.clamp_min(0.0), p)
    return hp / (hp + pp + 1e-12)


def estimate_tuning_offset(spec: torch.Tensor, fvalid: torch.Tensor, sample_rate: int,
                           fft_size: int, fmin_hz: float, fmax_hz: float, frame_step: int,
                           peak_rel_threshold: float) -> torch.Tensor:
    """Weighted circular mean of semitone residuals (extractor.rs:66-170).
    ``spec [B, T, K]`` (invalid frames zeroed); returns offsets [B] in
    [-0.5, 0.5), 0 where the residuals are not concentrated (r < 0.05)."""
    _, t, n_bins = spec.shape
    dev = spec.device
    freqs = bin_freqs(sample_rate, fft_size, n_bins)
    fmin = max(fmin_hz, 20.0)
    fmax = float(np.clip(fmax_hz, fmin + 1.0, sample_rate / 2))
    in_band = torch.as_tensor((freqs >= fmin) & (freqs <= fmax), device=dev)
    step_mask = torch.as_tensor((np.arange(t) % max(frame_step, 1)) == 0, device=dev)
    use_frame = fvalid & step_mask[None, :]
    x = spec.clamp_min(0.0) * in_band
    peak = x.amax(dim=-1, keepdim=True)
    thr = peak * float(np.clip(peak_rel_threshold, 0.0, 1.0))
    sel = use_frame[..., None] & (x >= thr) & (peak > 1e-12) & in_band
    w = torch.where(sel, torch.sqrt(x), 0.0)
    s_sin, s_cos = tuning_residual_sin_cos(sample_rate, fft_size, n_bins, dev)
    return circular_mean_offset((w * s_sin).sum(dim=(-2, -1)), (w * s_cos).sum(dim=(-2, -1)),
                                w.sum(dim=(-2, -1)))


def tuning_residual_sin_cos(sample_rate: int, fft_size: int, n_bins: int, device):
    """sin and cos ``[n_bins]`` of 2 pi times each bin's residual from its
    nearest semitone (f32 on the device)."""
    with tracing.host_read("tuning.residuals"):
        semis = torch.as_tensor(
            semitones_of_bins(sample_rate, fft_size, n_bins).astype(np.float32), device=device)
    angle = 2.0 * np.pi * (semis - torch.round(semis))
    return torch.sin(angle), torch.cos(angle)


def circular_mean_offset(sum_sin, sum_cos, sum_w) -> torch.Tensor:
    """The offset in semitones of a weighted circular mean from its sums; 0
    where the weight is ~0 or the resultant length is below 0.05."""
    r = torch.sqrt(sum_sin ** 2 + sum_cos ** 2) / sum_w.clamp_min(1e-6)
    delta = masked.cdiv(torch.atan2(sum_sin, sum_cos), 2.0 * np.pi)
    return torch.where((sum_w > 1e-6) & (r >= 0.05), delta, 0.0)


@functools.lru_cache(maxsize=8)
def log_frequency_projection(sample_rate: int, fft_size: int, fmin_hz: float,
                             fmax_hz: float) -> Tuple[np.ndarray, int]:
    """Static ``[K, n_semitone_bins]`` linear -> log-frequency interpolation
    matrix and the semitone index of its first column (extractor.rs:701-807)."""
    n_bins = fft_size // 2 + 1
    nyquist = sample_rate / 2
    fmin = max(fmin_hz, 20.0)
    fmax = min(fmax_hz, nyquist - 1.0)
    s_min = 12.0 * np.log2(fmin / A4_FREQ) + SEMITONE_OFFSET
    s_max = 12.0 * np.log2(fmax / A4_FREQ) + SEMITONE_OFFSET
    bin_min = int(np.floor(s_min))
    bin_max = int(np.ceil(s_max))
    n_out = bin_max - bin_min + 1

    freqs = bin_freqs(sample_rate, fft_size, n_bins)
    w = np.zeros((n_bins, n_out), dtype=np.float32)
    ok = (freqs >= fmin) & (freqs < fmax) & (freqs < nyquist)
    semis = 12.0 * np.log2(np.maximum(freqs, 1e-6) / A4_FREQ) + SEMITONE_OFFSET
    pos = semis - bin_min
    lo = np.floor(pos).astype(np.int64)
    hi = np.minimum(np.ceil(pos).astype(np.int64), n_out - 1)
    w_hi = pos - lo
    for k in range(n_bins):
        if not ok[k] or lo[k] >= n_out or lo[k] < 0:
            continue
        w[k, lo[k]] += 1.0 - w_hi[k]
        if hi[k] != lo[k]:
            w[k, hi[k]] += w_hi[k]
    return w, bin_min


@functools.lru_cache(maxsize=8)
def semitone_fold_matrix(n_semitone_bins: int, semitone_offset: int) -> np.ndarray:
    """``[n_semitone_bins, 12]`` mod-12 fold (extractor.rs:937-981)."""
    w = np.zeros((n_semitone_bins, 12), dtype=np.float32)
    for i in range(n_semitone_bins):
        w[i, (semitone_offset + i) % 12] = 1.0
    return w


def beat_synchronous_chroma(frame_chroma: torch.Tensor, frame_energy: torch.Tensor,
                            fvalid: torch.Tensor, beat_times: torch.Tensor,
                            beat_valid: torch.Tensor, frame_rate: float):
    """Average the per-frame chroma within beat intervals
    (extract_beat_synchronous_chroma, extractor.rs:830-922). Returns (chroma
    [B, NB-1, 12], energy [B, NB-1], interval_valid [B, NB-1]); interval i
    spans beats i .. i+1, and an empty interval has zero chroma."""
    b, t, _ = frame_chroma.shape
    nb = beat_times.shape[-1]
    dev = frame_chroma.device
    frame_time = masked.cdiv(torch.arange(t, dtype=torch.float32, device=dev), frame_rate)
    bt = torch.where(beat_valid, beat_times, float("inf")).contiguous()
    # frames before the first beat fall in no interval
    seg = torch.searchsorted(bt, frame_time.expand(b, t).contiguous(), right=True) - 1
    ok = (seg >= 0) & (seg < nb - 1) & fvalid
    seg = seg.clamp(0, nb - 2)
    okf = ok.to(torch.float32)
    seg_sum = lambda v: torch.zeros((b, nb - 1), device=dev).scatter_add_(1, seg, v)  # noqa: E731
    counts = seg_sum(okf)
    en_sum = seg_sum(frame_energy * okf)
    ch_sum = torch.zeros((b, nb - 1, 12), device=dev).scatter_add_(
        1, seg[..., None].expand(b, t, 12), frame_chroma * okf[..., None])
    avg = ch_sum / counts.clamp_min(1.0)[..., None]
    avg = torch.where(counts[..., None] > 0, l2_normalize_zero(avg), 0.0)
    n_beats = beat_valid.sum(dim=-1)
    interval_valid = torch.arange(nb - 1, device=dev)[None, :] < (n_beats - 1).clamp_min(0)[:, None]
    return avg, en_sum, interval_valid & (counts > 0)
