"""Spectral-flux and HFC onsets from the streamed per-frame curves (port of
``stratum_dsp_tpu/features/onset/spectral.py``): percentile threshold
(sorted[floor(n*pct)]) + local-max peak pick + frame -> sample conversion."""

from __future__ import annotations

import torch

from ...ops import masked
from .peaks import peak_mask_1d, peaks_to_positions


def flux_onsets_from_curve(flux: torch.Tensor, n_valid: torch.Tensor, threshold_percentile: float,
                           hop: int, lengths: torch.Tensor, max_onsets: int):
    """Onsets from flux [B, N] (flux[i] = transition i -> i+1); returns
    (positions [B, K] samples, valid [B, K])."""
    n = flux.shape[-1]
    fvalid = masked.length_mask(n_valid, n)
    flux = torch.where(fvalid, flux, 0.0)
    thr = masked.masked_percentile_value(flux, fvalid, threshold_percentile)
    thr = torch.where(n_valid > 0, thr, float("inf"))
    peaks = peak_mask_1d(flux, fvalid, thr)
    onset_samples = (torch.arange(n, device=flux.device) + 1) * hop
    peaks = peaks & (onset_samples[None, :] < lengths[:, None])
    pos, valid = peaks_to_positions(peaks, onset_samples, max_onsets)
    return torch.where(valid, pos, 0), valid


def hfc_flux(hfc_values: torch.Tensor, n_frames: torch.Tensor):
    """HWR first difference of per-frame HFC (hfc.rs:148-157); returns
    (flux [B, F-1], n_valid [B])."""
    flux = (hfc_values[:, 1:] - hfc_values[:, :-1]).clamp_min(0.0)
    return flux, (n_frames - 1).clamp_min(0)
