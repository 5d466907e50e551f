"""Onset detection: energy flux, spectral flux, HFC, HPSS, consensus voting,
as fixed-capacity per-track tensors ``(positions [B, K] samples, valid
[B, K] bool)`` sorted by time (reference ``src/features/onset/``)."""

from .peaks import peak_mask_1d, peaks_to_positions
from .energy_flux import detect_energy_flux_onsets
from .spectral import flux_onsets_from_curve
from .consensus import vote_onsets, consensus_onsets
from .hpss import hpss_decompose, percussive_energy_flux
from .threshold import adaptive_threshold_median_mad
