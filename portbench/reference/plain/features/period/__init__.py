"""Periodicity / BPM estimation (reference ``src/features/period/``):
novelty curves, dual FFT+autocorrelation tempogram, multi-resolution
escalation, and the legacy onset-based ACF+comb path."""

from . import novelty, tempogram, tempogram_fft, tempogram_autocorr
from . import legacy, multi_resolution, peak_picking
