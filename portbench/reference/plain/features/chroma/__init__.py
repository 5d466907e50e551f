"""Chroma / HPCP extraction and key-path spectrogram conditioning
(reference ``src/features/chroma/``)."""

from .extractor import (
    chroma_projection_matrix,
    frames_to_chroma,
    frames_to_hpcp,
    harmonic_time_mask,
    estimate_tuning_offset,
    log_frequency_projection,
    beat_synchronous_chroma,
)
from .postprocess import sharpen_chroma, l2_normalize_chroma, smooth_chroma_median
