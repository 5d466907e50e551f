"""Preprocessing: normalization, silence trim, channel mixdown
(reference ``src/preprocessing/``)."""

from .normalization import normalize, calculate_lufs, k_weighting_filter
from .silence import detect_and_trim
from ..ops.framesum import frame_rms
from .channel_mixer import stereo_to_mono, ChannelMixMode
