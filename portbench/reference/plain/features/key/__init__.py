"""Key detection (reference ``src/features/key/``): templates, scoring,
detectors, clarity, key changes, and the streamed key pipeline."""

from .templates import key_templates
from .scoring import key_clarity, best_key_confidence, finalize_scores
from .detector import (
    KeyResult,
    detect_key_weighted,
    detect_key_segment_voting,
    detect_key_multi_scale,
    detect_key_median,
    detect_key_ensemble,
    detect_key_changes,
)
from .pipeline import detect_key_batch, extract_key_features, key_frame_weights
