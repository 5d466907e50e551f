"""Key templates (port of ``stratum_dsp_tpu/features/key/templates.py``,
templates.rs:64-223): Krumhansl-Kessler (1982) and Temperley (1999) profiles
rotated to all 12 tonics and L2-normalized; rows 0-11 major C..B, 12-23
minor C..B."""

from __future__ import annotations

import numpy as np

from ...config import TemplateSet

KK_MAJOR = (6.35, 2.23, 3.48, 2.33, 4.38, 4.09, 2.52, 5.19, 2.39, 3.66, 2.29, 2.88)
KK_MINOR = (6.33, 2.68, 3.52, 5.38, 2.60, 3.53, 2.54, 4.75, 3.98, 2.69, 3.34, 3.17)
TEMPERLEY_MAJOR = (5.0, 2.0, 3.5, 2.0, 4.5, 4.0, 2.0, 4.5, 2.0, 3.5, 1.5, 4.0)
TEMPERLEY_MINOR = (5.0, 2.0, 3.5, 5.0, 2.0, 3.5, 2.0, 4.5, 3.5, 2.0, 4.0, 3.5)


def _rotate_and_normalize(c_major, c_minor) -> np.ndarray:
    out = np.zeros((24, 12), dtype=np.float32)
    for key in range(12):
        idx = (np.arange(12) + 12 - key) % 12
        out[key] = np.asarray(c_major, dtype=np.float64)[idx]
        out[12 + key] = np.asarray(c_minor, dtype=np.float64)[idx]
    norms = np.linalg.norm(out, axis=1, keepdims=True)
    return (out / np.maximum(norms, 1e-12)).astype(np.float32)


def key_templates(template_set: TemplateSet = TemplateSet.KRUMHANSL_KESSLER) -> np.ndarray:
    """The [24, 12] template matrix for the given set."""
    if template_set == TemplateSet.KRUMHANSL_KESSLER:
        return _rotate_and_normalize(KK_MAJOR, KK_MINOR)
    if template_set == TemplateSet.TEMPERLEY:
        return _rotate_and_normalize(TEMPERLEY_MAJOR, TEMPERLEY_MINOR)
    raise ValueError(f"unknown template set {template_set}")
