"""Confidence scoring (port of ``stratum_dsp_tpu/analysis/confidence.py``,
analysis/confidence.rs:121-296): overall = 0.4 BPM + 0.3 key + 0.3 grid
when both BPM and key succeeded, single-source 0.6x otherwise."""

from __future__ import annotations

from typing import Dict

import torch


def compute_confidence(bpm, bpm_confidence, key_confidence, key_clarity, grid_stability,
                       bpm_warning, key_warning) -> Dict[str, torch.Tensor]:
    """All inputs [B]; warnings are booleans."""
    bpm_conf = torch.where(bpm > 0.0, bpm_confidence.clamp(0.0, 1.0), 0.0)
    bpm_conf = torch.where(bpm_warning, bpm_conf * 0.7, bpm_conf)
    clarity_adj = torch.where(key_clarity < 0.2, 0.6, torch.where(key_clarity < 0.5, 0.85, 1.0))
    key_conf = torch.where(
        key_confidence > 0.0,
        key_confidence.clamp(0.0, 1.0) * clarity_adj * torch.where(key_warning, 0.7, 1.0), 0.0)
    grid = grid_stability.clamp(0.0, 1.0)
    both = (bpm_conf > 0.0) & (key_conf > 0.0)
    overall = torch.where(
        both, (bpm_conf * 0.4 + key_conf * 0.3 + grid * 0.3).clamp(0.0, 1.0),
        torch.where(bpm_conf > 0.0, bpm_conf * 0.6,
                    torch.where(key_conf > 0.0, key_conf * 0.6, 0.0)))
    return {
        "bpm_confidence": bpm_conf,
        "key_confidence": key_conf,
        "grid_stability": grid,
        "overall_confidence": overall,
        "flag_multimodal_bpm": bpm_conf < 0.3,
        "flag_weak_tonality": key_conf < 0.2,
        "flag_tempo_variation": grid < 0.3,
    }
