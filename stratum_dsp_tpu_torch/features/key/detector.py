"""Key detection: full-track weighted scores and the orchestrator's
clarity-weighted segment voting (port of the default path of
``stratum_dsp_tpu/features/key/detector.py``; detector.rs, lib.rs:1332-1436).

Per-frame template scores are prefix-summed once over frames, so every
segment's raw scores come from two gathers.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from ...config import AnalysisConfig

from . import scoring
from .templates import key_templates


class KeyResult(NamedTuple):
    """Batched key result."""

    key_idx: torch.Tensor  # [B], 0-11 major / 12-23 minor
    confidence: torch.Tensor  # [B]
    clarity: torch.Tensor  # [B]
    scores: torch.Tensor  # [B, 24]


def _templates(cfg: AnalysisConfig, device):
    return torch.as_tensor(key_templates(cfg.key_template_set), device=device)


def _weighted(chroma, weights, frame_mask):
    w = torch.ones(chroma.shape[:-1], dtype=chroma.dtype, device=chroma.device) \
        if weights is None else weights
    return w * frame_mask


def detect_key_weighted(chroma, weights, frame_mask, cfg: AnalysisConfig) -> KeyResult:
    """Full-track weighted detection (detector.rs:68-300)."""
    w = _weighted(chroma, weights, frame_mask)
    raw = torch.einsum("bfc,kc->bk", chroma * w[..., None], _templates(cfg, chroma.device))
    scores = scoring.finalize_scores(raw)
    key_idx, conf = scoring.best_key_confidence(scores)
    return KeyResult(key_idx, conf, scoring.key_clarity(scores), scores)


def detect_key_segment_voting(chroma, weights, frame_mask, n_frames,
                              cfg: AnalysisConfig) -> KeyResult:
    """Windows of ``key_segment_len_frames`` every ``key_segment_hop_frames``;
    segments with clarity >= the threshold add their score tables weighted by
    clarity; no usable segment -> the full-track result."""
    f = chroma.shape[-2]
    seg_len = min(max(cfg.key_segment_len_frames, 1), f)
    hop = max(min(cfg.key_segment_hop_frames, seg_len), 1)
    min_clarity = float(np.clip(cfg.key_segment_min_clarity, 0.0, 1.0))
    fallback = detect_key_weighted(chroma, weights, frame_mask, cfg)
    if not (cfg.enable_key_segment_voting and cfg.key_segment_len_frames >= 120):
        return fallback

    starts = torch.arange(0, max(f - seg_len, 0) + 1, hop, device=chroma.device)
    w = _weighted(chroma, weights, frame_mask)
    frame_scores = torch.einsum("bfc,kc->bfk", chroma, _templates(cfg, chroma.device))
    p_scores = F.pad(torch.cumsum(w[..., None] * frame_scores, dim=-2), (0, 0, 1, 0))
    raw = p_scores[:, starts + seg_len] - p_scores[:, starts]
    scores = scoring.finalize_scores(raw)
    clarity = scoring.key_clarity(scores)

    seg_valid = (starts[None, :] + seg_len) <= n_frames[:, None]
    use = seg_valid & (clarity >= min_clarity)
    acc = torch.where(use[..., None], scores * clarity[..., None], 0.0).sum(dim=-2)
    used_any = use.any(dim=-1) & (n_frames >= seg_len)
    key_idx, conf = scoring.best_key_confidence(acc)
    return KeyResult(
        key_idx=torch.where(used_any, key_idx, fallback.key_idx),
        confidence=torch.where(used_any, conf, fallback.confidence),
        clarity=torch.where(used_any, scoring.key_clarity(acc), fallback.clarity),
        scores=torch.where(used_any[..., None], acc, fallback.scores),
    )
