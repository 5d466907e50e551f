"""Key detectors: full-track, segment voting, multi-scale, median, ensemble
and the key-change timeline (port of
``stratum_dsp_tpu/features/key/detector.py``; detector.rs, lib.rs:1332-1436).

All segmented variants share one trick: the per-frame template scores
``chroma @ T^T`` (and the weighted chroma, for the mode heuristic) are
prefix-summed once over frames, so every segment's raw scores come from two
gathers.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ... import tracing
from ...config import AnalysisConfig, TemplateSet

from . import scoring
from .templates import key_templates


class KeyResult(NamedTuple):
    """Batched key result."""

    key_idx: torch.Tensor  # [B], 0-11 major / 12-23 minor
    confidence: torch.Tensor  # [B]
    clarity: torch.Tensor  # [B]
    scores: torch.Tensor  # [B, 24]


def _templates(cfg: AnalysisConfig, device, template_set: Optional[TemplateSet] = None):
    with tracing.host_read("key.templates"):
        return torch.as_tensor(key_templates(template_set or cfg.key_template_set),
                               device=device)


def _weighted(chroma, weights, frame_mask):
    w = torch.ones(chroma.shape[:-1], dtype=chroma.dtype, device=chroma.device) \
        if weights is None else weights
    return w * frame_mask


def _uses_heuristic(cfg: AnalysisConfig) -> bool:
    return cfg.enable_key_mode_heuristic or cfg.enable_key_minor_harmonic_bonus


def _mode_heuristic(scores, avg, wsum, cfg: AnalysisConfig):
    return scoring.mode_heuristic(
        scores, avg, wsum, cfg.key_mode_third_ratio_margin,
        cfg.key_mode_flip_min_score_ratio if cfg.enable_key_mode_heuristic else 0.0,
        cfg.enable_key_minor_harmonic_bonus, cfg.key_minor_leading_tone_bonus_weight)


def detect_key_weighted(chroma, weights, frame_mask, cfg: AnalysisConfig,
                        template_set: Optional[TemplateSet] = None) -> KeyResult:
    """Full-track weighted detection (detector.rs:68-300), with the mode
    heuristic / minor bonus where enabled (detector.rs:326-518)."""
    w = _weighted(chroma, weights, frame_mask)
    raw = scoring.raw_scores(chroma, w, _templates(cfg, chroma.device, template_set))
    scores = scoring.finalize_scores(raw)
    if _uses_heuristic(cfg):
        avg = torch.einsum("...f,...fc->...c", w, chroma)
        key_idx, conf, scores = _mode_heuristic(scores, avg, w.sum(dim=-1), cfg)
    else:
        key_idx, conf = scoring.best_key_confidence(scores)
    return KeyResult(key_idx, conf, scoring.key_clarity(scores), scores)


class SegmentPrefixes:
    """Prefix sums over frames that give every segment's sums in O(1)."""

    def __init__(self, chroma, weights, frame_mask, templates):
        w = _weighted(chroma, weights, frame_mask)
        frame_scores = torch.einsum("...fc,kc->...fk", chroma, templates)
        self.p_scores = F.pad(torch.cumsum(w[..., None] * frame_scores, dim=-2), (0, 0, 1, 0))
        self.p_chroma = F.pad(torch.cumsum(w[..., None] * chroma, dim=-2), (0, 0, 1, 0))
        self.p_w = F.pad(torch.cumsum(w, dim=-1), (1, 0))

    def segment(self, starts: torch.Tensor, seg_len: int):
        """(raw scores [B, S, 24], weighted chroma sums [B, S, 12], weight
        sums [B, S]) of the segments at ``starts [S]``."""
        ends = starts + seg_len
        return (self.p_scores[..., ends, :] - self.p_scores[..., starts, :],
                self.p_chroma[..., ends, :] - self.p_chroma[..., starts, :],
                self.p_w[..., ends] - self.p_w[..., starts])


def _segments(chroma, weights, frame_mask, n_frames, cfg: AnalysisConfig, seg_len: int,
              hop: int, pre: Optional[SegmentPrefixes] = None):
    """(raw, avg, wsum, seg_valid [B, S], starts [S]) of the windows of
    ``seg_len`` frames every ``hop``; a window is valid inside the track."""
    f = chroma.shape[-2]
    starts = torch.arange(0, max(f - seg_len, 0) + 1, hop, device=chroma.device)
    if pre is None:
        pre = SegmentPrefixes(chroma, weights, frame_mask, _templates(cfg, chroma.device))
    raw, avg, wsum = pre.segment(starts, seg_len)
    return raw, avg, wsum, (starts[None, :] + seg_len) <= n_frames[:, None], starts


def _segment_results(raw, avg, wsum, cfg: AnalysisConfig):
    """Per-segment final scores (with the heuristic's bonus) and clarity."""
    scores = scoring.finalize_scores(raw)
    if _uses_heuristic(cfg):
        _, _, scores = _mode_heuristic(scores, avg, wsum, cfg)
    return scores, scoring.key_clarity(scores)


def _accumulated_result(acc_scores, used_any, fallback: KeyResult) -> KeyResult:
    key_idx, conf = scoring.best_key_confidence(acc_scores)
    return KeyResult(
        key_idx=torch.where(used_any, key_idx, fallback.key_idx),
        confidence=torch.where(used_any, conf, fallback.confidence),
        clarity=torch.where(used_any, scoring.key_clarity(acc_scores), fallback.clarity),
        scores=torch.where(used_any[..., None], acc_scores, fallback.scores),
    )


def detect_key_segment_voting(chroma, weights, frame_mask, n_frames,
                              cfg: AnalysisConfig) -> KeyResult:
    """Windows of ``key_segment_len_frames`` every ``key_segment_hop_frames``
    (lib.rs:1337-1436); segments with clarity >= the threshold add their score
    tables weighted by clarity; no usable segment -> the full-track result."""
    f = chroma.shape[-2]
    seg_len = min(max(cfg.key_segment_len_frames, 1), f)
    hop = max(min(cfg.key_segment_hop_frames, seg_len), 1)
    min_clarity = float(np.clip(cfg.key_segment_min_clarity, 0.0, 1.0))
    fallback = detect_key_weighted(chroma, weights, frame_mask, cfg)
    if not (cfg.enable_key_segment_voting and cfg.key_segment_len_frames >= 120):
        return fallback

    raw, avg, wsum, seg_valid, _ = _segments(chroma, weights, frame_mask, n_frames, cfg,
                                             seg_len, hop)
    scores, clarity = _segment_results(raw, avg, wsum, cfg)
    use = seg_valid & (clarity >= min_clarity)
    acc = torch.where(use[..., None], scores * clarity[..., None], 0.0).sum(dim=-2)
    return _accumulated_result(acc, use.any(dim=-1) & (n_frames >= seg_len), fallback)


def detect_key_multi_scale(chroma, weights, frame_mask, n_frames,
                           cfg: AnalysisConfig) -> KeyResult:
    """Voting over several window lengths, each vote weighted by clarity x
    scale weight (detector.rs:546-700); the accumulated scores are divided by
    the total weight before ranking."""
    f = chroma.shape[-2]
    hop = max(cfg.key_multi_scale_hop, 1)
    min_clarity = float(np.clip(cfg.key_multi_scale_min_clarity, 0.0, 1.0))
    scale_weights = cfg.key_multi_scale_weights or tuple(1.0 for _ in cfg.key_multi_scale_lengths)
    pre = SegmentPrefixes(chroma, weights, frame_mask, _templates(cfg, chroma.device))
    fallback = detect_key_weighted(chroma, weights, frame_mask, cfg)

    acc = torch.zeros(chroma.shape[:-2] + (24,), dtype=torch.float32, device=chroma.device)
    total_w = acc[..., 0].clone()
    used_any = torch.zeros_like(total_w, dtype=torch.bool)
    for scale_idx, seg_len in enumerate(cfg.key_multi_scale_lengths):
        sw = scale_weights[scale_idx] if scale_idx < len(scale_weights) else 1.0
        if seg_len <= 0 or seg_len > f or sw <= 0.0:
            continue
        raw, avg, wsum, seg_valid, _ = _segments(chroma, weights, frame_mask, n_frames, cfg,
                                                 seg_len, hop, pre)
        scores, clarity = _segment_results(raw, avg, wsum, cfg)
        use = seg_valid & (clarity >= min_clarity)
        cw = clarity * sw
        acc = acc + torch.where(use[..., None], scores * cw[..., None], 0.0).sum(dim=-2)
        total_w = total_w + torch.where(use, cw, 0.0).sum(dim=-1)
        used_any = used_any | use.any(dim=-1)
    acc = acc / total_w.clamp_min(1e-12)[..., None]
    return _accumulated_result(acc, used_any & (total_w > 1e-12), fallback)


def _first_argmax(x: torch.Tensor) -> torch.Tensor:
    """argmax over the last axis, the first index on exact ties."""
    return (x == x.amax(dim=-1, keepdim=True)).to(torch.uint8).argmax(dim=-1)


def _most_frequent_key(key_idx, conf, seg_valid):
    """The key most segments chose, the summed confidence breaking ties
    (count + conf / large, then the first index)."""
    onehot = F.one_hot(key_idx, 24).to(torch.float32) * seg_valid[..., None]
    counts = onehot.sum(dim=-2)
    conf_sums = (onehot * conf[..., None]).sum(dim=-2)
    return _first_argmax(counts + conf_sums / (1.0 + conf_sums.sum(dim=-1, keepdim=True)))


def detect_key_median(chroma, weights, frame_mask, n_frames, cfg: AnalysisConfig) -> KeyResult:
    """Median-key segmentation (detector.rs:721-863): the most frequent
    per-segment key wins; its confidence comes from the confidence-weighted
    aggregate score table."""
    f = chroma.shape[-2]
    seg_len = max(min(cfg.key_median_segment_length_frames, f), 120)
    hop = max(cfg.key_median_segment_hop_frames, 1)
    fallback = detect_key_weighted(chroma, weights, frame_mask, cfg)
    if seg_len > f:
        return fallback

    raw, _, _, seg_valid, _ = _segments(chroma, weights, frame_mask, n_frames, cfg, seg_len, hop)
    scores = scoring.finalize_scores(raw)
    key_idx, conf = scoring.best_key_confidence(scores)
    median_key = _most_frequent_key(key_idx, conf, seg_valid)

    agg_num = torch.where(seg_valid[..., None], scores * conf[..., None], 0.0).sum(dim=-2)
    agg_den = torch.where(seg_valid, conf, 0.0).sum(dim=-1)
    agg = agg_num / agg_den.clamp_min(1e-12)[..., None]
    enough = seg_valid.sum(dim=-1) >= max(cfg.key_median_min_segments, 1)
    return KeyResult(
        key_idx=torch.where(enough, median_key, fallback.key_idx),
        confidence=torch.where(enough, scoring.confidence_for_key(agg, median_key),
                               fallback.confidence),
        clarity=torch.where(enough, scoring.key_clarity(agg), fallback.clarity),
        scores=torch.where(enough[..., None], agg, fallback.scores),
    )


def detect_key_ensemble(chroma, weights, frame_mask, cfg: AnalysisConfig) -> KeyResult:
    """Krumhansl-Kessler + Temperley weighted score blend (detector.rs:881-976)."""
    total = cfg.key_ensemble_kk_weight + cfg.key_ensemble_temperley_weight
    kk_w = cfg.key_ensemble_kk_weight / total if total > 1e-9 else 0.5
    tp_w = cfg.key_ensemble_temperley_weight / total if total > 1e-9 else 0.5
    kk = detect_key_weighted(chroma, weights, frame_mask, cfg, TemplateSet.KRUMHANSL_KESSLER)
    tp = detect_key_weighted(chroma, weights, frame_mask, cfg, TemplateSet.TEMPERLEY)
    combined = kk_w * kk.scores + tp_w * tp.scores
    key_idx, conf = scoring.best_key_confidence(combined)
    return KeyResult(key_idx, conf, scoring.key_clarity(combined), combined)


def detect_key_changes(chroma, weights, frame_mask, n_frames, cfg: AnalysisConfig,
                       frame_rate: float, segment_duration_s: float = 8.0,
                       segment_overlap_s: float = 2.0):
    """Segment-wise key timeline (key_changes.rs:70-140): (timestamps [S],
    key_idx [B, S], confidence [B, S], seg_valid [B, S], primary_key [B])."""
    f = chroma.shape[-2]
    seg_frames = max(int(segment_duration_s * frame_rate), 1)
    hop_frames = max(seg_frames - int(segment_overlap_s * frame_rate), 1)
    seg_frames = min(seg_frames, f)
    raw, _, _, seg_valid, starts = _segments(chroma, weights, frame_mask, n_frames, cfg,
                                             seg_frames, hop_frames)
    key_idx, conf = scoring.best_key_confidence(scoring.finalize_scores(raw))
    timestamps = starts.to(torch.float32) / frame_rate
    return timestamps, key_idx, conf, seg_valid, _most_frequent_key(key_idx, conf, seg_valid)
