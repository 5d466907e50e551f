"""Key-scoring math (port of ``stratum_dsp_tpu/features/key/scoring.py``;
key/detector.rs): weighted sum-of-dots raw scores, per-mode max
normalization, circle-of-fifths bonus, tie-stable best key + confidence,
clarity, and the mode heuristic (3rd/6th/7th-degree discrimination with a
gated parallel-mode flip and an optional minor leading-tone bonus,
detector.rs:326-518). Score layout ``[..., 24]``: major C..B then minor
C..B."""

from __future__ import annotations

import numpy as np
import torch

from ...ops import tables

EPSILON = 1e-9
CIRCLE_OF_FIFTHS = (0, 7, 2, 9, 4, 11, 6, 1, 8, 3, 10, 5)
CIRCLE_BONUS_WEIGHT = 0.20
# Scores within TIE_EPS of the max count as tied and the first index wins:
# the per-mode normalization + self-bonus makes the best major and minor keys
# tie at exactly 1.2, so the mode rides on this tie-break (detector.rs:244).
TIE_EPS = 1e-4


def stable_argmax(scores, eps: float = TIE_EPS):
    """First index whose score is within ``eps`` of the max."""
    mx = scores.amax(dim=-1, keepdim=True)
    return (scores >= mx - eps).to(torch.uint8).argmax(dim=-1)


def cof_bonus_matrix() -> np.ndarray:
    """[12, 12] bonus factor 0.20*(1 - dist/2) for circle-of-fifths distance <= 2."""
    pos = np.zeros(12, dtype=np.int64)
    for p, tonic in enumerate(CIRCLE_OF_FIFTHS):
        pos[tonic] = p
    d = np.abs(pos[:, None] - pos[None, :])
    d = np.minimum(d, 12 - d)
    return np.where(d <= 2, CIRCLE_BONUS_WEIGHT * (1.0 - d * 0.5), 0.0).astype(np.float32)


def raw_scores(chroma, weights, templates):
    """Weighted sum-of-dots scores [..., 24] from chroma [..., F, 12]."""
    if weights is not None:
        chroma = chroma * weights[..., None]
    return torch.einsum("...fc,kc->...k", chroma, templates)


def finalize_scores(scores):
    """Per-mode max normalization + circle-of-fifths bonus."""
    major, minor = scores[..., :12], scores[..., 12:]
    max_major = major.amax(dim=-1, keepdim=True)
    max_minor = minor.amax(dim=-1, keepdim=True)
    do_norm = (max_major > EPSILON) & (max_minor > EPSILON)
    major = torch.where(do_norm, major / max_major.clamp_min(EPSILON), major)
    minor = torch.where(do_norm, minor / max_minor.clamp_min(EPSILON), minor)
    bonus = tables.on(scores.device, cof_bonus_matrix, site="key.fifths_bonus")
    top_major = major.amax(dim=-1, keepdim=True)
    top_minor = minor.amax(dim=-1, keepdim=True)
    major = major + torch.where(top_major > EPSILON, top_major * bonus[stable_argmax(major)], 0.0)
    minor = minor + torch.where(top_minor > EPSILON, top_minor * bonus[stable_argmax(minor)], 0.0)
    return torch.cat([major, minor], dim=-1)


def confidence_for_key(scores, key_idx):
    """(score[key] - best other) / score[key] (detector.rs:493-508)."""
    chosen = torch.gather(scores, -1, key_idx[..., None])[..., 0]
    other = scores.scatter(-1, key_idx[..., None], float("-inf")).amax(dim=-1)
    return torch.where(chosen > 0.0,
                       ((chosen - other) / chosen.clamp_min(EPSILON)).clamp(0.0, 1.0), 0.0)


def best_key_confidence(scores):
    """(key_idx, confidence = (best - second)/best), first index on ties."""
    key_idx = stable_argmax(scores)
    return key_idx, confidence_for_key(scores, key_idx)


def key_clarity(scores):
    """(best - mean) / (max - min), clamped (key_clarity.rs:51-93)."""
    best = scores.amax(dim=-1)
    rng = best - scores.amin(dim=-1)
    return torch.where(rng > 1e-10,
                       ((best - scores.mean(dim=-1)) / rng.clamp_min(1e-10)).clamp(0.0, 1.0), 0.0)


def mode_heuristic(scores, avg_chroma, wsum, third_ratio_margin: float,
                   flip_min_score_ratio: float, enable_minor_harmonic_bonus: bool,
                   minor_leading_tone_bonus_weight: float):
    """The minor bonus and the mode flip (detector.rs:326-518).
    ``avg_chroma [..., 12]`` is the weighted chroma sum (normalized here),
    ``wsum`` its weight sum. Returns (key_idx, confidence, scores')."""
    flip_ratio = float(np.clip(flip_min_score_ratio, 0.0, 1.0))
    s = avg_chroma.sum(dim=-1, keepdim=True)
    avg = torch.where(s > EPSILON, avg_chroma / s.clamp_min(EPSILON), avg_chroma)
    heur_ok = wsum > EPSILON

    if enable_minor_harmonic_bonus and minor_leading_tone_bonus_weight > 0.0:
        w = float(max(minor_leading_tone_bonus_weight, 0.0))
        tonics = torch.arange(12, device=scores.device)
        bonus = wsum[..., None] * w * (avg[..., (tonics + 11) % 12] - avg[..., (tonics + 10) % 12])
        minor = scores[..., 12:] + torch.where(heur_ok[..., None], bonus, 0.0)
        scores = torch.cat([scores[..., :12], minor], dim=-1)

    best_idx = stable_argmax(scores)
    tonic = best_idx % 12
    best_is_major = best_idx < 12
    deg = lambda off: torch.gather(avg, -1, ((tonic + off) % 12)[..., None])[..., 0]  # noqa: E731
    margin = float(max(third_ratio_margin, 0.0))

    def pair(lo, hi, w):
        d = (lo - hi).abs()
        return (torch.where(lo > hi * (1.0 + margin), d * w, 0.0),
                torch.where(hi > lo * (1.0 + margin), d * w, 0.0))

    m3, M3 = pair(deg(3), deg(4), 2.0)
    m6, M6 = pair(deg(8), deg(9), 1.0)
    m7, M7 = pair(deg(10), deg(11), 1.0)
    minor_score = m3 + m6 + m7
    major_score = M3 + M6 + M7
    decided = (minor_score + major_score) > EPSILON
    minor_pref = decided & (minor_score > major_score * (1.0 + margin * 0.5))
    major_pref = decided & (major_score > minor_score * (1.0 + margin * 0.5))

    maj_s = torch.gather(scores, -1, tonic[..., None])[..., 0]
    min_s = torch.gather(scores, -1, (tonic + 12)[..., None])[..., 0]
    flip_ok = heur_ok if flip_ratio > 0.0 else torch.zeros_like(heur_ok)
    flip_to_minor = (flip_ok & best_is_major & minor_pref & (maj_s > 0.0)
                     & (min_s >= maj_s * flip_ratio))
    flip_to_major = (flip_ok & ~best_is_major & major_pref & (min_s > 0.0)
                     & (maj_s >= min_s * flip_ratio))
    chosen = torch.where(flip_to_minor, tonic + 12, torch.where(flip_to_major, tonic, best_idx))
    return chosen, confidence_for_key(scores, chosen), scores
