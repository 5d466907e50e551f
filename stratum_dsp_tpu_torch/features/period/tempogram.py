"""Tempogram BPM estimator: dual-method fusion + metrical-level selection
(port of ``stratum_dsp_tpu/features/period/tempogram.py``,
tempogram.rs:255-775).

Seeds from each novelty variant's FFT peaks and autocorrelation top entries
are folded by the metrical factors, deduplicated within 0.75 BPM, scored
0.55 * autocorr + 0.45 * fft with a multi-band consensus bonus and range
priors, then the >180 BPM winner is folded down unless both methods prefer
it strongly. Ties break to the lowest index (stable sorts), as ``lax.top_k``
and JAX's sorts do.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

import numpy as np
import torch

from ... import tracing
from ...config import AnalysisConfig

from ...ops import masked
from . import tempogram_autocorr as tac
from . import tempogram_fft as tft

FOLD_FACTORS = (1.0, 0.5, 2.0, 1.0 / 3.0, 3.0, 2.0 / 3.0, 1.5)
PREFERRED_MIN = 60.0
PREFERRED_MAX = 180.0
SEEDS_PER_METHOD = 8
DEDUP_TOL = 0.75


@dataclass
class TempogramVariant:
    """One novelty representation's pair of tempograms."""

    name: str
    weight: float
    fft_power: torch.Tensor  # [B, NB]
    fft_bpms: np.ndarray  # [NB]
    ac_strength: torch.Tensor  # [B, n_bpm]
    ac_grid: np.ndarray  # [n_bpm]
    max_fft: torch.Tensor  # [B]
    max_ac: torch.Tensor  # [B]


def compute_variants(curves: Dict[str, torch.Tensor], nov_mask, n_valid, frame_rate: float,
                     cfg: AnalysisConfig, fft_size: int) -> List[TempogramVariant]:
    """Both tempograms for every novelty variant present in ``curves``."""
    weights = {
        "full": cfg.tempogram_band_w_full if cfg.enable_tempogram_band_fusion else 1.0,
        "low": cfg.tempogram_band_w_low,
        "mid": cfg.tempogram_band_w_mid,
        "high": cfg.tempogram_band_w_high,
        "mel": cfg.tempogram_mel_weight,
    }
    variants = []
    for name in ("full", "low", "mid", "high", "mel"):
        if name not in curves:
            continue
        w = weights[name]
        if name != "full" and not (np.isfinite(w) and w > 0.0):
            continue
        nov = curves[name]
        power, bpms = tft.fft_tempogram_power(nov, nov_mask, n_valid, frame_rate, cfg.min_bpm,
                                              cfg.max_bpm, fft_size)
        strength, grid = tac.autocorr_tempogram(nov, nov_mask, n_valid, frame_rate, cfg.min_bpm,
                                                cfg.max_bpm, cfg.bpm_resolution)
        variants.append(TempogramVariant(
            name=name, weight=w, fft_power=power, fft_bpms=bpms, ac_strength=strength,
            ac_grid=grid, max_fft=power.amax(dim=-1).clamp_min(1e-12),
            max_ac=strength.amax(dim=-1).clamp_min(1e-12)))
    return variants


def _top_k_indices(x: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest entries, ties to the lowest index (lax.top_k)."""
    return torch.sort(x, dim=-1, descending=True, stable=True).indices[..., :k]


def estimate_bpm_tempogram(variants: List[TempogramVariant], cfg: AnalysisConfig,
                           frame_rate: float, fft_size: int, top_n: int) -> Dict[str, torch.Tensor]:
    """Score candidates and select the BPM: bpm/confidence/method_agreement
    [B] and the score-ordered candidates cand_bpm/cand_score/cand_fft/
    cand_ac/cand_valid/cand_selected [B, top_n] (the ambiguity gate and the
    escalation read them; the candidate diagnostics print them)."""
    full = variants[0]
    assert full.name == "full"
    b = full.fft_power.shape[0]
    dev = full.fft_power.device
    min_bpm, max_bpm = cfg.min_bpm, cfg.max_bpm
    use_aux = (cfg.enable_tempogram_band_fusion or cfg.enable_tempogram_mel_novelty
               or cfg.tempogram_band_consensus_bonus > 0.0)
    score_variants = [full] if (cfg.tempogram_band_seed_only or not use_aux) else variants

    def as_t(a):
        with tracing.host_read("tempogram.tables"):
            return torch.as_tensor(a, device=dev)

    fft_primary_bpm = as_t(full.fft_bpms)[full.fft_power.argmax(dim=-1)]
    ac_primary_bpm = as_t(full.ac_grid)[full.ac_strength.argmax(dim=-1)]

    # seeds: FFT local maxima and autocorr top entries of every variant
    seeds = []
    for v in variants:
        p = v.fft_power
        left = torch.cat([p[:, :1], p[:, :-1]], dim=-1)
        right = torch.cat([p[:, 1:], p[:, -1:]], dim=-1)
        peaks = torch.where((p >= left) & (p >= right), p, 0.0)
        seeds.append(as_t(v.fft_bpms)[_top_k_indices(peaks, min(SEEDS_PER_METHOD, p.shape[-1]))])
        s = v.ac_strength
        seeds.append(as_t(v.ac_grid)[_top_k_indices(s, min(SEEDS_PER_METHOD, s.shape[-1]))])
    seeds += [fft_primary_bpm[:, None], ac_primary_bpm[:, None]]
    seed_bpms = torch.cat(seeds, dim=-1)

    cands = (seed_bpms[:, :, None] * as_t(np.asarray(FOLD_FACTORS, np.float32))).reshape(b, -1)
    cvalid = (cands >= min_bpm) & (cands <= max_bpm) & torch.isfinite(cands)
    order = torch.sort(torch.where(cvalid, cands, float("inf")), dim=-1, stable=True).indices
    cands = torch.gather(cands, 1, order)
    cvalid = torch.gather(cvalid, 1, order)
    cvalid = cvalid & masked.greedy_dedup_sorted(cands, cvalid, DEDUP_TOL)

    w_sum = max(sum(max(v.weight, 0.0) for v in score_variants), 1e-6)
    fft_acc = torch.zeros_like(cands)
    ac_acc = torch.zeros_like(cands)
    ac_tol = max(cfg.bpm_resolution, 0.5)
    for v in score_variants:
        if v.weight <= 0.0:
            continue
        fv = tft.fft_lookup_nearest(v.fft_power, v.fft_bpms, cands, DEDUP_TOL, frame_rate, fft_size)
        av = tac.ac_lookup_nearest(v.ac_strength, v.ac_grid, cands, ac_tol)
        fft_acc = fft_acc + v.weight * (fv / v.max_fft[:, None]).clamp(0.0, 1.0)
        ac_acc = ac_acc + v.weight * (av / v.max_ac[:, None]).clamp(0.0, 1.0)
    fft_norm = masked.cdiv(fft_acc, w_sum).clamp(0.0, 1.0)
    ac_norm = masked.cdiv(ac_acc, w_sum).clamp(0.0, 1.0)
    score = 0.55 * ac_norm + 0.45 * fft_norm

    bonus = max(cfg.tempogram_band_consensus_bonus, 0.0)
    if bonus > 0.0 and (cfg.enable_tempogram_band_fusion or cfg.enable_tempogram_mel_novelty):
        support_threshold = float(np.clip(cfg.tempogram_band_support_threshold, 0.0, 1.0))
        support = torch.zeros_like(cands, dtype=torch.int64)
        for v in variants:
            if v.name == "full":
                continue
            sf = (tft.fft_lookup_nearest(v.fft_power, v.fft_bpms, cands, DEDUP_TOL, frame_rate,
                                         fft_size) / v.max_fft[:, None]).clamp(0.0, 1.0)
            sa = (tac.ac_lookup_nearest(v.ac_strength, v.ac_grid, cands, ac_tol)
                  / v.max_ac[:, None]).clamp(0.0, 1.0)
            support = support + (torch.maximum(sf, sa) >= support_threshold)
        score = score * torch.where(support >= 2, 1.0 + bonus * (support.float() - 1.0), 1.0)

    score = torch.where(cands > PREFERRED_MAX, score * 0.80, score)
    score = torch.where(cands < PREFERRED_MIN, score * 0.90, score)

    srt = torch.sort(-torch.where(cvalid, score, float("-inf")), dim=-1, stable=True).indices
    take = lambda arr, idx: torch.gather(arr, 1, idx[:, None])[:, 0]  # noqa: E731
    best_idx, second_idx = srt[:, 0], srt[:, 1]
    best_bpm, best_score = take(cands, best_idx), take(score, best_idx)
    best_fft, best_ac = take(fft_norm, best_idx), take(ac_norm, best_idx)
    second_score = torch.where(take(cvalid, second_idx), take(score, second_idx), 0.0)

    # tempo-octave fold-down gate (tempogram.rs:669-699)
    folded = best_bpm / 2.0
    within = cvalid & ((cands - folded[:, None]).abs() < DEDUP_TOL)
    fold_idx = torch.where(within, score, float("-inf")).argmax(dim=-1)
    f_bpm, f_score = take(cands, fold_idx), take(score, fold_idx)
    f_fft, f_ac = take(fft_norm, fold_idx), take(ac_norm, fold_idx)
    eps = 1e-6
    ac_ratio = (best_ac + eps) / (f_ac + eps)
    fft_ratio = (best_fft + eps) / (f_fft + eps)
    do_fold = ((best_bpm > PREFERRED_MAX) & (folded >= min_bpm) & (folded <= max_bpm)
               & within.any(dim=-1) & ~((ac_ratio > 2.0) & (fft_ratio > 2.0)))
    final_bpm = torch.where(do_fold, f_bpm, best_bpm)
    final_score = torch.where(do_fold, f_score, best_score)

    confidence = torch.where(
        final_score > 1e-12,
        ((final_score - second_score) / final_score.clamp_min(1e-12)).clamp(0.0, 1.0), 0.0)
    agreement = (((fft_primary_bpm > 0.0) & ((fft_primary_bpm - final_bpm).abs() < 2.0)).long()
                 + ((ac_primary_bpm > 0.0) & ((ac_primary_bpm - final_bpm).abs() < 2.0)).long())

    top = srt[:, :min(top_n, cands.shape[-1])]
    cand_bpm, cand_valid = torch.gather(cands, 1, top), torch.gather(cvalid, 1, top)
    return {
        "bpm": final_bpm,
        "confidence": confidence,
        "method_agreement": agreement,
        "cand_bpm": cand_bpm,
        "cand_score": torch.gather(score, 1, top),
        "cand_fft": torch.gather(fft_norm, 1, top),
        "cand_ac": torch.gather(ac_norm, 1, top),
        "cand_valid": cand_valid,
        "cand_selected": cand_valid & ((cand_bpm - final_bpm[:, None]).abs() < DEDUP_TOL),
    }


def cand_lookup_nearest(cand_bpm, cand_score, cand_valid, query, tol: float):
    """Score of the candidate nearest to each query within ``tol``, else 0
    (multi_resolution.rs:282-293). ``cand_* [B, S]``, ``query [B, ...]``;
    the result has the query's shape. Ties go to the first candidate."""
    q = query.reshape(query.shape[0], -1, 1)  # [B, Q, 1]
    d = torch.where(cand_valid[:, None, :], (cand_bpm[:, None, :] - q).abs(), float("inf"))
    nearest = d.argmin(dim=-1, keepdim=True)  # [B, Q, 1]
    dmin = torch.gather(d, 2, nearest)[..., 0]
    vals = torch.gather(cand_score[:, None, :].expand(d.shape), 2, nearest)[..., 0]
    return torch.where(dmin <= tol, vals, 0.0).reshape(query.shape)
