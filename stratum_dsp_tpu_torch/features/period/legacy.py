"""Legacy onset-based BPM path: FFT autocorrelation + comb filterbank +
candidate merge with guardrails (port of
``stratum_dsp_tpu/features/period/legacy.py``; period/{mod,autocorrelation,
comb_filter,candidate_filter}.rs). It always runs; its estimate is the
fallback when the tempogram finds nothing."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ...config import AnalysisConfig
from ...ops import tables

from .tempogram_fft import next_pow2

EPSILON = 1e-10
BIG = 1e9
INT_BIG = 2**31 - 1
MAX_PER_METHOD = 10
AC_CAP = 24  # top 10 + re-added reasonable-range autocorr candidates
REASONABLE_MIN, REASONABLE_MAX = 60.0, 180.0
COMB_DEFAULT_TOLERANCE = 0.10
COMB_REFERENCE_BPM = 120.0
COMB_MIN_TOLERANCE = 0.05
COMB_MAX_TOLERANCE = 0.15


class CandidateList(NamedTuple):
    bpm: torch.Tensor  # [B, C]
    confidence: torch.Tensor  # [B, C]
    valid: torch.Tensor  # [B, C]


def comb_bpm_grid(min_bpm: float, max_bpm: float, resolution: float) -> np.ndarray:
    """f32-accumulated grid while bpm <= max + EPS (comb_filter.rs:157)."""
    grid = []
    bpm = np.float32(min_bpm)
    while bpm <= np.float32(max_bpm) + np.float32(EPSILON):
        grid.append(float(bpm))
        bpm = np.float32(bpm + np.float32(resolution))
    return np.asarray(grid, dtype=np.float32)


def comb_tables(sample_rate: int, min_bpm: float, max_bpm: float, resolution: float):
    """The comb grid's periods in samples, their tolerances and the grid."""
    grid = comb_bpm_grid(min_bpm, max_bpm, resolution)
    period = 60.0 * sample_rate / grid
    tol = np.clip(COMB_DEFAULT_TOLERANCE * (COMB_REFERENCE_BPM / grid), COMB_MIN_TOLERANCE,
                  COMB_MAX_TOLERANCE) * period
    return period, tol, grid


def autocorr_lag_tables(lag_min: int, lag_max: int, sample_rate: int, hop: int, min_bpm: float,
                        max_bpm: float):
    """For the lags ``[lag_min, lag_max]``: where a peak may lie (not the
    run's ends, in the BPM range) and each lag's BPM."""
    lags = np.arange(lag_min, lag_max + 1, dtype=np.float32)
    bpm = (60.0 * sample_rate) / (lags * hop)
    n = len(lags)
    ok = (np.arange(n) >= 1) & (np.arange(n) < n - 1) & (bpm >= min_bpm) & (bpm <= max_bpm)
    return ok, bpm


def _sort_by_confidence(bpm, conf, valid) -> CandidateList:
    order = torch.sort(torch.where(valid, -conf, float("inf")), dim=-1, stable=True).indices
    return CandidateList(torch.gather(bpm.expand_as(conf), 1, order),
                         torch.gather(conf, 1, order), torch.gather(valid, 1, order))


def autocorr_candidates(onset_pos, onset_valid, t_padded: int, sample_rate: int, hop: int,
                        min_bpm: float, max_bpm: float) -> CandidateList:
    """FFT-ACF candidates of the binary onset-frame signal
    (autocorrelation.rs:99-268): local maxima with prominence >= 10% of the
    in-range max, confidence = value / max(ACF)."""
    b = onset_pos.shape[0]
    dev = onset_pos.device
    nf = t_padded // hop + 1
    frames = (onset_pos // hop).clamp(0, nf - 1)
    signal = torch.zeros((b, nf), device=dev).scatter_reduce(
        1, frames, onset_valid.to(torch.float32), reduce="amax")
    fft_size = next_pow2(2 * nf)
    spec = torch.fft.rfft(signal, n=fft_size, dim=-1)
    power = spec.real * spec.real + spec.imag * spec.imag
    acf = torch.fft.irfft(power, n=fft_size, dim=-1)[:, :nf].clamp_min(0.0)

    lag_min = int(np.ceil(60.0 * sample_rate / (max_bpm * hop)))
    lag_max = min(int(np.floor(60.0 * sample_rate / (min_bpm * hop))), nf - 1)
    if lag_min >= lag_max:
        z = torch.zeros((b, 1), device=dev)
        return CandidateList(z, z, torch.zeros((b, 1), dtype=torch.bool, device=dev))
    sl = acf[:, lag_min:lag_max + 1]
    max_sl = sl.amax(dim=-1, keepdim=True)
    prev = torch.cat([sl[:, :1], sl[:, :-1]], dim=-1)
    nxt = torch.cat([sl[:, 1:], sl[:, -1:]], dim=-1)
    static_ok, bpm_t = tables.on(dev, autocorr_lag_tables, lag_min, lag_max, sample_rate, hop,
                                 min_bpm, max_bpm, site="legacy.autocorr_tables")
    is_peak = (static_ok & (sl > prev) & (sl > nxt)
               & (sl - torch.maximum(prev, nxt) >= 0.1 * max_sl) & (max_sl >= EPSILON))
    conf = (sl / acf.amax(dim=-1, keepdim=True).clamp_min(EPSILON)).clamp_max(1.0)
    is_peak = is_peak & (onset_valid.sum(dim=-1) >= 2)[:, None]
    return _sort_by_confidence(bpm_t, conf, is_peak)


def comb_candidates(onset_pos, onset_valid, t_padded: int, sample_rate: int, min_bpm: float,
                    max_bpm: float, resolution: float) -> CandidateList:
    """Comb-filterbank scoring (comb_filter.rs:96-400): per BPM, the fraction
    of expected beats (anchored at sample 0) with an onset within the
    adaptive tolerance, normalized by the grid max; < 0.1 dropped. Counted
    onset-centrically: an onset within tol of beat k claims k, duplicates
    of the same k counted once (see the reference module)."""
    dev = onset_pos.device
    k = onset_pos.shape[1]
    period_t, tol_t, grid_t = tables.on(dev, comb_tables, sample_rate, min_bpm, max_bpm,
                                        resolution, site="legacy.comb_tables")
    sorted_pos = torch.sort(torch.where(onset_valid, onset_pos, INT_BIG), dim=-1).values
    sorted_pos = sorted_pos.to(torch.float32)
    n_valid = onset_valid.sum(dim=-1)
    last = torch.where(onset_valid, onset_pos, 0).amax(dim=-1).to(torch.float32)

    ovalid = torch.arange(k, device=dev)[None, :] < n_valid[:, None]
    o = sorted_pos[:, None, :]
    pj = period_t[None, :, None]
    k_idx = torch.round(o / pj).to(torch.int64)
    d = (o - k_idx.to(torch.float32) * pj).abs()
    hit = (d <= tol_t[None, :, None]) & ovalid[:, None, :]
    k_hit = torch.where(hit, k_idx, -1)
    k_prev = torch.cat([torch.full_like(k_hit[..., :1], -1),
                        torch.cummax(k_hit, dim=2).values[..., :-1]], dim=-1)
    aligned = (hit & ~(k_prev == k_idx)).sum(dim=-1)

    n_beats = torch.ceil(last[:, None] / period_t[None, :]) + 1
    score = aligned / n_beats.clamp_min(1.0)
    enough = n_valid >= 2
    score = torch.where(enough[:, None], score, 0.0)
    max_score = score.amax(dim=-1, keepdim=True)
    conf = torch.where(max_score > EPSILON, score / max_score.clamp_min(EPSILON), 0.0)
    valid = (conf >= 0.1) & enough[:, None]
    return _sort_by_confidence(grid_t, conf, valid)


def _first_true(mask: torch.Tensor) -> torch.Tensor:
    """Index of the first True on the last axis (0 when none), as jnp.argmax."""
    return mask.to(torch.uint8).argmax(dim=-1)


def _octave_correct(ac: CandidateList, comb: CandidateList, octave_tolerance_cents: float):
    """Rewrite autocorr BPMs at 2x / 0.5x of a comb top-3 candidate
    (candidate_filter.rs:147-228); the first matching comb candidate wins."""
    tol_ratio = 2.0 ** (octave_tolerance_cents / 1200.0) - 1.0
    comb3_bpm, comb3_valid = comb.bpm[:, :3], comb.valid[:, :3]
    c = comb3_bpm[:, None, :]
    c_ok = comb3_valid[:, None, :]
    reasonable_c = (c >= REASONABLE_MIN) & (c <= REASONABLE_MAX)
    a = ac.bpm[:, :, None]
    m2 = c_ok & ((a / (2.0 * c.clamp_min(EPSILON)) - 1.0).abs() < tol_ratio)
    m2 = m2 & (reasonable_c | (a > 200.0) | (a < 30.0))
    pick = lambda m: torch.gather(  # noqa: E731
        comb3_bpm[:, None, :].expand(m.shape), 2, _first_true(m)[..., None])[..., 0]
    new_bpm = torch.where(m2.any(dim=-1), pick(m2), ac.bpm)
    a2 = new_bpm[:, :, None]
    m5 = c_ok & ((c / (2.0 * a2.clamp_min(EPSILON)) - 1.0).abs() < tol_ratio) & reasonable_c
    new_bpm = torch.where(m5.any(dim=-1), pick(m5), new_bpm)
    return CandidateList(new_bpm, ac.confidence, ac.valid)


def _limit_autocorr(ac: CandidateList) -> CandidateList:
    """Top 10 plus re-added reasonable-range candidates not within 1 BPM of
    a kept one (candidate_filter.rs:241-269), then compacted to AC_CAP."""
    c = ac.bpm.shape[-1]
    idx = torch.arange(c, device=ac.bpm.device)
    base_keep = ac.valid & (idx[None, :] < MAX_PER_METHOD)
    reasonable = ac.valid & (ac.bpm >= REASONABLE_MIN) & (ac.bpm <= REASONABLE_MAX)
    kept = torch.full_like(ac.bpm, BIG)
    keep = torch.zeros_like(ac.valid)
    for i in range(c):
        bpm_i = ac.bpm[:, i]
        near = ((kept - bpm_i[:, None]).abs() < 1.0).any(dim=-1)
        k = base_keep[:, i] | (reasonable[:, i] & ~near)
        kept[:, i] = torch.where(k, bpm_i, BIG)
        keep[:, i] = k
    order = torch.sort((~keep).to(torch.uint8), dim=-1, stable=True).indices[:, :AC_CAP]
    return CandidateList(torch.gather(ac.bpm, 1, order), torch.gather(ac.confidence, 1, order),
                         torch.gather(keep, 1, order))


def _sane_guardrails(cfg: AnalysisConfig):
    """clamp_sane (mod.rs:120-148)."""
    pmin = min(cfg.legacy_bpm_preferred_min, cfg.legacy_bpm_preferred_max)
    pmax = max(cfg.legacy_bpm_preferred_min, cfg.legacy_bpm_preferred_max)
    smin = min(cfg.legacy_bpm_soft_min, cfg.legacy_bpm_soft_max, pmin)
    smax = max(cfg.legacy_bpm_soft_min, cfg.legacy_bpm_soft_max, pmax)
    return pmin, pmax, smin, smax


def merge_bpm_candidates(ac: CandidateList, comb: CandidateList, cfg: AnalysisConfig,
                         use_guardrails: bool):
    """Merge + score (candidate_filter.rs:153-452, mod.rs:226-339): greedy
    running-mean grouping within 2 BPM, confidence combine, consensus and
    safety boosts, guardrail multipliers, autocorr promotion. Returns
    bpm/confidence/method_agreement/ok, all [B]."""
    ac_orig = ac  # the promotion snapshot is the UNCORRECTED list (mod.rs:272-275)
    ac = _octave_correct(ac, comb, 50.0)
    diff = (ac.bpm[:, 0] - comb.bpm[:, 0]).abs()
    disagreement = ac.valid[:, 0] & comb.valid[:, 0] & (diff > 10.0) & (diff < 50.0)

    ac_lim = _limit_autocorr(ac)
    comb_lim = CandidateList(comb.bpm[:, :MAX_PER_METHOD], comb.confidence[:, :MAX_PER_METHOD],
                             comb.valid[:, :MAX_PER_METHOD])
    all_bpm = torch.cat([ac_lim.bpm, comb_lim.bpm], dim=-1)
    all_conf = torch.cat([ac_lim.confidence, comb_lim.confidence], dim=-1)
    all_valid = torch.cat([ac_lim.valid, comb_lim.valid], dim=-1)
    b, n = all_bpm.shape
    slots = torch.arange(n, device=all_bpm.device)[None, :]

    g_bpm = torch.zeros((b, n), device=all_bpm.device)
    g_conf, g_cnt, g_max = torch.zeros_like(g_bpm), torch.zeros_like(g_bpm), torch.zeros_like(g_bpm)
    for i in range(n):
        v, bpm_i, conf_i = all_valid[:, i], all_bpm[:, i], all_conf[:, i]
        near = ((bpm_i[:, None] - g_bpm).abs() <= 2.0) & (g_cnt > 0)
        has = near.any(dim=-1) & v
        tgt = _first_true(near)[:, None]
        cnt = torch.gather(g_cnt, 1, tgt)[:, 0]
        mean = torch.gather(g_bpm, 1, tgt)[:, 0]
        at = (slots == tgt) & has[:, None]
        g_bpm = torch.where(at, ((mean * cnt + bpm_i) / (cnt + 1.0))[:, None], g_bpm)
        g_conf = torch.where(at, (torch.gather(g_conf, 1, tgt)[:, 0] + conf_i)[:, None], g_conf)
        g_cnt = torch.where(at, (cnt + 1.0)[:, None], g_cnt)
        g_max = torch.where(at, torch.maximum(torch.gather(g_max, 1, tgt)[:, 0], conf_i)[:, None],
                            g_max)
        new = ((slots == i) & (v & ~has)[:, None])
        g_bpm = torch.where(new, bpm_i[:, None], g_bpm)
        g_conf = torch.where(new, conf_i[:, None], g_conf)
        g_cnt = torch.where(new, 1.0, g_cnt)
        g_max = torch.where(new, conf_i[:, None], g_max)
    g_valid = g_cnt > 0

    avg = g_conf / g_cnt.clamp_min(1.0)
    conf = torch.where(g_cnt >= 2.0, ((avg + g_max) / 2.0 * 1.2).clamp_max(1.0),
                       g_conf.clamp_max(1.0))
    conf = torch.where(disagreement[:, None] & (g_cnt == 1.0), conf * 0.7, conf)
    agreement = g_cnt.to(torch.int64)

    def near_any(cands: CandidateList, tol):
        c5, v5 = cands.bpm[:, :5][:, None, :], cands.valid[:, :5][:, None, :]
        return (v5 & ((c5 - g_bpm[:, :, None]).abs() < tol)).any(dim=-1)

    def harmonic_any(cands: CandidateList):
        c5, v5 = cands.bpm[:, :5][:, None, :], cands.valid[:, :5][:, None, :]
        e = g_bpm[:, :, None].clamp_min(EPSILON)
        ratio = torch.maximum(c5 / e, e / c5.clamp_min(EPSILON))
        hit = ((ratio - 2.0).abs() < 0.1) | ((ratio - 1.5).abs() < 0.1) | ((ratio - 0.75).abs() < 0.1)
        return (v5 & hit).any(dim=-1)

    ac_direct, cb_direct = near_any(ac_lim, 2.5), near_any(comb_lim, 2.5)
    ac_harm, cb_harm = harmonic_any(ac_lim), harmonic_any(comb_lim)
    conf = torch.where(ac_direct & cb_direct, conf * 1.5,
                       torch.where((ac_direct & cb_harm) | (cb_direct & ac_harm), conf * 1.3, conf))
    in_range = (g_bpm >= REASONABLE_MIN) & (g_bpm <= REASONABLE_MAX)
    conf = torch.where(cb_direct & in_range, conf * 1.4, conf)

    # safety boost: no reasonable group among the first 5 (candidate_filter.rs:364-381)
    has_reasonable_top5 = (g_valid & (slots < 5) & in_range).any(dim=-1)
    boost_slot = (~has_reasonable_top5[:, None] & (g_valid & in_range).any(dim=-1)[:, None]
                  & (slots == _first_true(g_valid & in_range)[:, None]))
    conf = torch.where(boost_slot, conf * 2.0, conf)

    eff = torch.where(in_range, conf, conf * 0.5) + torch.where(in_range, 0.5, 0.0)
    eff = eff + agreement.to(torch.float32) * 1e-4
    rank_key = torch.where(g_valid, eff, float("-inf"))
    if use_guardrails:
        g = _sane_guardrails(cfg)
        mul = torch.where((g_bpm >= g[0]) & (g_bpm <= g[1]), cfg.legacy_bpm_conf_mul_preferred,
                          torch.where((g_bpm >= g[2]) & (g_bpm <= g[3]),
                                      cfg.legacy_bpm_conf_mul_soft,
                                      cfg.legacy_bpm_conf_mul_extreme))
        conf = conf * mul
        rank_key = torch.where(g_valid, conf, float("-inf"))
        preferred_min, preferred_max = g[0], g[1]
    else:
        preferred_min, preferred_max = REASONABLE_MIN, REASONABLE_MAX

    acp_ok = ac_orig.valid & (ac_orig.bpm >= preferred_min) & (ac_orig.bpm <= preferred_max)
    acp_bpm = torch.gather(ac_orig.bpm, 1, _first_true(acp_ok)[:, None])[:, 0]
    promote = acp_ok.any(dim=-1)[:, None] & g_valid & ((g_bpm - acp_bpm[:, None]).abs() < 2.0)
    rank_key = torch.where(promote, rank_key + 1e6, rank_key)

    best = rank_key.argmax(dim=-1, keepdim=True)
    take = lambda a: torch.gather(a, 1, best)[:, 0]  # noqa: E731
    ok = g_valid.any(dim=-1)
    return {
        "bpm": torch.where(ok, take(g_bpm), 0.0),
        "confidence": torch.where(ok, take(conf), 0.0),
        "method_agreement": torch.where(ok, take(agreement), 0),
        "ok": ok,
    }


def estimate_bpm_legacy(onset_pos, onset_valid, t_padded: int, sample_rate: int,
                        cfg: AnalysisConfig):
    """Full legacy estimate (mod.rs:173-339); bpm/confidence/method_agreement/ok [B]."""
    ac = autocorr_candidates(onset_pos, onset_valid, t_padded, sample_rate, cfg.hop_size,
                             cfg.min_bpm, cfg.max_bpm)
    comb = comb_candidates(onset_pos, onset_valid, t_padded, sample_rate, cfg.min_bpm,
                           cfg.max_bpm, cfg.bpm_resolution)
    out = merge_bpm_candidates(ac, comb, cfg, cfg.enable_legacy_bpm_guardrails)
    out["ok"] = out["ok"] & (onset_valid.sum(dim=-1) >= 2)  # lib.rs:297
    return out
