"""Multi-resolution tempogram escalation (port of
``stratum_dsp_tpu/features/period/multi_resolution.py``,
multi_resolution.rs:205-900).

Candidate lists at hops {256, 512, 1024} score the hypotheses H(T), H(2T)
and H(T/2) with structural discounts and support-ratio guardrails; per
candidate a margin-gated switch picks the winner, a 0.75-BPM dedup keeps the
best 8, and the post-hoc fold-down, fold-up and the phase-optimized
triplet-family search on the hop-512 novelty finish the estimate.

The pipeline calls this on exactly the escalated tracks (a gathered
sub-batch that keeps the full batch's T). With ``precomputed`` base-pass
artifacts only the hop-256 STFT runs here; the hop-1024 curves come from
decimating the hop-512 features.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ... import tracing
from ...config import AnalysisConfig

from ...ops import masked, tables
from . import novelty as nov
from . import tempogram as tg
from . import tempogram_fft as tft

EPSILON = 1e-6
DEDUP_TOL = 0.75
MAX_UNIQUE = 8
FAMILY_FACTORS = (1.0, 1.5, 2.0 / 3.0, 4.0 / 3.0, 0.75)
# the candidate arrays of a tempogram estimate, score-ordered [B, top_n]
CAND_KEYS = ("cand_bpm", "cand_score", "cand_fft", "cand_ac", "cand_valid", "cand_selected")
# The family search evaluates candidates in [70, 180] BPM only
# (multi_resolution.rs:773-780): hop-512 periods of 28.7..73.8 frames, so
# phases are capped at PHASE_CAP and periods below PERIOD_MIN are refused.
PHASE_CAP = 80
PERIOD_MIN = 24


def _estimate(feats, frame_counts, cfg: AnalysisConfig, frame_rate: float, top_n: int):
    curves, nov_mask, n_valid = nov.assemble_novelty_curves(feats, frame_counts, cfg)
    fft_size = tft.padded_fft_size(curves["full"].shape[-1], frame_rate)
    variants = tg.compute_variants(curves, nov_mask, n_valid, frame_rate, cfg, fft_size)
    return tg.estimate_bpm_tempogram(variants, cfg, frame_rate, fft_size, top_n), curves, n_valid


def hop_candidates(samples, lengths, cfg: AnalysisConfig, sample_rate: int, hop: int,
                   top_n: int, mesh=None):
    """One hop's tempogram estimate (with its candidate list), full-band
    novelty curve and valid counts. An auxiliary pass: no stride-2 SuperFlux
    and no onset flux. With a ``(tracks, time)`` ``mesh`` (``samples`` then a
    tracks shard's ``parallel.timeblocks.TimeBlocks``) the STFT runs in
    time blocks (``parallel.timeblocks``, 512-frame chunks)."""
    if mesh is not None and "time" in mesh.shape:
        from ...parallel.timeblocks import compute_bpm_spectral_features_sharded

        feats, frame_counts, _ = compute_bpm_spectral_features_sharded(
            samples, lengths, cfg, sample_rate, cfg.frame_size, hop, mesh,
            emit_stride2=False, emit_onset_flux=False)
    else:
        feats, frame_counts, _ = nov.compute_bpm_spectral_features(
            samples, lengths, cfg, sample_rate, cfg.frame_size, hop, chunk_frames=256,
            emit_stride2=False, emit_onset_flux=False)
    est, curves, n_valid = _estimate(feats, frame_counts, cfg, sample_rate / hop, top_n)
    return est, curves["full"], n_valid


def beat_contrast_score(novelty, n_valid, bpm, sample_rate: int, hop: int,
                        fractional: bool = False):
    """Phase-optimized beat-contrast alignment (multi_resolution.rs:580-678)
    of ``novelty [B, N]`` for candidates ``bpm [B, F]``: max over phases of
    (mean windowed max at the beats - 0.6 half-beat mean - 0.4 third-beat
    mean) over the mean novelty. Returns [B, F].

    ``fractional`` (``cfg.beat_contrast_fractional``) steps the comb at the
    float period and rounds each beat on its own, where the integer-frame comb
    of multi_resolution.rs:580-604 rounds the period once: at 113.6 BPM the
    period is 45.48 frames, the integer comb steps 45 and drifts a frame every
    two beats, which loses the true tempo to its 2/3 relative."""
    b, n = novelty.shape
    dev = novelty.device
    frames_per_beat = masked.rdiv(60.0 * sample_rate, bpm.clamp_min(EPSILON) * hop)
    period = torch.round(frames_per_beat).to(torch.int64)  # half to even, as jnp.round
    ok = ((n_valid[:, None] >= 16) & torch.isfinite(frames_per_beat) & (frames_per_beat >= 3.0)
          & (period >= 3) & (period <= min(PHASE_CAP, 512)) & (period >= PERIOD_MIN))
    p = period.clamp(PERIOD_MIN, PHASE_CAP)  # [B, F]

    valid = masked.length_mask(n_valid, n)
    novm = torch.where(valid, novelty, 0.0)
    mx = torch.where(valid, masked.max_pool_1d(novm, 2), 0.0)  # windowed max +-2 frames
    total = novm.sum(dim=-1).clamp_min(EPSILON)
    mean_nov = (total / n_valid.clamp_min(1).to(torch.float32)).clamp_min(EPSILON)

    if fractional:
        return torch.where(ok, _fractional_contrast(mx, n_valid, frames_per_beat, mean_nov), 0.0)

    # Every frame i < n_valid lies in exactly one phase class i mod p, so
    # the four phase-grid means derive from the class sums T0[m] (one
    # scatter-add over i mod p): each offset grid is a cyclic reindex of T0
    # minus at most the one class member below the offset.
    marr = torch.arange(PHASE_CAP, device=dev)
    f = p.shape[-1]
    labels = torch.arange(n, device=dev) % p[:, :, None]  # [B, F, N]
    t0 = torch.zeros((b, f, PHASE_CAP), dtype=torch.float32, device=dev)
    t0.scatter_add_(2, labels, mx[:, None, :].expand(b, f, n))
    nv = n_valid.to(torch.int64)[:, None, None]
    pb = p[:, :, None]
    c0 = ((nv - marr + pb - 1) // pb).clamp_min(0)  # |{i < n_valid : i mod p = m}|
    c0 = torch.where(marr < torch.minimum(pb, nv), c0, 0)
    mx_lo = torch.where(marr[None, :] < n_valid[:, None], mx[:, :PHASE_CAP], 0.0)
    mx_lo = mx_lo[:, None, :].expand(b, f, PHASE_CAP)

    def class_mean(num: int, den: int):
        off = (p * num) // den  # [B, F], 0 <= off < p
        j0 = (marr + off[:, :, None]) % pb
        t = torch.gather(t0, 2, j0)
        cc = torch.gather(c0, 2, j0)
        drop = (j0 < off[:, :, None]) & (j0 < nv)  # the member whose base would be < 0
        t = t - torch.where(drop, torch.gather(mx_lo, 2, j0), 0.0)
        cc = cc - drop.to(cc.dtype)
        return t / cc.clamp_min(1).to(torch.float32), cc

    beat_mean, beat_n = class_mean(0, 1)
    half_mean, _ = class_mean(1, 2)
    third1, t1n = class_mean(1, 3)
    third2, t2n = class_mean(2, 3)
    third_mean = (third1 * t1n.to(torch.float32) + third2 * t2n.to(torch.float32)) \
        / (t1n + t2n).clamp_min(1).to(torch.float32)
    half_mean = torch.where(pb >= 6, half_mean, 0.0)
    third_mean = torch.where(pb >= 9, third_mean, 0.0)

    contrast = beat_mean - 0.60 * half_mean - 0.40 * third_mean
    score = (contrast / mean_nov[:, None, None]).clamp(-10.0, 10.0)
    phase_ok = (marr < pb) & (beat_n > 0)
    best = torch.where(phase_ok, score, -1e9).amax(dim=-1)
    return torch.where(ok, best, 0.0)


def _fractional_contrast(mx, n_valid, frames_per_beat, mean_nov):
    """The best phase's contrast ``[B, F]`` of the float-period comb over the
    windowed maxima ``mx [B, N]``: positions ``[B, F, P, K]`` of K beats at
    P phases, each rounded on its own and gathered from ``mx``.

    Beside the half- and third-beat penalties it subtracts 0.75 of the
    per-beat standard deviation: a grid at 2/3 or 4/3 of the true tempo hits
    every other beat, so its beat mean stays high while its half and third
    offsets miss every event; the true tempo's grid hits every beat."""
    b, n = mx.shape
    f = frames_per_beat.shape[-1]
    dev = mx.device
    fpb = frames_per_beat.clamp(float(PERIOD_MIN), float(PHASE_CAP))
    n_k = n // PERIOD_MIN + 2
    karr = torch.arange(n_k, dtype=torch.float32, device=dev)
    jphase = masked.cdiv(torch.arange(PHASE_CAP, dtype=torch.float32, device=dev), PHASE_CAP)
    base = jphase[None, None, :] * fpb[:, :, None]  # [B, F, P]

    def cmean(offset_frac: float, with_std: bool = False):
        pos = masked.fma((karr + offset_frac)[None, None, None, :], fpb[:, :, None, None],
                         base[..., None])
        q = torch.round(pos).to(torch.int64)  # [B, F, P, K]
        valid = q < n_valid[:, None, None, None]
        v = torch.gather(mx, -1, q.clamp(0, n - 1).reshape(b, -1)).reshape(q.shape)
        v = torch.where(valid, v, 0.0)
        cnt = valid.sum(dim=-1).to(torch.float32).clamp_min(1.0)  # [B, F, P]
        mean = v.sum(dim=-1) / cnt
        if not with_std:
            return mean, cnt
        var = torch.where(valid, (v - mean[..., None]) ** 2, 0.0).sum(dim=-1) / cnt
        return mean, cnt, torch.sqrt(var.clamp_min(0.0))

    beat_mean, beat_n, beat_std = cmean(0.0, with_std=True)
    half_mean, _ = cmean(0.5)
    t1, t1n = cmean(1.0 / 3.0)
    t2, t2n = cmean(2.0 / 3.0)
    third = (t1 * t1n + t2 * t2n) / (t1n + t2n).clamp_min(1.0)
    contrast = (beat_mean - 0.75 * beat_std) - 0.60 * half_mean - 0.40 * third
    score = (contrast / mean_nov[:, None, None]).clamp(-10.0, 10.0)
    return torch.where(beat_n > 0, score, -1e9).amax(dim=-1)


def _prior(bpm, score):
    return torch.where(bpm > 210.0, score * 0.80,
                       torch.where(bpm > 180.0, score * 0.90,
                                   torch.where(bpm < 60.0, score * 0.92, score)))


def multi_resolution_estimate(samples, lengths, cfg: AnalysisConfig, sample_rate: int,
                              precomputed: Optional[Dict] = None,
                              mesh=None) -> Dict[str, torch.Tensor]:
    """The multi-resolution pass: bpm / confidence / method_agreement / ok
    [B] for ``samples [B, T]``, and the hop-512 candidate arrays ``cand_*``
    [B, top_k] with ``cand_selected`` marked against the pass's own BPM.

    ``precomputed`` carries the base hop-512 pass of the same tracks:
    ``est`` (its estimate, score-ordered candidates at least top_k wide),
    ``feats`` and ``frame_counts`` (its streamed features, with the stride-2
    SuperFlux), ``novelty_full`` and ``n_valid``. Without it the hop-512 and
    hop-1024 passes are recomputed from the samples. ``mesh``: each pass's
    STFT in time blocks (see ``hop_candidates``)."""
    top_k = max(cfg.tempogram_multi_res_top_k, 1)
    aux_k = int(np.clip(top_k * 4, 25, 200))
    tol = max(2.0, cfg.bpm_resolution)

    with tracing.span("multires.hop256"):
        c256, _, _ = hop_candidates(samples, lengths, cfg, sample_rate, 256, aux_k, mesh=mesh)
    if precomputed is not None:
        with tracing.span("multires.hop1024"):
            c512 = {k: precomputed["est"][k][:, :top_k] for k in CAND_KEYS}
            nov512, nval512 = precomputed["novelty_full"], precomputed["n_valid"]
            feats1024, fc1024 = nov.decimate_features_2x(precomputed["feats"],
                                                         precomputed["frame_counts"])
            feats1024["band_names"] = nov.active_band_names(cfg, sample_rate, cfg.frame_size)
            c1024, _, _ = _estimate(feats1024, fc1024, cfg, sample_rate / 1024, aux_k)
    else:
        with tracing.span("multires.hop512"):
            c512, nov512, nval512 = hop_candidates(samples, lengths, cfg, sample_rate, 512,
                                                   top_k, mesh=mesh)
        with tracing.span("multires.hop1024"):
            c1024, _, _ = hop_candidates(samples, lengths, cfg, sample_rate, 1024, aux_k,
                                         mesh=mesh)
    with tracing.span("multires.vote"):
        return _vote(c256, c512, c1024, nov512, nval512, cfg, sample_rate, top_k, tol)


def _vote(c256, c512, c1024, nov512, nval512, cfg: AnalysisConfig, sample_rate: int,
          top_k: int, tol: float) -> Dict[str, torch.Tensor]:
    """``multi_resolution_estimate``'s hypotheses over the three hops'
    candidates: the weighted support, the margin-gated switch, the dedup,
    the folds and the triplet-family search."""
    w512, w256, w1024 = (cfg.tempogram_multi_res_w512, cfg.tempogram_multi_res_w256,
                         cfg.tempogram_multi_res_w1024)
    dt512 = cfg.tempogram_multi_res_double_time_512_factor
    margin_threshold = cfg.tempogram_multi_res_margin_threshold
    dev = c512["cand_bpm"].device

    def sup(c, q):
        return tg.cand_lookup_nearest(c["cand_bpm"], c["cand_score"], c["cand_valid"], q, tol)

    t_bpm = c512["cand_bpm"][:, :top_k]
    t_valid = c512["cand_valid"][:, :top_k] & torch.isfinite(t_bpm) & (t_bpm > 0.0)
    s_t_512, s_t_256, s_t_1024 = sup(c512, t_bpm), sup(c256, t_bpm), sup(c1024, t_bpm)
    s2 = t_bpm * 2.0
    s_2t_512, s_2t_256, s_2t_1024 = sup(c512, s2), sup(c256, s2), sup(c1024, s2)
    sh = t_bpm * 0.5
    s_h_512, s_h_256, s_h_1024 = sup(c512, sh), sup(c256, sh), sup(c1024, sh)

    h_t = w512 * s_t_512 + w256 * s_t_256 + w1024 * s_t_1024
    h_2t = w512 * (dt512 * s_t_512 + (1.0 - dt512) * s_2t_512) + w256 * s_2t_256 \
        + w1024 * s_2t_1024
    h_half = w512 * (dt512 * s_t_512 + (1.0 - dt512) * s_h_512) + w256 * s_h_256 \
        + w1024 * s_h_1024
    # structural discounts (multi_resolution.rs:470-476)
    h_half = torch.where(s_t_1024 > s_h_1024 * 1.02, h_half * 0.90, h_half)
    h_2t = torch.where(s_t_1024 > s_2t_1024 * 1.02, h_2t * 0.90, h_2t)
    # support-ratio guardrails (multi_resolution.rs:479-494)
    r2t = (s_2t_256 + EPSILON) / (s_t_256 + EPSILON)
    h_2t = torch.where(r2t < 1.10, h_2t * 0.75, h_2t)
    h_2t = torch.where(r2t < 1.00, h_2t * 0.75, h_2t)
    rh = (s_h_1024 + EPSILON) / (s_t_1024 + EPSILON)
    h_half = torch.where(rh < 1.10, h_half * 0.75, h_half)
    h_half = torch.where(rh < 1.00, h_half * 0.75, h_half)

    hyp_bpm = torch.stack([t_bpm, t_bpm * 2.0, t_bpm * 0.5], dim=-1)  # [B, K, 3]
    in_range = (hyp_bpm >= cfg.min_bpm) & (hyp_bpm <= cfg.max_bpm)
    hyp_score = _prior(hyp_bpm, torch.stack([h_t, h_2t, h_half], dim=-1))
    hyp_masked = torch.where(in_range, hyp_score, float("-inf"))

    order = torch.sort(-hyp_masked, dim=-1, stable=True).indices  # jnp.argsort is stable
    take = lambda a, i: torch.gather(a, -1, i[..., None])[..., 0]  # noqa: E731
    best_bpm_h = take(hyp_bpm, order[..., 0])
    best_score_h = take(hyp_masked, order[..., 0])
    second_score_h = take(hyp_masked, order[..., 1]).clamp_min(0.0)
    second_score_h = torch.where(torch.isfinite(second_score_h), second_score_h, 0.0)
    margin = best_score_h - second_score_h

    # margin-gated switch (multi_resolution.rs:503-508): keep T unless clear;
    # the fallback takes the RAW h_t, as the reference does
    switch = ((best_bpm_h - t_bpm).abs() > 1e-3) & (margin < margin_threshold)
    keep_t = switch & (t_bpm >= cfg.min_bpm) & (t_bpm <= cfg.max_bpm)
    chosen_bpm = torch.where(keep_t, t_bpm, best_bpm_h)
    chosen_score = torch.where(keep_t, h_t, best_score_h)
    if cfg.tempogram_multi_res_use_human_prior:
        tie = ((margin < margin_threshold) & (margin < 0.05) & (chosen_bpm >= 70.0)
               & (chosen_bpm <= 180.0))
        chosen_score = torch.where(tie, chosen_score + 0.05, chosen_score)
    hyp_ok = t_valid & torch.isfinite(chosen_score) & in_range.any(dim=-1)
    chosen_score = torch.where(hyp_ok, chosen_score, float("-inf"))

    # dedup by 0.75 BPM in score order, keep the best 8 (multi_resolution.rs:530-546)
    sorder = torch.sort(-chosen_score, dim=-1, stable=True).indices
    sb = torch.gather(chosen_bpm, 1, sorder)
    ss = torch.gather(chosen_score, 1, sorder)
    sv = torch.gather(hyp_ok, 1, sorder)
    kept = torch.full_like(sb, float("inf"))
    keep = torch.zeros_like(sv)
    for i in range(sb.shape[-1]):
        near = ((kept - sb[:, i:i + 1]).abs() < DEDUP_TOL).any(dim=-1)
        keep[:, i] = sv[:, i] & ~near
        kept[:, i] = torch.where(keep[:, i], sb[:, i], float("inf"))
    keep = keep & (torch.cumsum(keep.to(torch.int64), dim=-1) <= MAX_UNIQUE)

    ub = torch.where(keep, sb, 0.0)
    us = torch.where(keep, ss, float("-inf"))
    bidx = us.argmax(dim=-1, keepdim=True)
    best_bpm = torch.gather(ub, 1, bidx)[:, 0]
    best_score = torch.gather(us, 1, bidx)[:, 0]
    second_best = us.scatter(1, bidx, float("-inf")).amax(dim=-1).clamp_min(0.0)
    second_best = torch.where(torch.isfinite(second_best), second_best, 0.0)

    def total_support(q):
        a, b_, c = sup(c256, q), sup(c512, q), sup(c1024, q)
        return a + b_ + c, (a > 0).long() + (b_ > 0).long() + (c > 0).long()

    # fold-down (multi_resolution.rs:697-724)
    half = best_bpm * 0.5
    s_best, _ = total_support(best_bpm)
    s_half, a_half = total_support(half)
    ratio_dn = torch.where(s_best > 0.0, s_half / s_best.clamp_min(EPSILON), 0.0)
    do_dn = ((best_bpm >= 170.0) & (half >= 70.0) & (half <= 120.0) & (a_half >= 3)
             & (s_half > 0.0) & (s_best > 0.0) & (ratio_dn >= 0.45))
    best_bpm = torch.where(do_dn, half, best_bpm)
    best_score = torch.where(do_dn, s_half, best_score)

    # fold-up (multi_resolution.rs:727-751)
    dbl = best_bpm * 2.0
    s_best2, _ = total_support(best_bpm)
    s_dbl, a_dbl = total_support(dbl)
    ratio_up = torch.where(s_best2 > 0.0, s_dbl / s_best2.clamp_min(EPSILON), 0.0)
    do_up = ((best_bpm <= 80.0) & (dbl >= 70.0) & (dbl <= 180.0) & (a_dbl >= 2)
             & (s_dbl > 0.0) & (s_best2 > 0.0) & (ratio_up >= 0.55))
    best_bpm = torch.where(do_up, dbl, best_bpm)
    best_score = torch.where(do_up, s_dbl, best_score)

    # triplet-family search (multi_resolution.rs:764-867)
    factors = tables.on(dev, np.asarray, FAMILY_FACTORS, np.float32,
                        site="multires.family_factors")
    fam_bpm = best_bpm[:, None] * factors
    fam_in = ((fam_bpm >= cfg.min_bpm) & (fam_bpm <= cfg.max_bpm) & (fam_bpm >= 70.0)
              & (fam_bpm <= 180.0))
    fs, fa = total_support(fam_bpm)
    fam_ok = fam_in & (fa >= 2) & (fs > 0.0)
    n_fam = fam_ok.sum(dim=-1)
    best_support = torch.where(fam_ok, fs, 0.0).amax(dim=-1).clamp_min(EPSILON)
    alt = fam_ok & ((fam_bpm - best_bpm[:, None]).abs() > DEDUP_TOL)
    max_alt = torch.where(alt, fs / best_support[:, None], 0.0).amax(dim=-1)
    run_family = (best_bpm >= 70.0) & (best_bpm <= 180.0) & (n_fam >= 2) & (max_alt >= 0.45)
    align = beat_contrast_score(nov512, nval512, fam_bpm, sample_rate, 512,
                                cfg.beat_contrast_fractional)
    support_norm = (fs / best_support[:, None]).clamp(0.0, 1.0)
    fam_score = torch.where(fam_ok, align + 0.35 * support_norm, -1e9)
    ch = fam_score.argmax(dim=-1, keepdim=True)
    ch_bpm = torch.gather(fam_bpm, 1, ch)[:, 0]
    ch_align = torch.gather(align, 1, ch)[:, 0]
    ch_support = torch.gather(fs, 1, ch)[:, 0]
    cur_align = beat_contrast_score(nov512, nval512, best_bpm[:, None], sample_rate, 512,
                                    cfg.beat_contrast_fractional)[:, 0]
    do_fam = run_family & ((ch_bpm - best_bpm).abs() > DEDUP_TOL) & (ch_align >= cur_align + 0.40)
    best_bpm = torch.where(do_fam, ch_bpm, best_bpm)
    best_score = torch.where(do_fam, ch_support, best_score)

    confidence = torch.where(
        best_score > EPSILON,
        ((best_score - second_best).clamp_min(0.0) / best_score.clamp_min(EPSILON)).clamp(0.0, 1.0),
        0.0)
    _, agree = total_support(best_bpm)
    ok = hyp_ok.any(dim=-1)
    out = {
        "bpm": torch.where(ok, best_bpm, 0.0),
        "confidence": torch.where(ok, confidence, 0.0),
        "method_agreement": torch.where(ok, agree, 0),
        "ok": ok,
    }
    out.update({k: c512[k] for k in CAND_KEYS if k != "cand_selected"})
    out["cand_selected"] = out["cand_valid"] & (
        (out["cand_bpm"] - out["bpm"][:, None]).abs() < DEDUP_TOL)
    return out
