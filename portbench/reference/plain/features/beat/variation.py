"""Tempo-variation detection + Bayesian segment refinement (port of
``stratum_dsp_tpu/features/beat/variation.py``; tempo_variation.rs,
bayesian.rs).

Overlapping segments of clamp(total/4, 4..8) s with a 50% hop; a segment is
variable iff its beat-interval CV exceeds 0.15. Only when some track has a
variable segment does the refinement run: a sequential Bayesian tracker
proposes BPMs +-5 @ 0.5 around its running estimate, variable segments are
re-tracked at the refined BPM, constant segments keep their beats, and the
union (overlap duplicates included) replaces the beat list.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ...ops.masked import cdiv, rdiv
from .hmm import EMISSION_SIGMA, EMISSION_THRESHOLD, TIMING_TOLERANCE_S, BeatTensor

EPSILON = 1e-10
BIG = 1e9
MIN_SEGMENT_DURATION_S = 2.0
TEMPO_VARIATION_THRESHOLD = 0.15
LIKELIHOOD_SIGMA = 0.05
N_CANDIDATES = 21  # +-5 BPM @ 0.5 steps
SEG_ONSET_CAP = 512  # onsets per 4-8 s segment


def compact_sorted(times, valid):
    """Invalid entries pushed to the end as BIG; returns (times, n_valid)."""
    return torch.sort(torch.where(valid, times, BIG), dim=-1).values, valid.sum(dim=-1)


def _searchsorted(sorted_rows, values, right=False):
    return torch.searchsorted(sorted_rows.contiguous(), values.contiguous(), right=right)


def refine_beats(beats: BeatTensor, nominal_bpm, bpm_confidence, onset_times, onset_valid,
                 seg_beat_cap: int, max_segments: int):
    """Variation detection + refinement. Returns (BeatTensor
    [B, max(max_segments*seg_beat_cap, MB)], has_variation [B])."""
    b, mb = beats.times.shape
    dev = beats.times.device
    bt, n_beats = compact_sorted(beats.times, beats.valid)
    order = torch.sort(torch.where(beats.valid, beats.times, BIG), dim=-1, stable=True).indices
    bconf = torch.gather(torch.where(beats.valid, beats.confidence, 0.0), 1, order)
    ot, n_onsets = compact_sorted(onset_times, onset_valid)

    t0 = torch.where(n_beats > 0, bt[:, 0], 0.0)
    tlast = torch.gather(bt, 1, (n_beats - 1).clamp_min(0)[:, None])[:, 0]
    tlast = torch.where(n_beats > 0, tlast, 0.0)
    total = tlast - t0
    segmentable = (n_beats >= 4) & (total >= MIN_SEGMENT_DURATION_S)
    seg_dur = (total / 4.0).clamp(4.0, 8.0)
    hop = seg_dur * 0.5

    d = bt[:, 1:] - bt[:, :-1]
    d = torch.where(torch.arange(mb - 1, device=dev)[None, :] < (n_beats - 1)[:, None], d, 0.0)
    csum_d = F.pad(torch.cumsum(d, dim=-1), (1, 0))
    csum_d2 = F.pad(torch.cumsum(d * d, dim=-1), (1, 0))

    s_count, k_on = max_segments, ot.shape[-1]
    s_arr = torch.arange(s_count, device=dev, dtype=torch.float32)
    start = t0[:, None] + s_arr[None, :] * hop[:, None]  # [B, S]
    end = torch.minimum(start + seg_dur[:, None], tlast[:, None])
    exists = segmentable[:, None] & (start < tlast[:, None])

    i0 = _searchsorted(bt, start)
    i1 = torch.minimum(_searchsorted(bt, end, right=True), n_beats[:, None])
    cnt = i1 - i0
    n_int = (cnt - 1).clamp_min(0)
    hi_idx = (i1 - 1).clamp_min(0)
    ssum = torch.gather(csum_d, 1, hi_idx) - torch.gather(csum_d, 1, i0)
    ssum2 = torch.gather(csum_d2, 1, hi_idx) - torch.gather(csum_d2, 1, i0)
    nf = n_int.clamp_min(1).to(torch.float32)
    mean = ssum / nf
    var = (ssum2 / nf - mean * mean).clamp_min(0.0)
    cv = torch.where(mean > EPSILON, torch.sqrt(var) / mean, 0.0)
    seg_ok = exists & (cnt >= 3) & (n_int > 0)
    is_var_all = seg_ok & (cv > TEMPO_VARIATION_THRESHOLD)
    has_variation = is_var_all.any(dim=-1)

    n_out = max(s_count * seg_beat_cap, mb)
    orig = (torch.where(beats.valid, beats.times, 0.0),
            torch.where(beats.valid, beats.confidence, 0.0), beats.valid)
    times, conf, valid = (F.pad(x, (0, n_out - mb)) for x in orig)

    if bool(has_variation.any()):  # the reference refines only on variation
        seg_times, seg_conf, seg_valid = _refine_segments(
            bt, bconf, ot, n_onsets, nominal_bpm, start, end, i0, i1, is_var_all, seg_ok,
            seg_beat_cap)
        seg_times, seg_conf, seg_valid = (
            F.pad(x.reshape(b, -1), (0, n_out - s_count * seg_beat_cap))
            for x in (seg_times, seg_conf, seg_valid))
        use_refined = (has_variation & seg_valid.any(dim=-1))[:, None]
        times = torch.where(use_refined, seg_times, times)
        conf = torch.where(use_refined, seg_conf, conf)
        valid = torch.where(use_refined, seg_valid, valid)

    order = torch.sort(torch.where(valid, times, BIG), dim=-1, stable=True).indices
    valid = torch.gather(valid, 1, order)
    final = BeatTensor(times=torch.where(valid, torch.gather(times, 1, order), 0.0),
                       confidence=torch.gather(conf, 1, order), valid=valid)
    return final, has_variation


def _refine_segments(bt, bconf, ot, n_onsets, nominal_bpm, start, end, i0, i1, is_var_all,
                     seg_ok, seg_beat_cap: int):
    """Per-segment beats [B, S, cap]: re-tracked at the Bayesian BPM for
    variable segments, the original beats for constant ones."""
    b, mb = bt.shape
    s_count, k_on = start.shape[1], ot.shape[-1]
    dev = bt.device
    j0 = _searchsorted(ot, start)
    j1 = torch.minimum(_searchsorted(ot, end, right=True), n_onsets[:, None])
    has_onsets_all = (j1 - j0) >= 1
    cap_idx = j0[..., None] + torch.arange(SEG_ONSET_CAP, device=dev)[None, None, :]
    seg_ovalid_all = cap_idx < j1[..., None]
    seg_ot_all = torch.gather(ot[:, None, :].expand(b, s_count, k_on), 2,
                              cap_idx.clamp_max(k_on - 1))  # [B, S, cap]
    seg_first_onset_all = torch.gather(ot, 1, j0.clamp_max(k_on - 1))
    seg_last_onset_all = torch.gather(ot, 1, (j1 - 1).clamp_min(0))

    # constant segments: the earliest seg_beat_cap original beats of each
    beat_idx = torch.arange(mb, device=dev)
    in_seg = (beat_idx >= i0[..., None]) & (beat_idx < i1[..., None])  # [B, S, mb]
    key = torch.where(in_seg, bt[:, None, :], BIG)
    bt_b, bconf_b = bt, bconf
    if mb < seg_beat_cap:
        pad = seg_beat_cap - mb
        key = F.pad(key, (0, pad), value=BIG)
        bt_b, bconf_b = F.pad(bt, (0, pad)), F.pad(bconf, (0, pad))
        in_seg = F.pad(in_seg, (0, pad))
    order_c = torch.sort(key, dim=-1, stable=True).indices[..., :seg_beat_cap]
    expand = lambda x: x[:, None, :].expand(b, s_count, x.shape[-1])  # noqa: E731
    times_c = torch.gather(expand(bt_b), 2, order_c)
    conf_c = torch.gather(expand(bconf_b), 2, order_c)
    valid_c = torch.gather(in_seg, 2, order_c)
    times_c = torch.where(valid_c, times_c, 0.0)

    # the sequential Bayesian BPM chain over segments (bayesian.rs:183-254)
    cand_off = 0.5 * torch.arange(N_CANDIDATES, device=dev, dtype=torch.float32)
    cur_bpm = nominal_bpm
    chain = []
    for s in range(s_count):
        seg_ot, omask = seg_ot_all[:, s], seg_ovalid_all[:, s]
        min_c = (cur_bpm - 5.0).clamp_min(60.0)
        max_c = (cur_bpm + 5.0).clamp_max(180.0)
        cand = min_c[:, None] + cand_off[None, :]
        cand_ok = cand <= max_c[:, None] + 1e-6
        interval = rdiv(60.0, cand.clamp_min(EPSILON))
        rel = seg_ot[:, None, :] - seg_first_onset_all[:, s][:, None, None]
        bi = torch.round(rel / interval[:, :, None])
        dd = (rel - bi * interval[:, :, None]).abs()
        logp = cdiv(-(dd * dd), 2.0 * LIKELIHOOD_SIGMA * LIKELIHOOD_SIGMA)
        cnt_o = omask.sum(dim=-1).clamp_min(1).to(torch.float32)
        avg_logp = torch.where(omask[:, None, :], logp, 0.0).sum(dim=-1) / cnt_o[:, None]
        lik = torch.where(cand_ok, torch.exp(avg_logp), -1.0)
        best_c = lik.argmax(dim=-1, keepdim=True)
        best_lik = torch.gather(lik, 1, best_c)[:, 0]
        best_bpm = torch.where(best_lik > 0.0, torch.gather(cand, 1, best_c)[:, 0], cur_bpm)
        cur_bpm = torch.where(is_var_all[:, s] & has_onsets_all[:, s], best_bpm, cur_bpm)
        chain.append(cur_bpm)
    seg_bpm = torch.stack(chain, dim=1)  # [B, S]

    # variable-segment re-tracking, vectorized over all segments
    seg_interval = rdiv(60.0, seg_bpm.clamp_min(EPSILON))
    fidx = torch.arange(seg_beat_cap, device=dev, dtype=torch.float32)
    times_v = seg_first_onset_all[..., None] + fidx * seg_interval[..., None]
    nfr = torch.ceil((seg_last_onset_all - seg_first_onset_all).clamp_min(0.0)
                     / seg_interval).to(torch.int64) + 1
    fvalid = fidx < nfr.clamp_max(seg_beat_cap)[..., None]
    rel_o = seg_ot_all - seg_first_onset_all[..., None]
    bi_f = torch.floor(rel_o / seg_interval[..., None])
    d_f = (rel_o - bi_f * seg_interval[..., None]).abs()
    d_c = ((bi_f + 1.0) * seg_interval[..., None] - rel_o).abs()

    def claim_min(bi, dd):  # nearest claiming onset per slot
        m = (bi[..., None] == fidx) & seg_ovalid_all[..., None]
        return torch.where(m, dd[..., None], BIG).amin(dim=2)  # [B, S, slots]

    dist = torch.minimum(claim_min(bi_f, d_f), claim_min(bi_f + 1.0, d_c))
    em = torch.exp(cdiv(-(dist * dist), 2.0 * EMISSION_SIGMA * EMISSION_SIGMA))
    is_beat_v = fvalid & (em > EMISSION_THRESHOLD) & has_onsets_all[..., None]
    align = torch.where(dist < TIMING_TOLERANCE_S, 1.0 - cdiv(dist, TIMING_TOLERANCE_S), 0.0)
    conf_v = (0.7 * em + 0.3 * align).clamp_max(1.0)

    use_var = is_var_all[..., None]
    seg_times = torch.where(use_var, torch.where(is_beat_v, times_v, 0.0), times_c)
    seg_conf = torch.where(use_var, torch.where(is_beat_v, conf_v, 0.0),
                           torch.where(valid_c, conf_c, 0.0))
    seg_valid = torch.where(use_var, is_beat_v, valid_c) & seg_ok[..., None]
    return seg_times, seg_conf, seg_valid
