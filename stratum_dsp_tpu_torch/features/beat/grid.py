"""Beat-grid assembly (port of ``stratum_dsp_tpu/features/beat/grid.py``,
beat_tracking/mod.rs:108-485): phase search -> drift fit -> HMM track ->
variation refine -> time signature -> downbeats (CUDA kernel
``ops/downbeats.py``) -> stability, plus the downbeat phase search."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ...ops import masked, tables
from ...ops.downbeats import downbeat_mask
from ...ops.masked import fma
from . import hmm, time_signature as ts
from .variation import BIG, compact_sorted, refine_beats

EPSILON = 1e-10


class BeatGridTensor(NamedTuple):
    """Beat grid for a batch."""

    beat_times: torch.Tensor  # [B, N] seconds, compacted ascending
    beat_valid: torch.Tensor  # [B, N]
    downbeat_times: torch.Tensor  # [B, N]
    downbeat_valid: torch.Tensor  # [B, N]
    stability: torch.Tensor  # [B]
    time_signature: torch.Tensor  # [B] (0=4/4, 1=3/4, 2=6/8)
    time_signature_confidence: torch.Tensor  # [B]
    has_tempo_variation: torch.Tensor  # [B] bool
    ok: torch.Tensor  # [B] bool


def _beats_per_bar(sig_index):
    return tables.on(sig_index.device, np.asarray, ts.BEATS_PER_BAR, np.float32,
                     site="grid.beats_per_bar")[sig_index]


def detect_downbeats(times, n_beats, bpm, sig_index):
    """Greedy downbeat marking (mod.rs:363-404) over compacted ascending
    ``times``: the downbeat kernel on a CUDA tensor, its plain version on CPU."""
    bar = masked.rdiv(60.0, bpm.clamp_min(EPSILON)) * _beats_per_bar(sig_index)
    return downbeat_mask(times, n_beats, bar)


def grid_stability(times, n_beats):
    """1/(1+CV) over positive beat intervals (mod.rs:425-485); < 2 beats -> 0."""
    v, m = ts.positive_intervals(times, n_beats)
    mf = m.clamp_min(1).to(torch.float32)
    imask = torch.arange(v.shape[-1], device=v.device)[None, :] < m[:, None]
    mean = torch.where(imask, v, 0.0).sum(dim=-1) / mf
    var = torch.where(imask, (v - mean[:, None]) ** 2, 0.0).sum(dim=-1) / mf
    cv = torch.sqrt(var) / mean.clamp_min(EPSILON)
    stab = masked.rdiv(1.0, 1.0 + cv)
    return torch.where((n_beats >= 2) & (m >= 1) & (mean > 1e-10), stab, 0.0)


def _three_tap_max(novelty):
    zero = novelty[:, :1] * 0.0
    return torch.maximum(novelty, torch.maximum(torch.cat([novelty[:, 1:], zero], dim=-1),
                                                torch.cat([zero, novelty[:, :-1]], dim=-1)))


def search_phase_anchor(bpm, onset_times, onset_valid, novelty, novelty_n, frame_rate: float,
                        max_beats: int, n_offsets: int = 32):
    """Novelty-optimized grid phase anchor [B] seconds: scores ``n_offsets``
    phases across one beat interval around the first onset by the mean
    3-tap-max novelty at every 4th grid beat, prefers the reference anchor on
    flat ties, then snaps to an onset within a quarter interval."""
    b = bpm.shape[0]
    dev = bpm.device
    interval = masked.rdiv(60.0, torch.where(bpm > EPSILON, bpm, 120.0))
    start = torch.where(onset_valid, onset_times, 1e9).amin(dim=-1)
    start = torch.where(onset_valid.any(dim=-1), start, 0.0)
    offs = torch.arange(n_offsets, device=dev, dtype=torch.float32) / n_offsets - 0.5
    anchors = fma(offs[None, :], interval[:, None], start[:, None])  # [B, P]
    k = torch.arange(max_beats // 4, device=dev, dtype=torch.float32) * 4.0
    grid = fma(k[None, None, :], interval[:, None, None], anchors[:, :, None])
    fidx = torch.round(grid * frame_rate).to(torch.int64)  # [B, P, MB/4]
    in_range = (fidx >= 0) & (fidx < novelty_n[:, None, None])
    nmax = _three_tap_max(novelty)
    fidx = fidx.clamp(0, novelty.shape[-1] - 1)
    vals = torch.gather(nmax, 1, fidx.reshape(b, -1)).reshape(fidx.shape)
    vals = torch.where(in_range, vals, 0.0)
    score = vals.sum(dim=-1) / in_range.sum(dim=-1).to(torch.float32).clamp_min(1.0)
    ref_j = n_offsets // 2  # offs[P/2] == 0.0: the reference's own anchor
    score[:, ref_j] = score[:, ref_j] * (1.0 + 1e-4)
    anchor = torch.gather(anchors, 1, score.argmax(dim=-1, keepdim=True))[:, 0]
    snap_t, snap_d = masked.searchsorted_nearest(
        anchor[:, None], torch.where(onset_valid, onset_times, 1e9), onset_valid.sum(dim=-1), 1e9)
    return torch.where(snap_d[:, 0] < interval * 0.25, snap_t[:, 0], anchor)


def search_downbeat_phase(grid: BeatGridTensor, novelty, novelty_n, frame_rate: float):
    """Re-phase the downbeats by low-band accent evidence: every rotation
    r < beats_per_bar of the beat list is scored by the mean 3-tap-max
    novelty at its candidate downbeats (epsilon preference for r=0)."""
    bt, bvalid = grid.beat_times, grid.beat_valid
    n = bt.shape[1]
    bpb = _beats_per_bar(grid.time_signature).to(torch.int64)
    nmax = _three_tap_max(novelty)
    fidx = torch.round(bt * frame_rate).to(torch.int64)
    in_r = bvalid & (fidx >= 0) & (fidx < novelty_n[:, None])
    vals = torch.gather(nmax, 1, fidx.clamp(0, novelty.shape[-1] - 1))
    vals = torch.where(in_r, vals, 0.0)
    i = torch.arange(n, device=bt.device)
    scores = []
    for r in range(int(max(ts.BEATS_PER_BAR))):
        m = in_r & (torch.remainder(i[None, :] - r, bpb[:, None]) == 0)
        s = torch.where(m, vals, 0.0).sum(dim=-1) / m.sum(dim=-1).to(torch.float32).clamp_min(1.0)
        scores.append(torch.where(r < bpb, s, -1.0))
    sc = torch.stack(scores, dim=-1)
    sc[:, 0] = sc[:, 0] * (1.0 + 1e-4)
    best_r = sc.argmax(dim=-1)
    db_mask = bvalid & (torch.remainder(i[None, :] - best_r[:, None], bpb[:, None]) == 0)
    db_sorted = torch.sort(torch.where(db_mask, bt, BIG), dim=-1).values
    db_valid = db_sorted < BIG * 0.5
    return grid._replace(
        downbeat_times=torch.where(grid.ok[:, None], torch.where(db_valid, db_sorted, 0.0), 0.0),
        downbeat_valid=db_valid & grid.ok[:, None])


def fit_grid_drift(anchor, bpm, onset_times, onset_valid, max_beats: int, n_iter: int = 4):
    """Robust refit of (anchor, interval) against matched onsets over the
    first 256 slots: the interval is the median slope of consecutive matched
    onsets, the anchor the median residual; the match window anneals
    (0.12, 0.10, 0.07, 0.05 interval). Guards: >= 8 adjacent matched pairs
    and a fitted interval within 2% of nominal, else unchanged. Returns
    (anchor', interval_scale')."""
    o_sorted = torch.where(onset_valid, onset_times, 1e9)
    n_on = onset_valid.sum(dim=-1)
    interval0 = masked.rdiv(60.0, bpm.clamp_min(EPSILON))
    k = torch.arange(min(max_beats, 256), device=bpm.device, dtype=torch.float32)
    windows = (0.12, 0.10, 0.07, 0.05)
    a, scale = anchor, torch.ones_like(anchor)
    for it in range(n_iter):
        interval = interval0 * scale
        grid = fma(k[None, :], interval[:, None], a[:, None])
        o, d = masked.searchsorted_nearest(grid, o_sorted, n_on, 1e9)
        w = d < windows[min(it, len(windows) - 1)] * interval[:, None]
        ordidx = torch.sort((~w).to(torch.uint8), dim=-1, stable=True).indices
        o_c = torch.gather(o, 1, ordidx)
        k_c = torch.gather(k[None, :].expand(o.shape), 1, ordidx)
        n_m = w.sum(dim=-1)
        gap = k_c[:, 1:] - k_c[:, :-1]
        slope = (o_c[:, 1:] - o_c[:, :-1]) / gap.clamp_min(1.0)
        pair_ok = ((torch.arange(o.shape[-1] - 1, device=o.device)[None, :] < (n_m - 1)[:, None])
                   & (gap >= 1.0) & (gap <= 4.0))
        rel = masked.masked_median(slope, pair_ok) / interval0.clamp_min(EPSILON)
        ok = (pair_ok.sum(dim=-1) >= 8) & ((rel - 1.0).abs() < 0.02)
        r = fma(-k[None, :], (interval0 * torch.where(ok, rel, scale))[:, None], o)
        a = torch.where(ok, masked.masked_median(r, w), a)
        scale = torch.where(ok, rel, scale)
    return a, scale


def generate_beat_grid(bpm, bpm_confidence, onset_times, onset_valid, max_beats: int = 1024,
                       seg_beat_cap: int = 64, max_segments: int = 48, anchor=None,
                       interval_scale=None, fill: bool = False) -> BeatGridTensor:
    """Full grid generation for a batch (mod.rs:108-250)."""
    ok = (bpm > 0.0) & (bpm <= 300.0) & (onset_valid.sum(dim=-1) >= 1)
    beats, _states = hmm.track_beats(bpm, onset_times, onset_valid, max_beats, anchor,
                                     interval_scale, fill)
    ok = ok & beats.valid.any(dim=-1)
    refined, has_variation = refine_beats(beats, bpm, bpm_confidence, onset_times, onset_valid,
                                          seg_beat_cap, max_segments)
    btimes, n_beats = compact_sorted(refined.times, refined.valid)
    slot_valid = torch.arange(btimes.shape[-1], device=bpm.device)[None, :] < n_beats[:, None]
    btimes = torch.where(slot_valid, btimes, 0.0)

    sig, sig_conf = ts.detect_time_signature(btimes, n_beats)
    db_mask = detect_downbeats(btimes, n_beats, bpm, sig)
    stability = grid_stability(btimes, n_beats)
    db_sorted = torch.sort(torch.where(db_mask, btimes, BIG), dim=-1).values
    db_valid = db_sorted < BIG * 0.5
    okc = ok[:, None]
    return BeatGridTensor(
        beat_times=torch.where(okc, btimes, 0.0),
        beat_valid=slot_valid & okc,
        downbeat_times=torch.where(okc, torch.where(db_valid, db_sorted, 0.0), 0.0),
        downbeat_valid=db_valid & okc,
        stability=torch.where(ok, stability, 0.0),
        time_signature=sig,
        time_signature_confidence=sig_conf,
        has_tempo_variation=has_variation & ok,
        ok=ok,
    )
