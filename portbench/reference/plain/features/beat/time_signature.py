"""Time-signature detection (port of
``stratum_dsp_tpu/features/beat/time_signature.py``,
time_signature.rs:90-205): per hypothesis lag L in {4, 3, 6}, the mean
interval similarity 1/(1 + |v[i]-v[i+L]|/mean) weighted 0.7 with the
consistency 1/(1+cv) weighted 0.3; < 8 beats defaults to 4/4 at 0.5."""

from __future__ import annotations

import torch

from ...ops.masked import fma, rdiv, tree_sum

EPSILON = 1e-10
FOUR_FOUR, THREE_FOUR, SIX_EIGHT = 0, 1, 2
BEATS_PER_BAR = (4.0, 3.0, 6.0)
HYPOTHESIS_LAGS = (4, 3, 6)


def positive_intervals(times, n):
    """Consecutive diffs of the compacted beat list, keeping only > 0, in
    order; returns (intervals [B, N-1] compacted to a prefix, count [B])."""
    mb = times.shape[-1]
    d = times[:, 1:] - times[:, :-1]
    ok = (torch.arange(mb - 1, device=times.device)[None, :] < (n - 1)[:, None]) & (d > 0.0)
    order = torch.sort((~ok).to(torch.uint8), dim=-1, stable=True).indices
    return torch.gather(torch.where(ok, d, 0.0), 1, order), ok.sum(dim=-1)


def detect_time_signature(times, n_beats):
    """(sig_index [B] in {0=4/4, 1=3/4, 2=6/8}, confidence [B]) for the
    compacted sorted beat list."""
    scores = time_signature_scores(times, n_beats)
    fallback = n_beats < 8
    return (torch.where(fallback, FOUR_FOUR, scores.argmax(dim=-1)),
            torch.where(fallback, 0.5, scores.amax(dim=-1).clamp(0.0, 1.0)))


def time_signature_scores(times, n_beats):
    """[B, 3] hypothesis scores (4/4, 3/4, 6/8). On a perfectly regular grid
    all three are ~1 and the choice rides on the last bit of the sums."""
    v, m = positive_intervals(times, n_beats)
    nmax = v.shape[-1]
    mf = m.clamp_min(1).to(torch.float32)
    ar = torch.arange(nmax, device=times.device)[None, :]
    imask = ar < m[:, None]
    # every sum in the reference's compiled order: on a regular grid the
    # hypotheses differ in the last bit
    mean = tree_sum(torch.where(imask, v, 0.0)) / mf
    var = tree_sum(torch.where(imask, (v - mean[:, None]) ** 2, 0.0)) / mf
    cv = torch.where(mean > EPSILON, torch.sqrt(var) / mean, 1.0)
    consistency = rdiv(1.0, 1.0 + cv)

    scores = []
    for lag in HYPOTHESIS_LAGS:
        cnt = (m - lag).clamp_min(0)
        pair_ok = imask & (ar < cnt[:, None])
        diff = (v - torch.roll(v, -lag, dims=-1)).abs()
        sim = rdiv(1.0, 1.0 + diff / mean[:, None].clamp_min(EPSILON))
        ac = tree_sum(torch.where(pair_ok, sim, 0.0)) / cnt.clamp_min(1)
        score = fma(ac, 0.7, consistency * 0.3).clamp_max(1.0)
        scores.append(torch.where((m >= lag) & (cnt > 0), score, 0.0))
    return torch.stack(scores, dim=-1)
