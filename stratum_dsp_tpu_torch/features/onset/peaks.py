"""Peak-picking primitives on masked batched curves (port of
``stratum_dsp_tpu/features/onset/peaks.py``; energy_flux.rs:170-243)."""

from __future__ import annotations

import torch

from ... import tracing

INT_BIG = 2**31 - 1


def peak_mask_1d(x: torch.Tensor, valid: torch.Tensor, threshold: torch.Tensor):
    """Interior local maxima (x[i] > x[i-1], x[i] >= x[i+1]) above the
    threshold, plus the first-element (x[0] >= x[1]) and last-element
    (x[n-1] > x[n-2]) cases; rows with < 2 valid entries have no peaks."""
    n = x.shape[-1]
    thr = threshold[..., None]
    n_valid = valid.sum(dim=-1)[..., None]
    idx = torch.arange(n, device=x.device)
    prev = torch.cat([x[..., :1], x[..., :-1]], dim=-1)
    nxt = torch.cat([x[..., 1:], x[..., -1:]], dim=-1)
    above = x > thr
    interior = (idx >= 1) & (idx < n_valid - 1) & above & (x > prev) & (x >= nxt)
    first = (idx == 0) & (n_valid > 1) & above & (x >= nxt)
    last = (idx == n_valid - 1) & (n_valid > 1) & above & (x > prev)
    return (interior | first | last) & valid


def peaks_to_positions(peak: torch.Tensor, positions: torch.Tensor, k: int):
    """Peak mask ``[B, N]`` + positions -> the K earliest peaks as sorted
    ``(pos [B, k], valid [B, k])``; rows with more peaks are flagged
    (``tracing.flag_capped``)."""
    tracing.flag_capped(lambda: peak.sum(dim=-1) > k)
    key = torch.where(peak, positions.expand_as(peak), INT_BIG)
    s = torch.sort(key, dim=-1).values[..., :k]
    if s.shape[-1] < k:
        s = torch.nn.functional.pad(s, (0, k - s.shape[-1]), value=INT_BIG)
    return torch.where(s == INT_BIG, 0, s), s != INT_BIG


def dedup_min_distance(pos: torch.Tensor, valid: torch.Tensor, min_dist: int):
    """Keep entry i iff pos[i] >= last_kept + min_dist over a sorted onset
    list, valid entries first (as ``peaks_to_positions`` returns them;
    energy_flux.rs:228-243). Returns the keep mask.

    The kept entries are the greedy chain from the first entry at or above
    ``-2**30 + min_dist``: each entry's successor is the first later entry
    ``min_dist`` on (a ``searchsorted``). The chain is marked by pointer
    doubling, ``ceil(log2(K + 1))`` rounds of a scatter and a gather, so the
    launches do not grow with a row's onsets."""
    k = pos.shape[-1]
    key = torch.where(valid, pos.long(), INT_BIG).contiguous()
    idx = torch.arange(k, device=pos.device)
    step = torch.maximum(torch.searchsorted(key, key + min_dist), idx + 1)
    # slot k is the chain's end, its own successor
    jump = torch.cat([step, step.new_full(step.shape[:-1] + (1,), k)], dim=-1)
    first = key.new_full(key.shape[:-1] + (1,), -(2**30) + min_dist)
    mark = torch.zeros(jump.shape, dtype=torch.int32, device=pos.device)
    mark.scatter_(-1, torch.searchsorted(key, first), 1)
    for _ in range(k.bit_length()):
        mark = mark.scatter_reduce(-1, jump, mark, "amax")
        jump = torch.gather(jump, -1, jump)
    return (mark[..., :k] > 0) & valid
