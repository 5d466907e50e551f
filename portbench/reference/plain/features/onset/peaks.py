"""Peak-picking primitives on masked batched curves (port of
``stratum_dsp_tpu/features/onset/peaks.py``; energy_flux.rs:170-243)."""

from __future__ import annotations

import torch

from ...ops.masked import valid_extent

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
    ``(pos [B, k], valid [B, k])``."""
    key = torch.where(peak, positions.expand_as(peak), INT_BIG)
    s = torch.sort(key, dim=-1).values[..., :k]
    if s.shape[-1] < k:
        s = torch.nn.functional.pad(s, (0, k - s.shape[-1]), value=INT_BIG)
    return torch.where(s == INT_BIG, 0, s), s != INT_BIG


def dedup_min_distance(pos: torch.Tensor, valid: torch.Tensor, min_dist: int):
    """Keep entry i iff pos[i] >= last_kept + min_dist over a sorted onset
    list (energy_flux.rs:228-243); a loop over slots. Returns the keep mask."""
    last = torch.full(pos.shape[:-1], -(2**30), dtype=pos.dtype, device=pos.device)
    keep = torch.zeros_like(valid)
    for i in range(valid_extent(valid)):
        p = pos[..., i]
        k = valid[..., i] & (p >= last + min_dist)
        last = torch.where(k, p, last)
        keep[..., i] = k
    return keep
