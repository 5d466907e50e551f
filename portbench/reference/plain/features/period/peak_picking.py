"""Generic peak picking (port of
``stratum_dsp_tpu/features/period/peak_picking.py``, peak_picking.rs:39-120).
A utility of the package's surface; the pipeline does not call it.

* interior peaks are strict local maxima;
* the first and last valid elements count when they exceed their one
  neighbour (peak_picking.rs:87-100);
* ``threshold`` in (0, 1) is relative to the signal's maximum (when that is
  positive), otherwise absolute (peak_picking.rs:57-66);
* the ``min_distance`` dedup keeps peaks by descending value: a lower peak
  within ``min_distance`` of a kept one is dropped wherever it lies
  (peak_picking.rs:102-120).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ...ops import masked

EPSILON = 1e-10


def find_peaks(x: torch.Tensor, valid: torch.Tensor, threshold: float = 0.0,
               min_distance: int = 1) -> torch.Tensor:
    """Boolean peak mask over the last axis."""
    n = x.shape[-1]
    ninf = float("-inf")
    xm = torch.where(valid, x, ninf)
    n_valid = valid.sum(dim=-1)[..., None]
    idx = torch.arange(n, device=x.device)

    mx = masked.masked_max(x, valid)[..., None]
    if 0.0 < threshold < 1.0:
        thr = torch.where(mx > 0.0, mx * threshold, threshold)
    else:
        thr = torch.full_like(mx, threshold)

    prev = F.pad(xm[..., :-1], (1, 0), value=ninf)
    nxt = F.pad(xm[..., 1:], (0, 1), value=ninf)
    interior = (idx >= 1) & (idx < n_valid - 1)
    first = idx == 0
    last = idx == n_valid - 1
    peaks = valid & ((interior & (xm > prev) & (xm > nxt))
                     | (first & (n_valid >= 2) & (xm > nxt))
                     | (last & (n_valid >= 2) & (xm > prev)))
    peaks = peaks & (xm >= thr) & (n_valid >= 3) & (mx >= EPSILON)
    if min_distance <= 0:
        return peaks

    # visit peaks from the highest value; equal values in the order interior
    # (ascending), index 0, last index (peak_picking.rs:87-100): two stable
    # sorts, the minor key first
    visit_rank = torch.where(idx == 0, n, torch.where(idx == n_valid - 1, n + 1, idx))
    visit_rank = visit_rank.expand(xm.shape)
    by_rank = torch.sort(visit_rank, dim=-1, stable=True).indices
    key = torch.where(peaks, -xm, float("inf"))
    order = torch.gather(by_rank, -1, torch.sort(torch.gather(key, -1, by_rank), dim=-1,
                                                 stable=True).indices)
    kept = torch.zeros_like(peaks)
    n_peaks = int(peaks.sum(dim=-1).amax()) if peaks.numel() else 0
    for j in range(n_peaks):
        i = order[..., j:j + 1]
        is_peak = torch.gather(peaks, -1, i)
        near = (kept & ((idx - i).abs() < min_distance)).any(dim=-1, keepdim=True)
        kept = kept | ((is_peak & ~near) & (idx == i))
    return kept
