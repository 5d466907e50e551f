"""Onset consensus voting (port of
``stratum_dsp_tpu/features/onset/consensus.py``, consensus.rs:111-287).

The time-sorted union of every method's onsets splits into clusters at gaps
larger than the tolerance; per cluster: the integer-mean center, the summed
method weights and the number of distinct voting methods.

Segment sums are integer ``scatter_add`` (exact, so independent of the order
CUDA's atomics take); the weight sum is built from the per-method integer
counts, which keeps it independent of summation order as well.
"""

from __future__ import annotations

from typing import Sequence

import torch

from ... import tracing

INT_BIG = 2**31 - 1


def _seg_sum(vals: torch.Tensor, ids: torch.Tensor, n: int) -> torch.Tensor:
    return torch.zeros(vals.shape[0], n, dtype=vals.dtype, device=vals.device).scatter_add_(
        1, ids, vals)


def vote_onsets(method_positions: Sequence[torch.Tensor], method_valids: Sequence[torch.Tensor],
                weights: Sequence[float], tolerance_ms: int, sample_rate: int):
    """Cluster + vote over methods' ``(positions [B, K_m], valid [B, K_m])``.
    Returns centers/confidence/voted_by/valid, each ``[B, sum K_m]``."""
    n_methods = len(weights)
    tol = int(tolerance_ms / 1000.0 * sample_rate)
    pos = torch.cat([torch.where(v, p, INT_BIG) for p, v in zip(method_positions, method_valids)],
                    dim=-1)
    method_id = torch.cat([torch.full_like(p, m) for m, p in enumerate(method_positions)], dim=-1)
    valid = torch.cat(list(method_valids), dim=-1)
    b, c = pos.shape

    pos, order = torch.sort(pos, dim=-1, stable=True)
    method_id = torch.gather(method_id, 1, order)
    valid = torch.gather(valid, 1, order)

    prev = torch.cat([torch.full_like(pos[:, :1], -(2**30)), pos[:, :-1]], dim=-1)
    boundary = ((pos - prev) > tol) | (torch.arange(c, device=pos.device) == 0)
    seg = torch.cumsum(boundary.to(torch.int64), dim=-1) - 1
    seg_first_entry = torch.cummax(torch.where(boundary, pos, -(2**30)), dim=1).values
    rel = pos - seg_first_entry

    ones = valid.to(torch.int64)
    counts = _seg_sum(ones, seg, c)
    rel_sum = _seg_sum(torch.where(valid, rel, 0), seg, c)
    seg_first = _seg_sum(torch.where(boundary & valid, pos, 0), seg, c)
    voted = torch.stack([_seg_sum(ones * (method_id == m), seg, c) for m in range(n_methods)],
                        dim=-1)  # [B, C, M] member counts per method
    voted_by = (voted > 0).sum(dim=-1)
    w_sum = torch.zeros((b, c), dtype=torch.float32, device=pos.device)
    for m in range(n_methods):
        w_sum = w_sum + float(weights[m]) * voted[..., m].to(torch.float32)

    cluster_valid = counts > 0
    centers = torch.where(cluster_valid, seg_first + rel_sum // counts.clamp_min(1), 0)
    max_weight = float(sum(weights))
    confidence = ((w_sum / max_weight).clamp(0.0, 1.0) if max_weight > 0
                  else torch.zeros_like(w_sum))
    return {
        "centers": centers,
        "confidence": torch.where(cluster_valid, confidence, 0.0),
        "voted_by": torch.where(cluster_valid, voted_by, 0),
        "valid": cluster_valid,
    }


def consensus_onsets(vote: dict, max_onsets: int):
    """Clusters with >= 2 voting methods when a track has any, else all
    clusters (lib.rs:259-285); time-sorted ``(positions [B, K], valid)``;
    rows with more chosen clusters are flagged (``tracing.flag_capped``)."""
    centers, valid, voted_by = vote["centers"], vote["valid"], vote["voted_by"]
    strong = valid & (voted_by >= 2)
    chosen = torch.where(strong.any(dim=-1, keepdim=True), strong, valid)
    tracing.flag_capped(lambda: chosen.sum(dim=-1) > max_onsets)
    s = torch.sort(torch.where(chosen, centers, INT_BIG), dim=-1).values[:, :max_onsets]
    return torch.where(s == INT_BIG, 0, s), s != INT_BIG
