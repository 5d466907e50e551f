"""Greedy downbeat marking: the plain PyTorch version of the CUDA kernel.

Port of the Pallas TPU kernel ``stratum_dsp_tpu/ops/downbeats_pallas.py``
(``downbeat_mask``) and the scan it replaces in
``features/beat/grid.py:detect_downbeats`` (mod.rs:363-404): over compacted
ascending beat times, the first valid beat is a downbeat and a later beat is
one iff ``|t - (last_downbeat + bar)| <= 0.1 * bar``.

This frozen copy keeps only the plain version: the wrapper calls it on
every device.
"""

from __future__ import annotations

import torch


def downbeat_mask_plain(times: torch.Tensor, n_beats: torch.Tensor, bar: torch.Tensor):
    """Plain PyTorch version: the reference's walk as a loop over slots."""
    n = times.shape[-1]
    tol = bar * 0.1
    last = torch.zeros_like(bar)
    any_db = torch.zeros_like(bar, dtype=torch.bool)
    out = []
    for i in range(n):
        t = times[:, i]
        ok = i < n_beats
        first = ok & ~any_db
        hit = ok & any_db & ((t - (last + bar)).abs() <= tol)
        is_db = first | hit
        last = torch.where(is_db, t, last)
        any_db = any_db | is_db
        out.append(is_db)
    return torch.stack(out, dim=-1)


def downbeat_mask(times: torch.Tensor, n_beats: torch.Tensor, bar: torch.Tensor):
    """Downbeat mask ``[B, N]`` bool for ``times [B, N]`` f32, ``n_beats [B]``
    int, ``bar [B]`` f32 seconds: the plain version on every device."""
    return downbeat_mask_plain(times, n_beats, bar)


