"""Harmonic/percussive source separation by median filters (port of
``stratum_dsp_tpu/features/onset/hpss.py``, hpss.rs:71-243): the harmonic
estimate is median-filtered along time, the percussive one along frequency,
and both are soft-masked so that H + P == |X|. Ten iterations, no early exit.

Each iteration takes a (2 * margin + 1)-wide median per spectrogram cell on
both axes, on ``[B, F, K]`` as it lies: on the card each is one launch of
``ops.masked.window_median``'s kernel.
"""

from __future__ import annotations

import torch

from ...ops import masked

DEFAULT_ITERATIONS = 10
EPSILON = 1e-10


def hpss_decompose(spec: torch.Tensor, frame_counts: torch.Tensor, margin: int,
                   iterations: int = DEFAULT_ITERATIONS):
    """Decompose ``spec [B, F, K]`` into (harmonic, percussive) of the same
    shape. ``frame_counts [B]`` bounds each track's window on the time axis."""
    harmonic = percussive = spec
    for _ in range(iterations):
        h = masked.masked_median_filter_1d(harmonic, frame_counts, margin, dim=1)
        p = masked.median_filter_1d(percussive, margin)
        # soft-mask reconstruction (hpss.rs:131-151)
        total = h + p
        ratio_h = torch.where(total > EPSILON, h / total.clamp_min(EPSILON), 0.5)
        del h, p, total
        harmonic = spec * ratio_h
        percussive = spec * (1.0 - ratio_h)
    return harmonic, percussive


def percussive_energy_flux(percussive: torch.Tensor, frame_counts: torch.Tensor):
    """Per-frame percussive energy (sum |P|^2) and its half-wave rectified
    flux (hpss.rs:300-320): (flux [B, F-1], n_valid [B])."""
    percussive = percussive.to(torch.float32)
    energy = (percussive * percussive).sum(dim=-1)
    energy = torch.where(masked.length_mask(frame_counts, energy.shape[-1]), energy, 0.0)
    flux = (energy[:, 1:] - energy[:, :-1]).clamp_min(0.0)
    return flux, (frame_counts - 1).clamp_min(0)
