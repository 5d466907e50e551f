"""Energy-flux onset detection (port of
``stratum_dsp_tpu/features/onset/energy_flux.py``, energy_flux.rs:67-243):
frame RMS -> half-wave-rectified derivative -> dB threshold relative to the
max -> local-max peak pick -> min-distance dedup at hop/2."""

from __future__ import annotations

import torch

from ...ops import masked
from ...ops.framesum import frame_rms
from .peaks import dedup_min_distance, peak_mask_1d, peaks_to_positions

EPSILON = 1e-10


def detect_energy_flux_onsets(samples: torch.Tensor, lengths: torch.Tensor, frame_size: int,
                              hop: int, threshold_db: float, max_onsets: int, mesh=None):
    """Onsets as ``(positions [B, K] samples, valid [B, K])``: flux index i
    (frame i -> i+1) maps to sample (i+1)*hop, kept inside the track.

    With a ``(tracks, time)`` ``mesh`` (``samples`` then a tracks shard's
    ``parallel.timeblocks.TimeBlocks``) the frame RMS runs in time blocks;
    the flux and peak logic runs on the gathered ``[B, NF]`` curve."""
    if mesh is not None and "time" in mesh.shape:
        from ...parallel.timeblocks import frame_rms_sharded

        rms, _ = frame_rms_sharded(samples, lengths, frame_size, hop, mesh)
    else:
        rms = frame_rms(samples, lengths, frame_size, hop)
    n_frames = torch.where(lengths >= frame_size, (lengths - frame_size) // hop + 1, 0)
    nf = rms.shape[1]
    flux = (rms[:, 1:] - rms[:, :-1]).clamp_min(0.0)
    fvalid = masked.length_mask((n_frames - 1).clamp_min(0), nf - 1)
    flux = torch.where(fvalid, flux, 0.0)
    max_flux = masked.masked_max(flux, fvalid)
    threshold = max_flux * (10.0 ** (threshold_db / 20.0))
    threshold = torch.where(max_flux > EPSILON, threshold, float("inf"))
    peaks = peak_mask_1d(flux, fvalid, threshold)
    onset_samples = (torch.arange(nf - 1, device=samples.device) + 1) * hop
    peaks = peaks & (onset_samples[None, :] < lengths[:, None])
    pos, valid = peaks_to_positions(peaks, onset_samples, max_onsets)
    valid = valid & dedup_min_distance(pos, valid, hop // 2)
    return torch.where(valid, pos, 0), valid
