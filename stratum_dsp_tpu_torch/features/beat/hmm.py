"""HMM beat tracking on a fixed-capacity grid (port of
``stratum_dsp_tpu/features/beat/hmm.py``, hmm.rs).

Beat slots lie on the nominal beat interval from the phase anchor;
Gaussian emissions (sigma = 25 ms) on the distance to the nearest onset pick
the beats (emission > 0.1, or every slot between the first and last
supported ones with grid fill), confidence 0.7*emission + 0.3*alignment.

The 5-state Viterbi decode runs on the emissions as in the reference
(``ops/viterbi.py``; the CUDA kernel on the card). Its emissions are
state-independent, so the decoded states never change the beats; the beat
grid drops them (grid.py:347), as the reference does.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ... import tracing
from ...ops.masked import cdiv, fma, rdiv, searchsorted_nearest
from ...ops.viterbi import viterbi_decode

TIMING_TOLERANCE_S = 0.05
EMISSION_SIGMA = TIMING_TOLERANCE_S / 2.0
INV_TOLERANCE = float(np.float32(1.0) / np.float32(TIMING_TOLERANCE_S))  # f32, as XLA folds it
EMISSION_THRESHOLD = 0.1
EPSILON = 1e-10
BIG = 1e9


class BeatTensor(NamedTuple):
    """Fixed-capacity beat list."""

    times: torch.Tensor  # [B, MB] seconds
    confidence: torch.Tensor  # [B, MB]
    valid: torch.Tensor  # [B, MB] bool


def track_beats(bpm, onset_times, onset_valid, max_beats: int,
                anchor: Optional[torch.Tensor] = None,
                interval_scale: Optional[torch.Tensor] = None,
                fill: bool = False) -> Tuple[BeatTensor, torch.Tensor]:
    """Track beats for a batch (hmm.rs:122-441). Returns (BeatTensor, the
    Viterbi states [B, max_beats] int32). ``anchor`` [B] overrides the
    first-onset phase anchor; ``interval_scale`` [B] scales the interval.
    Rows with more beat slots than ``max_beats`` are flagged
    (``tracing.flag_capped``), and the slots decoded are counted
    (``viterbi_frames``, ``tracing.count_on_device``)."""
    ok = (bpm > EPSILON) & (bpm <= 300.0) & (onset_valid.sum(dim=-1) >= 1)
    beat_interval = rdiv(60.0, torch.where(ok, bpm, 120.0))
    if interval_scale is not None:
        beat_interval = beat_interval * interval_scale
    start = torch.where(onset_valid, onset_times, BIG).amin(dim=-1)
    end = torch.where(onset_valid, onset_times, -BIG).amax(dim=-1)
    if anchor is not None:
        start = anchor
    start = torch.where(ok, start, 0.0)
    end = torch.where(ok, end, 0.0)
    num_frames = torch.ceil((end - start).clamp_min(0.0) / beat_interval).to(torch.int64) + 1
    tracing.flag_capped(lambda: ok & (num_frames > max_beats))
    num_frames = torch.where(ok, num_frames.clamp_max(max_beats), 0)
    tracing.count_on_device("viterbi_frames", num_frames.sum)

    t_idx = torch.arange(max_beats, device=bpm.device, dtype=torch.float32)
    beat_times = fma(t_idx[None, :], beat_interval[:, None], start[:, None])
    frame_valid = t_idx[None, :] < num_frames[:, None]
    _, dist = searchsorted_nearest(beat_times, torch.where(onset_valid, onset_times, BIG),
                                   onset_valid.sum(dim=-1), BIG)
    emission = torch.exp(cdiv(-(dist * dist), 2.0 * EMISSION_SIGMA * EMISSION_SIGMA))
    emission = torch.where(frame_valid, emission, 0.0)
    states = viterbi_decode(emission)

    supported = frame_valid & (emission > EMISSION_THRESHOLD)
    if fill:
        slot = torch.arange(max_beats, device=bpm.device)
        first_sup = torch.where(supported, slot, max_beats).amin(dim=-1)
        last_sup = torch.where(supported, slot, -1).amax(dim=-1)
        is_beat = frame_valid & (slot >= first_sup[:, None]) & (slot <= last_sup[:, None])
    else:
        is_beat = supported
    # the reference's compiled arithmetic: a reciprocal multiply, and both
    # multiply-adds contracted into FMAs
    align = torch.where(dist < TIMING_TOLERANCE_S,
                        fma(-dist, INV_TOLERANCE, 1.0), 0.0)
    conf = fma(0.7, emission, 0.3 * align).clamp_max(1.0)
    beats = BeatTensor(times=torch.where(is_beat, beat_times, 0.0),
                       confidence=torch.where(is_beat, conf, 0.0), valid=is_beat)
    return beats, states
