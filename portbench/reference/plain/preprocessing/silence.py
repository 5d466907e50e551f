"""Silence detection and trimming (port of
``stratum_dsp_tpu/preprocessing/silence.py``, silence.rs:102-279).

Frame RMS with 50% overlap against a dB threshold; leading and trailing
silence is trimmed by shifting each track's content to index 0 and
shortening its length, so the batch keeps its shape.
"""

from __future__ import annotations

import torch

from ..ops import masked
from ..ops.framesum import frame_rms


def detect_and_trim(samples: torch.Tensor, lengths: torch.Tensor, sample_rate: int,
                    threshold_db: float = -40.0, frame_size: int = 2048, mesh=None):
    """Trim leading/trailing silence. Returns (samples [B, T], new_lengths
    [B], info) with info ``trim_start``, ``trim_end``, ``all_silent``.

    A frame is silent iff its RMS <= 10^(dB/20); trim_start is the start of
    the first loud frame when the track opens silent, trim_end the start of
    the trailing silent run; an all-silent track gets length 0.

    With a ``(tracks, time)`` ``mesh``, ``samples`` is a tracks shard's
    ``parallel.timeblocks.TimeBlocks``: the frame RMS runs in time blocks
    (``T // hop`` frames) and the result comes back as blocks, in the JAX
    package's tiers: unchanged where no track trims, each block masked where
    only trailing silence trims, and shifted block by block
    (``TimeBlocks.shifted``) where any track has leading silence.
    """
    b, t = samples.shape
    hop = frame_size // 2  # 50% overlap
    if mesh is not None and "time" in mesh.shape:
        from ..parallel.timeblocks import frame_rms_sharded

        rms, _ = frame_rms_sharded(samples, lengths, frame_size, hop, mesh)
    else:
        rms = frame_rms(samples, lengths, frame_size, hop)
    n_frames = torch.where(lengths >= frame_size, (lengths - frame_size) // hop + 1,
                           lengths.clamp_max(1))
    nf = rms.shape[1]
    fvalid = masked.length_mask(n_frames, nf)
    silent = (rms <= 10.0 ** (threshold_db / 20.0)) & fvalid
    loud = ~silent & fvalid

    idx = torch.arange(nf, device=samples.device)
    any_loud = loud.any(dim=-1)
    first_loud = torch.where(loud, idx, nf).amin(dim=-1)
    last_loud = torch.where(loud, idx, -1).amax(dim=-1)

    trim_start = torch.where(silent[:, 0] & any_loud, first_loud * hop, 0)
    last_idx = (n_frames - 1).clamp_min(0)
    last_frame_silent = torch.gather(silent, 1, last_idx[:, None])[:, 0]
    trailing_start_frame = torch.minimum(last_loud + 1, last_idx)
    trim_end = torch.where(last_frame_silent & any_loud, trailing_start_frame * hop, lengths)
    trim_end = torch.minimum(trim_end, lengths)
    trim_start = torch.where(any_loud, trim_start, 0)
    trim_end = torch.where(any_loud, trim_end, 0)
    trim_start = torch.minimum(trim_start, trim_end)
    new_lengths = trim_end - trim_start

    info = {"trim_start": trim_start, "trim_end": trim_end, "all_silent": ~any_loud}
    # Shift each track's kept region to index 0 (one host read of B offsets).
    if not torch.is_tensor(samples):
        starts, kept, full = torch.stack([trim_start, new_lengths, lengths]).tolist()
        if any(starts):
            return samples.shifted(starts, kept), new_lengths, info
        if kept != full:
            return samples.masked(new_lengths), new_lengths, info
        return samples, new_lengths, info
    out = torch.zeros_like(samples)
    for i, (st, n) in enumerate(zip(trim_start.tolist(), new_lengths.tolist())):
        out[i, :n] = samples[i, st:st + n]
    return out, new_lengths, info
