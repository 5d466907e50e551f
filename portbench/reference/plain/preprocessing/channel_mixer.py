"""Stereo to mono mixdown (port of
``stratum_dsp_tpu/preprocessing/channel_mixer.py``; reference
``preprocessing/channel_mixer.rs:80-144``).

Like the reference, this is not wired into the analysis: callers pre-mix (the
CLI decodes and mixes). Provided for API parity.
"""

from __future__ import annotations

import enum

import torch


class ChannelMixMode(enum.Enum):
    MONO = "mono"  # (L+R)/2
    MID_SIDE = "mid_side"  # mid channel = (L+R)/2
    CENTER = "center"  # (L+R)/2
    DOMINANT = "dominant"  # louder channel per sample


def stereo_to_mono(left, right, mode: ChannelMixMode = ChannelMixMode.MONO) -> torch.Tensor:
    """Mix stereo ``[..., T]`` pairs (tensors or arrays) down to mono, where
    the inputs lie.

    Mono/MidSide/Center are all (L+R)/2 in the reference
    (channel_mixer.rs:104-130); Dominant picks the louder channel per sample
    (channel_mixer.rs:132-144).
    """
    left = torch.as_tensor(left)
    right = torch.as_tensor(right)
    if mode == ChannelMixMode.DOMINANT:
        return torch.where(left.abs() >= right.abs(), left, right)
    return 0.5 * (left + right)
