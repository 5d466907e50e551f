"""Chroma post-processing (port of
``stratum_dsp_tpu/features/chroma/postprocess.py``; chroma/normalization.rs,
smoothing.rs): L2 normalization, sharpening, temporal median and
moving-average smoothing."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ...ops import masked

EPSILON = 1e-10


def l2_normalize_chroma(chroma):
    """Unit-L2 per frame; tiny-norm frames become uniform."""
    norm = torch.sqrt((chroma * chroma).sum(dim=-1, keepdim=True))
    uniform = float(np.float32(1.0) / np.sqrt(np.float32(chroma.shape[-1])))
    return torch.where(norm > EPSILON, chroma / norm.clamp_min(EPSILON), uniform)


def l2_normalize_zero(chroma):
    """Unit-L2 per frame; tiny-norm frames stay zero (the extraction path)."""
    norm = torch.sqrt((chroma * chroma).sum(dim=-1, keepdim=True))
    return torch.where(norm > EPSILON, chroma / norm.clamp_min(EPSILON), 0.0)


def sharpen_chroma(chroma, power: float):
    """Element-wise power + L2 renorm (normalization.rs:41-65)."""
    return l2_normalize_chroma(torch.pow(chroma.clamp_min(0.0), power))


def smooth_chroma_median(chroma, n_frames, window: int):
    """Per-pitch-class temporal median (smoothing.rs:37-94): odd window,
    edges shrink to the valid range, median = sorted element len/2."""
    if window <= 1:
        return chroma
    if window % 2 == 0:
        window += 1
    x = chroma.transpose(-1, -2)  # [B, 12, F]
    out = masked.masked_select_nth_filter_1d(x, n_frames[:, None], window // 2)
    return out.transpose(-1, -2)


def smooth_chroma_average(chroma, n_frames, window: int):
    """Moving-average temporal smoothing (smoothing.rs:109-160): a centered
    window clipped to the valid frame range."""
    if window <= 1:
        return chroma
    if window % 2 == 0:
        window += 1
    half = window // 2
    f = chroma.shape[-2]
    idx = torch.arange(f, device=chroma.device)
    fmask = idx < n_frames[..., None]
    c0 = F.pad(torch.cumsum(torch.where(fmask[..., None], chroma, 0.0), dim=-2), (0, 0, 1, 0))
    lo = (idx - half).clamp(0, f)
    hi = (idx + half + 1).clamp(0, f)
    sums = c0[..., hi, :] - c0[..., lo, :]
    cm0 = F.pad(torch.cumsum(fmask.to(chroma.dtype), dim=-1), (1, 0))
    cnt = cm0[..., hi] - cm0[..., lo]
    return torch.where(fmask[..., None], sums / cnt.clamp_min(1.0)[..., None], chroma)
