"""Batched audio normalization: Peak / RMS / LUFS (ITU-R BS.1770-4); port of
``stratum_dsp_tpu/preprocessing/normalization.py`` (normalization.rs).

The K-weighting biquad (normalization.rs:112-175) is applied as its truncated
impulse response: a constant-coefficient order-2 IIR decays exponentially
(pole radius ~0.867 at 44.1 kHz), so ``KWEIGHT_FIR_TAPS`` taps reproduce it to
~1e-8 relative. The filter is the reference's blocked Toeplitz product: the
signal in blocks of ``KWEIGHT_FIR_TAPS`` samples, each output block the
product of [previous block | block] with a banded ``[512, 256]`` matrix, as
two f32 matmuls.

Under a mesh's time axis the samples come as a tracks shard's
``parallel.timeblocks.TimeBlocks`` and every measurement runs block by block,
as the JAX partitioner divides it: a partial max or sum per block, then the
max or sum over the blocks on the row's first device, and the gain is applied
to each block on its own device.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .. import tracing
from ..config import NormalizationMethod
from ..ops import masked

EPSILON = 1e-10
LUFS_GATE_THRESHOLD = -70.0
LUFS_BLOCK_DURATION_MS = 400.0
# tail of the impulse response at 256 taps: 3.6e-17 of its peak at 44.1 kHz
KWEIGHT_FIR_TAPS = 256


@functools.lru_cache(maxsize=8)
def k_weighting_coeffs(sample_rate: float) -> Tuple[float, float, float, float, float]:
    """Normalized biquad coefficients (b0, b1, b2, a1, a2) of the K-weighting
    high-pass shelving stage (normalization.rs:131-158)."""
    w0 = 2.0 * math.pi * 1_681.974_5 / sample_rate
    cos_w0 = math.cos(w0)
    sin_w0 = math.sin(w0)
    alpha = sin_w0 / 2.0 * math.sqrt(1.0 / 0.707)
    b0 = (1.0 + cos_w0) / 2.0
    b1 = -(1.0 + cos_w0)
    b2 = (1.0 + cos_w0) / 2.0
    a0 = 1.0 + alpha
    a1 = -2.0 * cos_w0
    a2 = 1.0 - alpha
    return (b0 / a0, b1 / a0, b2 / a0, a1 / a0, a2 / a0)


@functools.lru_cache(maxsize=8)
def k_weighting_fir(sample_rate: float, n_taps: int = KWEIGHT_FIR_TAPS) -> np.ndarray:
    """Truncated impulse response of the K-weighting biquad, computed in
    float64 on the host and rounded to f32."""
    b0, b1, b2, a1, a2 = k_weighting_coeffs(sample_rate)
    h = np.zeros(n_taps, dtype=np.float64)
    x1 = x2 = 0.0
    x = 1.0
    for i in range(n_taps):
        y = b0 * x + x1
        x1 = b1 * x + x2 - a1 * y
        x2 = b2 * x - a2 * y
        h[i] = y
        x = 0.0
    return h.astype(np.float32)


@functools.lru_cache(maxsize=8)
def _k_weighting_toeplitz(sample_rate: float, blk: int = KWEIGHT_FIR_TAPS) -> np.ndarray:
    """Banded Toeplitz matrix ``H [2*blk, blk]`` with
    ``H[p, j] = h[blk + j - p]`` where in range, so that
    ``y_block[i] = [x_block[i-1] | x_block[i]] @ H``."""
    h = k_weighting_fir(sample_rate, blk)
    H = np.zeros((2 * blk, blk), dtype=np.float32)
    p = np.arange(2 * blk)[:, None]
    j = np.arange(blk)[None, :]
    k = blk + j - p
    ok = (k >= 0) & (k < blk)
    H[ok] = h[k[ok]]
    return H


def k_weighting_filter(samples: torch.Tensor, sample_rate: float) -> torch.Tensor:
    """The K-weighting filter over ``[B, T]`` samples (truncated FIR, zero
    initial state), f32. Its output feeds only the LUFS measurement; the gain
    is applied to the raw samples."""
    b, t = samples.shape
    blk = KWEIGHT_FIR_TAPS
    nb = -(-t // blk)
    xb = F.pad(samples, (0, nb * blk - t)).reshape(b, nb, blk)
    with tracing.host_read("loudness.k_weighting"):
        H = torch.as_tensor(_k_weighting_toeplitz(sample_rate, blk), device=samples.device)
    prev = F.pad(xb[:, :-1], (0, 0, 1, 0))
    y = torch.matmul(xb, H[blk:]) + torch.matmul(prev, H[:blk])
    return y.reshape(b, nb * blk)[:, :t]


def calculate_lufs(samples, lengths: torch.Tensor, sample_rate: float) -> torch.Tensor:
    """Integrated LUFS per track (normalization.rs:185-259): K-weighting, the
    mean squares of 400 ms blocks, the -70 LUFS absolute gate, the mean of the
    gated blocks, then -0.691 + 10 log10. -inf where every block lies below
    the gate. ``samples``: a ``[B, T]`` tensor or a ``TimeBlocks``."""
    b, t = samples.shape
    block = int(sample_rate * LUFS_BLOCK_DURATION_MS / 1000.0)
    if not torch.is_tensor(samples):
        return _gated_lufs(_gating_sums_blocks(samples, lengths, sample_rate, block), lengths,
                           block)
    filtered = k_weighting_filter(samples, sample_rate)
    # the FIR's tail leaks past the valid region
    filtered = torch.where(masked.length_mask(lengths, t), filtered, 0.0)

    n_blocks = -(-t // block)
    f2 = F.pad(filtered * filtered, (0, n_blocks * block - t)).reshape(b, n_blocks, block)
    return _gated_lufs(f2.sum(dim=-1), lengths, block)


def _gating_sums_blocks(samples, lengths: torch.Tensor, sample_rate: float,
                        block: int) -> torch.Tensor:
    """The sums of the K-weighted squares over each 400 ms gating block,
    ``[rows, n_blocks]`` on the row's first device, from time blocks: each
    time block filters itself with the FIR's 256 samples of left context
    from its left neighbour (zeros before the first block: the filter's
    initial state), and sums the parts of the gating blocks it holds; a
    gating block that straddles time blocks adds its parts there, in block
    order."""
    taps, tb = KWEIGHT_FIR_TAPS, samples.t_blk

    def part(blk, j):
        ext = samples.context(j, taps, 0) if j else F.pad(blk, (taps, 0))
        y = k_weighting_filter(ext, sample_rate)[:, taps:]
        gidx = j * tb + torch.arange(tb, device=blk.device)
        y = torch.where(gidx[None, :] < lengths.to(blk.device)[:, None], y, 0.0)
        f2 = y * y
        head = min(block - (j * tb) % block, tb)  # the rest of the first gating block
        n_full = (tb - head) // block
        pieces = [f2[:, :head].sum(dim=-1, keepdim=True)]
        if n_full:
            pieces.append(f2[:, head:head + n_full * block].reshape(-1, n_full, block).sum(-1))
        if head + n_full * block < tb:
            pieces.append(f2[:, head + n_full * block:].sum(dim=-1, keepdim=True))
        return torch.cat(pieces, dim=1)

    home = samples.device
    sums = torch.zeros((samples.shape[0], -(-samples.t // block)), device=home)
    for j, p in enumerate(samples.map(part)):
        g0 = j * tb // block
        sums[:, g0:g0 + p.shape[1]] += p.to(home)
    return sums


def _gated_lufs(sums: torch.Tensor, lengths: torch.Tensor, block: int) -> torch.Tensor:
    """Integrated LUFS from the gating blocks' sums of squares ``[B, n_blocks]``."""
    n_blocks = sums.shape[1]
    # full blocks except a possibly short last one over the valid length
    starts = torch.arange(n_blocks, device=sums.device) * block
    counts = (lengths[:, None] - starts[None, :]).clamp(0, block)
    block_valid = counts > 0
    mean_sq = sums / counts.clamp_min(1)

    gate_linear = 10.0 ** ((LUFS_GATE_THRESHOLD + 0.691) / 10.0)
    gated = block_valid & (mean_sq > gate_linear)
    n_gated = gated.sum(dim=-1)
    mean_gated = torch.where(gated, mean_sq, 0.0).sum(dim=-1) / n_gated.clamp_min(1)
    lufs = -0.691 + 10.0 * torch.log10(mean_gated.clamp_min(EPSILON))
    return torch.where(n_gated > 0, lufs, float("-inf"))


def _db(x: torch.Tensor) -> torch.Tensor:
    return 20.0 * torch.log10(x.clamp_min(EPSILON))


def _peak_and_sum_squares(xm) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each row's largest magnitude and sum of squares of zero-padded time
    blocks ``xm``, on the row's first device: per block, then the max
    (exact) and the sum over the blocks in block order."""
    home = xm.device
    parts = [p.to(home) for p in xm.map(
        lambda blk, j: torch.stack([blk.abs().amax(dim=-1), (blk * blk).sum(dim=-1)]))]
    sum_sq = parts[0][1]
    for p in parts[1:]:
        sum_sq = sum_sq + p[1]
    return torch.stack([p[0] for p in parts]).amax(dim=0), sum_sq


def normalize(samples, lengths: torch.Tensor, method: NormalizationMethod,
              sample_rate: float, target_loudness_lufs: float = -14.0,
              max_headroom_db: float = 1.0) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Normalize ``[B, T]`` tracks; returns (samples, metadata). The metadata
    holds ``peak_db``, ``rms_db``, ``gain_db`` and ``measured_lufs`` as [B]
    arrays, -inf where undefined. Silent tracks keep gain 1
    (normalization.rs:275-283); samples beyond a track's length are zeroed.
    ``samples`` may be a tracks shard's ``TimeBlocks``, normalized block by
    block and returned as such."""
    blocked = not torch.is_tensor(samples)
    if blocked:
        xm = samples.masked(lengths)
        peak, sum_sq = _peak_and_sum_squares(xm)
    else:
        valid = masked.length_mask(lengths, samples.shape[1])
        xm = torch.where(valid, samples, 0.0)
        peak, sum_sq = xm.abs().amax(dim=-1), (xm * xm).sum(dim=-1)
    n = lengths.clamp_min(1).to(peak.dtype)
    rms = torch.sqrt(sum_sq / n)
    peak_db = torch.where(peak > EPSILON, _db(peak), float("-inf"))
    safe = peak.clamp_min(EPSILON)
    no_lufs = torch.full_like(peak, float("-inf"))

    target_peak_linear = 10.0 ** ((0.0 - max_headroom_db) / 20.0)
    # never above 1/peak (normalization.rs:295)
    peak_gain = torch.minimum(masked.rdiv(target_peak_linear, safe), masked.rdiv(1.0, safe))

    if method == NormalizationMethod.PEAK:
        gain = torch.where(peak > EPSILON, peak_gain, 1.0)
        measured_lufs = no_lufs
    elif method == NormalizationMethod.RMS:
        # LUFS to approximate RMS dB (normalization.rs:536-538)
        target_rms_linear = 10.0 ** ((target_loudness_lufs + 3.0 - max_headroom_db) / 20.0)
        gain = torch.where(rms > EPSILON,
                           masked.rdiv(target_rms_linear, rms.clamp_min(EPSILON)), 1.0)
        # clip protection: peak * gain <= 1 (normalization.rs:362-379)
        gain = torch.where(peak * gain > 1.0, masked.rdiv(1.0, safe), gain)
        gain = torch.where(rms > EPSILON, gain, 1.0)
        measured_lufs = no_lufs
    elif method == NormalizationMethod.LOUDNESS:
        measured_lufs = calculate_lufs(samples, lengths, sample_rate)
        gain = torch.pow(10.0, masked.cdiv(target_loudness_lufs - measured_lufs, 20.0))
        # clip protection that keeps the headroom (normalization.rs:430-456)
        gain = torch.where(peak * gain > target_peak_linear,
                           masked.rdiv(target_peak_linear, safe), gain)
        # peak normalization where nothing passed the gate
        gain = torch.where(torch.isfinite(measured_lufs), gain, peak_gain)
        gain = torch.where(peak > EPSILON, gain, 1.0)
    else:  # pragma: no cover - exhaustive enum
        raise ValueError(f"unknown normalization method {method}")

    if blocked:
        out = xm.replace(xm.map(lambda blk, j: blk * gain.to(blk.device)[:, None]))
        rms_out = torch.sqrt(_peak_and_sum_squares(out)[1] / n)
    else:
        out = torch.where(valid, samples * gain[:, None], 0.0)
        rms_out = torch.sqrt((out * out).sum(dim=-1) / n)
    meta = {
        "peak_db": peak_db,
        "rms_db": torch.where(rms_out > EPSILON, _db(rms_out), float("-inf")),
        "gain_db": _db(gain),
        "measured_lufs": measured_lufs,
    }
    return out, meta


def normalize_peak(samples: torch.Tensor, lengths: torch.Tensor,
                   max_headroom_db: float = 1.0) -> torch.Tensor:
    """The PEAK branch of ``normalize`` without its metadata."""
    return normalize(samples, lengths, NormalizationMethod.PEAK, 0.0,
                     max_headroom_db=max_headroom_db)[0]
