"""Batched, chunked STFT frontend (port of ``stratum_dsp_tpu/ops/stft.py``).

Magnitudes of the Hann-windowed real DFT over a padded ``[B, T]`` batch,
streamed in frame chunks: each chunk's ``[B, C, K]`` magnitudes go straight
into a caller-provided reducer that emits small per-frame features, so the
full spectrogram never exists at once. Two forms, chosen as in the
reference:

* the direct windowed DFT, one matmul of the frames against a fused
  ``[n, 2K]`` cos|sin basis with the symmetric (n-1) Hann window folded in;
* the polyphase shared-block form for frame/hop ratios R >= 16 under the bf16
  pipeline (the 8192/512 key STFT): one per-hop-block DFT matmul, then the
  stage-2 kernel (``ops/polyphase.py``) that twiddles, box-sums R blocks and
  applies the periodic-Hann 3-bin mix.

bf16 matmuls follow the reference's rounding points: operands rounded to
bf16, products accumulated in f32. PyTorch's bf16 ``matmul`` returns bf16, so
the rounded operands are upcast and multiplied in f32.
"""

from __future__ import annotations

import functools
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F

from . import tables
from .polyphase import polyphase_stage2


def num_frames(n_samples: int, frame_size: int, hop: int) -> int:
    """Frame count for a signal of length n (extractor.rs:314)."""
    if n_samples < frame_size:
        return 0
    return (n_samples - frame_size) // hop + 1


def _hann_window_np(frame_size: int) -> np.ndarray:
    i = np.arange(frame_size, dtype=np.float64)
    return (0.5 * (1.0 - np.cos(2.0 * np.pi * i / (frame_size - 1)))).astype(np.float32)


def hann_window(frame_size: int, device=None) -> torch.Tensor:
    """Hann window with the reference's (n-1) denominator (extractor.rs:318),
    shared (``ops/tables.py``)."""
    return tables.on(device, _hann_window_np, frame_size, site="stft.window")


def extract_frames(region: torch.Tensor, n_frames: int, frame_size: int, hop: int):
    """Overlapping frames ``[B, n_frames, frame_size]`` of ``region [B, L]``."""
    return region.unfold(-1, frame_size, hop)[:, :n_frames]


def _exact_phase(a: torch.Tensor, b: torch.Tensor, n: int) -> torch.Tensor:
    """f32 angle 2*pi*((a*b) mod n)/n from an exact integer product."""
    return ((a * b) % n).to(torch.float32) * (2.0 * np.pi / n)


def fused_windowed_basis(n: int, window: torch.Tensor, keep_bins=None, bf16=False):
    """``[n, 2K]`` DFT basis with the window folded in: ``frames @ basis``
    gives ``[re | im]``. With ``bf16`` the basis is stored bf16."""
    k_bins = n // 2 + 1 if keep_bins is None else keep_bins
    dev = window.device
    phase = _exact_phase(torch.arange(n, device=dev)[:, None],
                         torch.arange(k_bins, device=dev)[None, :], n)
    fused = torch.cat([torch.cos(phase), torch.sin(phase)], dim=1) * window[:, None]
    return fused.to(torch.bfloat16) if bf16 else fused


def hann_basis(n: int, keep_bins, bf16: bool, device) -> torch.Tensor:
    """``fused_windowed_basis`` of the (n-1) Hann window on ``device``, made
    through ``ops/tables.py``."""
    return fused_windowed_basis(n, hann_window(n, device), keep_bins, bf16)


def bf16_matmul_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` with operands in ``w``'s dtype (bf16 or f32), accumulated
    and returned in f32."""
    if w.dtype == torch.bfloat16:
        x = x.to(torch.bfloat16).float()
        w = w.float()
    return torch.matmul(x, w)


def stft_magnitude_chunk(frames: torch.Tensor, basis: torch.Tensor) -> torch.Tensor:
    """Windowed DFT magnitudes ``[B, C, K]`` (always f32) of frames [B, C, n]."""
    ri = bf16_matmul_f32(frames, basis)
    k = basis.shape[-1] // 2
    re, im = ri[..., :k], ri[..., k:]
    return torch.sqrt(re * re + im * im)


def _poly_block_basis(n: int, hop: int, kp: int, bf16: bool, device) -> torch.Tensor:
    """[hop, 2*KP] unwindowed DFT basis on the N-point grid, one hop block,
    made through ``ops/tables.py``."""
    phase = _exact_phase(torch.arange(hop, device=device)[:, None],
                         torch.arange(kp, device=device)[None, :], n)
    basis = torch.cat([torch.cos(phase), -torch.sin(phase)], dim=1)
    return basis.to(torch.bfloat16) if bf16 else basis


def poly_num_blocks(ext: int, frame_size: int, hop: int) -> int:
    """Blocks a polyphase chunk of ``ext`` frames consumes, rounded up to R."""
    r = frame_size // hop
    return -(-(ext + r) // r) * r


def polyphase_chunk_magnitudes(samples, start: int, ext: int, frame_size: int, hop: int,
                               keep_bins: int, bf16: bool = True) -> torch.Tensor:
    """Periodic-Hann STFT magnitudes ``[B, ext, keep_bins]`` for frames
    ``[start, start+ext)``; ``start`` must be a multiple of R. Stage 1 is one
    per-block DFT matmul; stage 2 is the kernel of ``ops/polyphase.py``."""
    b = samples.shape[0]
    r = frame_size // hop
    kp = -(-(keep_bins + 1) // 128) * 128  # bin keep_bins feeds the k+1 mix
    ebp = poly_num_blocks(ext, frame_size, hop)
    blocks = samples[:, start * hop:(start + ebp) * hop].reshape(b, ebp, hop)
    basis = tables.on(samples.device, _poly_block_basis, frame_size, hop, kp, bf16)
    bd = bf16_matmul_f32(blocks, basis)
    return polyphase_stage2(bd.to(torch.bfloat16) if bf16 else bd, r, ext, keep_bins)


def use_polyphase(frame_size: int, hop: int, bf16: bool, keep_bins=None) -> bool:
    """The polyphase form is part of the bf16 pipeline (periodic vs symmetric
    Hann) and pays off when >= 16 frames share each block."""
    if not bf16 or frame_size % hop or hop % 128 or (frame_size // hop) < 16:
        return False
    kb = frame_size // 2 + 1 if keep_bins is None else keep_bins
    return -(-(kb + 1) // 128) * 128 <= frame_size


def stft_reduce(samples: torch.Tensor, lengths: torch.Tensor, frame_size: int, hop: int,
                reducer: Callable, carry_init: Callable, chunk_frames: int = 256,
                halo: int = 0, keep_bins=None, bf16: bool = False):
    """Stream the batched STFT in frame chunks through ``reducer``.

    ``reducer(spec, frame_idx, frame_valid, carry) -> (outs, carry)`` gets
    ``spec [B, C + 2*halo, K]`` for frames ``[c*C - halo, (c+1)*C + halo)``
    (out-of-range or beyond-track frames zeroed and marked invalid) and
    returns a dict of ``[B, C, ...]`` arrays for the central C frames.
    Returns ``(outs [B, n_chunks*C, ...], n_frames_padded, frame_counts)``.
    """
    b, t = samples.shape
    nf = max(num_frames(t, frame_size, hop), 1)
    kbins = keep_bins if keep_bins is not None else frame_size // 2 + 1
    poly = use_polyphase(frame_size, hop, bf16, kbins)
    if poly:
        r = frame_size // hop
        chunk_frames = -(-chunk_frames // r) * r  # chunk starts stay = 0 mod R
    n_chunks = -(-nf // chunk_frames)
    nf_padded = n_chunks * chunk_frames
    frame_counts = torch.where(lengths >= frame_size, (lengths - frame_size) // hop + 1, 0)
    ext = chunk_frames + 2 * halo

    # Left-pad by the halo so no chunk slice clamps (the first chunk's
    # central frames stay aligned with their labels, stft.py:482-501).
    lpad = halo * hop
    if poly:
        need = ((n_chunks - 1) * chunk_frames + poly_num_blocks(ext, frame_size, hop) + 1) * hop
    else:
        need = (nf_padded + 2 * halo - 1) * hop + frame_size
    samples = F.pad(samples, (lpad, max(need - (t + lpad), 0)))
    if not poly:
        basis = tables.on(samples.device, hann_basis, frame_size, keep_bins, bf16)

    arange_ext = torch.arange(ext, device=samples.device)
    carry = carry_init(b)
    chunks = []
    for c in range(n_chunks):
        s0 = c * chunk_frames
        if poly:
            spec = polyphase_chunk_magnitudes(samples, s0, ext, frame_size, hop, kbins)
        else:
            region = samples[:, s0 * hop:s0 * hop + (ext - 1) * hop + frame_size]
            spec = stft_magnitude_chunk(extract_frames(region, ext, frame_size, hop), basis)
        fidx = s0 - halo + arange_ext
        fvalid = (fidx[None, :] >= 0) & (fidx[None, :] < frame_counts[:, None])
        spec = torch.where(fvalid[:, :, None], spec, 0.0)
        outs, carry = reducer(spec, fidx, fvalid, carry)
        chunks.append(outs)
    outs = {k: torch.cat([o[k] for o in chunks], dim=1) for k in chunks[0]}
    return outs, nf_padded, frame_counts


def mel_filterbank_matrix(sample_rate: int, n_bins: int, n_mels: int, fmin_hz: float,
                          fmax_hz: float) -> np.ndarray:
    """HTK-mel triangular filterbank ``[n_bins, n_mels]`` with the reference's
    integer-bin triangles (novelty.rs:78-172)."""
    if sample_rate <= 0 or n_bins < 2:
        raise ValueError("invalid mel filterbank params")
    n_mels = max(n_mels, 4)
    nyquist = sample_rate * 0.5
    fmin = min(max(fmin_hz, 0.0), max(nyquist, 1.0))
    fmax = fmax_hz if (np.isfinite(fmax_hz) and fmax_hz > 0.0) else nyquist
    fmax = float(np.clip(fmax, fmin + 1.0, nyquist))
    freq_res = sample_rate / ((n_bins - 1) * 2)

    def mel(f):
        return 2595.0 * np.log10(1.0 + f / 700.0)

    def inv_mel(m):
        return 700.0 * (10.0 ** (m / 2595.0) - 1.0)

    mel_min, mel_max = mel(fmin), mel(fmax)
    step = (mel_max - mel_min) / (n_mels + 1)
    hz_points = inv_mel(mel_min + step * np.arange(n_mels + 2))
    bin_points = np.clip(np.round(hz_points / freq_res).astype(np.int64), 0, n_bins - 1)
    for i in range(1, len(bin_points)):
        if bin_points[i] <= bin_points[i - 1]:
            bin_points[i] = min(bin_points[i - 1] + 1, n_bins - 1)

    w = np.zeros((n_bins, n_mels), dtype=np.float32)
    for m in range(n_mels):
        left, center, right = bin_points[m], bin_points[m + 1], bin_points[m + 2]
        if not (left < center < right):
            continue
        for bb in range(left + 1, center + 1):
            w[bb, m] += (bb - left) / (center - left)
        for bb in range(center, right):
            w[bb, m] += (right - bb) / (right - center)
    return w


@functools.lru_cache(maxsize=64)
def hz_to_bin(freq_hz: float, freq_resolution: float, n_bins: int) -> int:
    """Rounded, clamped Hz -> bin conversion (tempogram.rs:279-289)."""
    if not np.isfinite(freq_hz) or freq_hz <= 0.0 or freq_resolution <= 0.0:
        return 0
    return int(np.clip(round(freq_hz / freq_resolution), 0, max(n_bins - 1, 0)))
