"""Key path: streamed 8192/512 key STFT -> harmonic time-mask -> HPCP ->
median smoothing -> frame weighting -> segment voting (port of the default
branch of ``stratum_dsp_tpu/features/key/pipeline.py``, lib.rs:961-1559).

The key STFT streams in frame chunks with a +-margin halo so the time-mask
sees its full context; each chunk emits only [B, C, 12] HPCP and [B, C]
energies. Under the bf16 pipeline the STFT is the polyphase form whose stage
2 is the CUDA kernel of ``ops/polyphase.py``.
"""

from __future__ import annotations

import numpy as np
import torch

from ...config import AnalysisConfig

from ...ops import masked
from ...ops.stft import stft_reduce
from ..chroma import extractor as chx
from ..chroma.postprocess import sharpen_chroma, smooth_chroma_median
from . import detector
from .detector import KeyResult

EPSILON = 1e-12
# Frame-chunk element budget for the streamed key STFT (bounds the
# [B, chunk, frame_size] working set); kept from the reference for now.
CHUNK_ELEMENT_BUDGET = 60_000_000


def _auto_chunk(b: int, frame_size: int, requested: int) -> int:
    return int(min(requested, max(CHUNK_ELEMENT_BUDGET // max(b * frame_size, 1), 128)))


def _key_keep_bins(cfg: AnalysisConfig, sample_rate: int, frame_size: int) -> int:
    """Bins the key STFT keeps: chroma/HPCP read only up to 5 kHz
    (extractor.rs:47-48), so bins [0, ceil(5000 Hz) + 2) — ~930 of 4097."""
    fres = sample_rate / frame_size
    return int(min(np.ceil(5000.0 / fres) + 2, frame_size // 2 + 1))


def extract_key_features(samples, lengths, cfg: AnalysisConfig, sample_rate: int,
                         chunk_frames: int = 512):
    """Stream the key STFT; returns (hpcp [B, F, 12], energy [B, F],
    frame_counts [B]). Conditioning is the harmonic time-mask (the default;
    the other conditioning variants are outside the ported slice)."""
    frame_size, hop = max(cfg.key_stft_frame_size, 256), max(cfg.key_stft_hop_size, 1)
    keep_bins = _key_keep_bins(cfg, sample_rate, frame_size)
    halo = cfg.key_spectrogram_smooth_margin

    def reducer(spec, fidx, fvalid, carry):
        c = spec.shape[1] - 2 * halo
        cond = chx.harmonic_time_mask(torch.where(fvalid[..., None], spec, 0.0), fvalid,
                                      halo, cfg.key_harmonic_mask_power)
        central_valid = fvalid[:, halo:halo + c]
        central = torch.where(central_valid[..., None], cond[:, halo:halo + c, :], 0.0)
        ch = chx.frames_to_hpcp(
            central, sample_rate, frame_size, cfg.soft_mapping_sigma, 0.0,
            cfg.key_hpcp_peaks_per_frame, cfg.key_hpcp_num_harmonics,
            cfg.key_hpcp_harmonic_decay, cfg.key_hpcp_mag_power)
        energy = (central * central).sum(dim=-1)
        return {"chroma": torch.where(central_valid[..., None], ch, 0.0),
                "energy": torch.where(central_valid, energy, 0.0)}, carry

    outs, _, frame_counts = stft_reduce(
        samples, lengths, frame_size, hop, reducer, lambda b: None,
        chunk_frames=_auto_chunk(samples.shape[0], frame_size, chunk_frames), halo=halo,
        keep_bins=keep_bins, bf16=cfg.stft_bf16)
    return outs["chroma"], outs["energy"], frame_counts


def chroma_tonalness(chroma):
    """1 - normalized entropy of the chroma distribution (lib.rs:1236-1254)."""
    s = chroma.sum(dim=-1, keepdim=True)
    p = chroma / s.clamp_min(EPSILON)
    ent = -torch.where(p > EPSILON, p * torch.log(p.clamp_min(EPSILON)), 0.0).sum(dim=-1)
    t = 1.0 - masked.cdiv(ent, float(np.log(12.0)))
    return torch.where(s[..., 0] > EPSILON, t.clamp(0.0, 1.0), 0.0)


def key_frame_weights(chroma, energy, fvalid, cfg: AnalysisConfig):
    """Per-frame weights tonal^tp * (e/median)^ep (lib.rs:1256-1287), falling
    back to unweighted when the sum is ~0 or < 10 frames are usable."""
    if not cfg.enable_key_frame_weighting:
        return None
    med = masked.masked_median(energy, fvalid).clamp_min(EPSILON)
    tonal = chroma_tonalness(chroma)
    tonal = torch.where(tonal < cfg.key_min_tonalness, 0.0, tonal)
    e_norm = (energy / med[..., None]).clamp_min(0.0)
    w = torch.pow(tonal, max(cfg.key_tonalness_power, 0.0)) * torch.pow(
        e_norm, max(cfg.key_energy_power, 0.0))
    w = torch.where(fvalid, w.clamp_min(0.0), 0.0)
    ok = (w.sum(dim=-1, keepdim=True) > EPSILON) & ((w > 0.0).sum(dim=-1, keepdim=True) >= 10)
    return torch.where(ok, w, torch.where(fvalid, 1.0, 0.0))


def detect_key_batch(samples, lengths, cfg: AnalysisConfig, sample_rate: int) -> KeyResult:
    """Key path for a batch (lib.rs:961-1559): extract + condition, sharpen,
    median-smooth, weight, then segment voting (or the full-track detector)."""
    chroma, energy, frame_counts = extract_key_features(samples, lengths, cfg, sample_rate)
    fvalid = masked.length_mask(frame_counts, chroma.shape[1])
    if cfg.chroma_sharpening_power > 1.0:
        chroma = torch.where(fvalid[..., None],
                             sharpen_chroma(chroma, cfg.chroma_sharpening_power), 0.0)
    smoothed = smooth_chroma_median(chroma, frame_counts, 5)
    chroma = torch.where((frame_counts > 5)[:, None, None], smoothed, chroma)
    weights = key_frame_weights(chroma, energy, fvalid, cfg)
    frame_mask = fvalid.to(chroma.dtype)
    if cfg.enable_key_segment_voting:
        res = detector.detect_key_segment_voting(chroma, weights, frame_mask, frame_counts, cfg)
    else:
        res = detector.detect_key_weighted(chroma, weights, frame_mask, cfg)
    ok = frame_counts > 0
    return KeyResult(key_idx=torch.where(ok, res.key_idx, 0),
                     confidence=torch.where(ok, res.confidence, 0.0),
                     clarity=torch.where(ok, res.clarity, 0.0),
                     scores=torch.where(ok[:, None], res.scores, 0.0))
