"""Novelty-curve extraction (port of the streaming reducer of
``stratum_dsp_tpu/features/period/novelty.py``, novelty.rs).

A reducer plugged into ``ops.stft.stft_reduce`` emits small per-frame
features while the 2048/512 STFT streams by in chunks:

* ``superflux``  [B, F, n_bands] — max-filtered log-flux per band
* ``superflux2`` [B, F, n_bands] — the same at stride 2 (frame f vs f-2),
  for the multi-resolution escalation's hop-1024 curves
* ``energy``     [B, F, n_bands] — band energies (sum |X|^2)
* ``hfc``        [B, F, n_bands] — band HFC (sum k*|X|^2)
* ``mel``        [B, F, n_mels]  — log-mel frames
* ``onset_sflux``[B, F]          — per-frame-max-normalized spectral flux

Every chunk goes through ``ops/novelty.fused_novelty_features`` (the CUDA
kernel on the card, its plain version on the CPU). Flux-type features at
frame f describe the transition f-1 -> f, so the novelty curves are the
arrays shifted left by one with frame_count-1 valid.
"""

from __future__ import annotations

import functools
from typing import Dict

import torch

from ...config import AnalysisConfig

from ...ops import masked
from ...ops.novelty import NoveltyTables, fused_novelty_features, unpack_features
from ...ops.stft import hz_to_bin, mel_filterbank_matrix, stft_reduce

EPSILON = 1e-10


def band_edges(cfg: AnalysisConfig, sample_rate: int, n_bins: int):
    """(name, start, end, weight) for the full/low/mid/high bands
    (tempogram.rs:357-378)."""
    fres = sample_rate / ((n_bins - 1) * 2)
    b0 = min(1, n_bins - 1)
    b_low = max(hz_to_bin(cfg.tempogram_band_low_max_hz, fres, n_bins), b0)
    b_mid = max(hz_to_bin(cfg.tempogram_band_mid_max_hz, fres, n_bins), b_low + 1)
    if cfg.tempogram_band_high_max_hz > 0.0:
        b_hi = max(hz_to_bin(cfg.tempogram_band_high_max_hz, fres, n_bins), b_mid + 1)
    else:
        b_hi = n_bins
    b_hi = min(b_hi, n_bins)
    return [
        ("full", 0, n_bins, cfg.tempogram_band_w_full),
        ("low", b0, b_low, cfg.tempogram_band_w_low),
        ("mid", b_low, b_mid, cfg.tempogram_band_w_mid),
        ("high", b_mid, b_hi, cfg.tempogram_band_w_high),
    ]


def _active_bands(cfg: AnalysisConfig, sample_rate: int, frame_size: int):
    bands = band_edges(cfg, sample_rate, frame_size // 2 + 1)
    return bands if cfg.enable_tempogram_band_fusion else bands[:1]


def active_band_names(cfg: AnalysisConfig, sample_rate: int, frame_size: int):
    """Band names the reducer emits for this config, in feature-axis order."""
    return [name for (name, _, _, _) in _active_bands(cfg, sample_rate, frame_size)]


@functools.lru_cache(maxsize=8)
def novelty_tables(cfg: AnalysisConfig, sample_rate: int, frame_size: int) -> NoveltyTables:
    """The reducer's constant tables for this config, built once in numpy
    (on a device through ``ops/tables.py``)."""
    n_bins = frame_size // 2 + 1
    mel_w = None
    if cfg.enable_tempogram_mel_novelty:
        mel_w = mel_filterbank_matrix(sample_rate, n_bins, cfg.tempogram_mel_n_mels,
                                      cfg.tempogram_mel_fmin_hz, cfg.tempogram_mel_fmax_hz)
    bands = [(s, e) for (_, s, e, _) in _active_bands(cfg, sample_rate, frame_size)]
    return NoveltyTables(tuple(bands), max(cfg.tempogram_superflux_max_filter_bins, 1), mel_w)


def make_bpm_reducer(cfg: AnalysisConfig, sample_rate: int, frame_size: int, device,
                     emit_stride2=None, emit_onset_flux: bool = True):
    """The per-chunk reducer, its carry initializer and the band names.

    ``emit_stride2`` (default: ``cfg.enable_tempogram_multi_resolution``)
    adds the stride-2 SuperFlux the escalation reads; auxiliary passes (the
    hop-256 escalation pass) turn it and ``emit_onset_flux`` off."""
    if emit_stride2 is None:
        emit_stride2 = cfg.enable_tempogram_multi_resolution
    tables = novelty_tables(cfg, sample_rate, frame_size)
    tables.on(device)  # upload the tables before the first chunk
    use_mel = cfg.enable_tempogram_mel_novelty
    flags = dict(emit_stride2=emit_stride2, emit_onset=emit_onset_flux, use_mel=use_mel)

    def reducer(spec, fidx, fvalid, carry):
        spec = spec.to(torch.float32)
        packed = fused_novelty_features(spec, carry, tables, **flags)
        return unpack_features(packed, tables.nb, tables.nm, **flags), spec[:, -2:, :]

    def carry_init(b):
        return torch.zeros((b, 2, tables.n_bins), dtype=torch.float32, device=device)

    return reducer, carry_init, active_band_names(cfg, sample_rate, frame_size)


def compute_bpm_spectral_features(samples, lengths, cfg: AnalysisConfig, sample_rate: int,
                                  frame_size: int, hop: int, chunk_frames: int = 512,
                                  emit_stride2=None, emit_onset_flux: bool = True, *,
                                  chunk_batch=None):
    """Stream the BPM STFT; returns (features, frame_counts [B], n_frames_padded).
    The chunk is capped for the batch ``chunk_batch`` (default: this one; a
    tracks shard passes the whole batch's size)."""
    b = chunk_batch if chunk_batch is not None else samples.shape[0]
    chunk_frames = int(min(chunk_frames, max(60_000_000 // max(b * frame_size, 1), 128)))
    reducer, carry_init, band_names = make_bpm_reducer(
        cfg, sample_rate, frame_size, samples.device, emit_stride2=emit_stride2,
        emit_onset_flux=emit_onset_flux)
    outs, nf_padded, frame_counts = stft_reduce(
        samples, lengths, frame_size, hop, reducer, carry_init,
        chunk_frames=chunk_frames, bf16=cfg.stft_bf16)
    outs["band_names"] = band_names
    return outs, frame_counts, nf_padded


def compute_bpm_features_from_spec(spec, frame_counts, cfg: AnalysisConfig, sample_rate: int,
                                   frame_size: int, emit_stride2=None,
                                   emit_onset_flux: bool = True):
    """The streaming reducer's per-frame features from a whole spectrogram
    ``[B, F, K]`` that already exists (the percussive part of an HPSS): one
    call of the reducer with a zero carry, so on the card one launch of the
    kernel over all F frames."""
    reducer, carry_init, band_names = make_bpm_reducer(
        cfg, sample_rate, frame_size, spec.device, emit_stride2=emit_stride2,
        emit_onset_flux=emit_onset_flux)
    b, f, _ = spec.shape
    fvalid = masked.length_mask(frame_counts, f)
    spec = torch.where(fvalid[..., None], spec, 0.0)
    outs, _ = reducer(spec, torch.arange(f, device=spec.device), fvalid, carry_init(b))
    outs["band_names"] = band_names
    return outs


def decimate_features_2x(features: Dict[str, torch.Tensor], frame_counts):
    """Hop-2H per-frame features from hop-H streamed features: hop-2H frames
    are the even hop-H frames, so energy, HFC and mel decimate by 2 and the
    flux comes from the stride-2 SuperFlux channel (replaces the reference's
    hop-1024 STFT, multi_resolution.rs:237-239). Returns (features, counts)."""
    if "superflux2" not in features:
        raise ValueError("decimate_features_2x: the reducer must emit stride-2 superflux")
    out = {"superflux": features["superflux2"][:, ::2, :],
           "energy": features["energy"][:, ::2, :],
           "hfc": features["hfc"][:, ::2, :]}
    if "band_names" in features:
        out["band_names"] = features["band_names"]
    if "mel" in features:
        out["mel"] = features["mel"][:, ::2, :]
    return out, torch.where(frame_counts > 0, (frame_counts - 1) // 2 + 1, 0)


def mel_superflux_from_frames(mel_frames, nov_mask, max_filter_mels: int):
    """SuperFlux in mel space (novelty.rs:553-609); value i = transition i -> i+1."""
    k = max(max_filter_mels, 1)
    prev_max = masked.max_pool_1d(mel_frames[:, :-1, :], k)
    d = (mel_frames[:, 1:, :] - prev_max).clamp_min(0.0)
    flux = torch.where(nov_mask, torch.sqrt((d * d).sum(dim=-1)), 0.0)
    return masked.normalize_by_max(flux, nov_mask)


def flux_from_values(values, nov_mask):
    """HWR first difference, normalized (novelty.rs:517-544, 744-767)."""
    flux = torch.where(nov_mask, (values[:, 1:] - values[:, :-1]).clamp_min(0.0), 0.0)
    return masked.normalize_by_max(flux, nov_mask)


def combined_novelty_with_params(spectral, energy, hfc, nov_mask, w_spectral: float,
                                 w_energy: float, w_hfc: float, local_mean_window: int,
                                 smooth_window: int):
    """Weighted combination + conditioning (novelty.rs:874-932): normalize ->
    local-mean subtract + HWR -> moving-average smooth -> normalize."""
    ws, we, wh = max(w_spectral, 0.0), max(w_energy, 0.0), max(w_hfc, 0.0)
    wsum = max(ws + we + wh, EPSILON)
    combined = torch.where(nov_mask, masked.cdiv(spectral * ws + energy * we + hfc * wh, wsum), 0.0)
    combined = masked.normalize_by_max(combined, nov_mask)
    if local_mean_window > 1:
        combined = masked.local_mean_subtract(combined, nov_mask, local_mean_window)
    if smooth_window > 1:
        combined = masked.moving_average(combined, nov_mask, smooth_window)
    return masked.normalize_by_max(torch.where(nov_mask, combined, 0.0), nov_mask)


def assemble_novelty_curves(features: Dict[str, torch.Tensor], frame_counts, cfg: AnalysisConfig):
    """Tempogram novelty variants from streamed features. Returns (curves
    name -> [B, N], nov_mask [B, N], n_valid [B]) with N = frames - 1."""
    n_valid = (frame_counts - 1).clamp_min(0)
    n = features["superflux"].shape[1] - 1
    nov_mask = masked.length_mask(n_valid, n)
    curves = {}
    for bi, name in enumerate(features["band_names"]):
        sf = features["superflux"][:, 1:, bi]
        sf = masked.normalize_by_max(torch.where(nov_mask, sf, 0.0), nov_mask)
        en = flux_from_values(features["energy"][:, :, bi], nov_mask)
        hf = flux_from_values(features["hfc"][:, :, bi], nov_mask)
        curves[name] = combined_novelty_with_params(
            sf, en, hf, nov_mask, cfg.tempogram_novelty_w_spectral,
            cfg.tempogram_novelty_w_energy, cfg.tempogram_novelty_w_hfc,
            cfg.tempogram_novelty_local_mean_window, cfg.tempogram_novelty_smooth_window)
    if cfg.enable_tempogram_mel_novelty and "mel" in features:
        curves["mel"] = mel_superflux_from_frames(features["mel"], nov_mask,
                                                  cfg.tempogram_mel_max_filter_bins)
    return curves, nov_mask, n_valid
