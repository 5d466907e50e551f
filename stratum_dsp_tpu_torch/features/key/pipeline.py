"""Key path: streamed key STFT -> conditioning -> chroma / HPCP -> frame
weighting -> detection (port of ``stratum_dsp_tpu/features/key/pipeline.py``,
lib.rs:961-1559).

The key STFT (8192/512 by default) streams in frame chunks with a +-margin
halo, so that the harmonic time-mask or the time smoothing sees its full
context; each chunk emits only [B, C, 12] chroma and [B, C] energies. Under
the bf16 pipeline the 8192/512 STFT is the polyphase form whose stage 2 is the
CUDA kernel of ``ops/polyphase.py``; tuning compensation and the HPSS harmonic
mask each stream it once more, before the extraction pass.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ... import tracing
from ...config import AnalysisConfig

from ...ops import masked, tables
from ...ops.stft import stft_reduce
from ..chroma import extractor as chx
from ..chroma.postprocess import l2_normalize_zero, sharpen_chroma, smooth_chroma_median
from . import detector
from .detector import KeyResult

EPSILON = 1e-12
# Frame-chunk element budget for the streamed key STFT (bounds the
# [B, chunk, frame_size] working set); kept from the reference for now.
CHUNK_ELEMENT_BUDGET = 60_000_000


def _auto_chunk(b: int, frame_size: int, requested: int) -> int:
    return int(min(requested, max(CHUNK_ELEMENT_BUDGET // max(b * frame_size, 1), 128)))


def _key_keep_bins(cfg: AnalysisConfig, sample_rate: int, frame_size: int):
    """Bins the key STFT keeps: chroma/HPCP read only up to 5 kHz
    (extractor.rs:47-48), so bins [0, ceil(5000 Hz) + 2) (~930 of 4097 at
    8192 / 44.1 kHz); the per-frame energy of the frame weighting sums that
    band. None (all bins) under log-frequency."""
    if cfg.enable_key_log_frequency:
        return None
    fres = sample_rate / frame_size
    return int(min(np.ceil(5000.0 / fres) + 2, frame_size // 2 + 1))


def _key_stft_params(cfg: AnalysisConfig):
    frame_size = cfg.key_stft_frame_size if cfg.enable_key_stft_override else cfg.frame_size
    hop = cfg.key_stft_hop_size if cfg.enable_key_stft_override else cfg.hop_size
    return max(frame_size, 256), max(hop, 1)


def _key_halo(cfg: AnalysisConfig) -> int:
    """Context frames a chunk needs on each side: the smoothing margin while
    the time-mask or the time smoothing conditions the chunk, else none."""
    conditioned = cfg.enable_key_harmonic_mask or cfg.enable_key_spectrogram_time_smoothing
    return cfg.key_spectrogram_smooth_margin if (
        conditioned and not cfg.enable_key_hpss_harmonic) else 0


def _condition_chunk(spec, fvalid, cfg: AnalysisConfig):
    """The configured conditioning of an extended chunk (lib.rs:1012-1062);
    the caller slices out the central frames. Invalid frames are zeroed first:
    the windowed mean's box sums need that."""
    spec = torch.where(fvalid[..., None], spec, 0.0)
    if cfg.enable_key_harmonic_mask and not cfg.enable_key_hpss_harmonic:
        return chx.harmonic_time_mask(spec, fvalid, cfg.key_spectrogram_smooth_margin,
                                      cfg.key_harmonic_mask_power)
    if cfg.enable_key_spectrogram_time_smoothing and not cfg.enable_key_hpss_harmonic:
        return chx.windowed_time_mean(spec.to(torch.float32), fvalid,
                                      cfg.key_spectrogram_smooth_margin)
    return spec


def _stream_key_stft(samples, lengths, cfg: AnalysisConfig, sample_rate: int, reducer,
                     halo: int, chunk_frames: int, mesh):
    """The key STFT streamed through ``reducer``: in time blocks under a
    ``(tracks, time)`` mesh (``samples`` then a tracks shard's
    ``parallel.timeblocks.TimeBlocks``), where it is the direct windowed DFT (a
    symmetric Hann, as the JAX package's time-sharded path computes it),
    else by ``stft_reduce`` (the polyphase form under bf16).

    Counts one ``key_stft_passes`` a call and one ``key_stft_chunks`` a chunk
    it streams, on the innermost open span (``key.tuning``, ``key.hpss_mask``
    or ``key.stft``)."""
    frame_size, hop = _key_stft_params(cfg)
    chunk = _auto_chunk(samples.shape[0], frame_size, chunk_frames)
    keep_bins = _key_keep_bins(cfg, sample_rate, frame_size)
    tracing.count("key_stft_passes")

    def counted(spec, fidx, fvalid, carry):
        tracing.count("key_stft_chunks")
        return reducer(spec, fidx, fvalid, carry)

    if mesh is not None and "time" in mesh.shape:
        from ...parallel.timeblocks import stft_reduce_sharded

        return stft_reduce_sharded(samples, lengths, frame_size, hop, counted, lambda b: None,
                                   mesh, prev_frames=0, halo_frames=halo, keep_bins=keep_bins,
                                   chunk_frames=chunk, bf16=cfg.stft_bf16)
    return stft_reduce(samples, lengths, frame_size, hop, counted, lambda b: None,
                       chunk_frames=chunk, halo=halo, keep_bins=keep_bins, bf16=cfg.stft_bf16)


def _device_copies(**tensors):
    """A getter of ``tensors`` (tensors or other values) copied once to each
    device, where time blocks of the key STFT lie on other devices than the
    batch: a call's own data (the per-track tuning and its projection, the
    HPSS mask). Constants come from ``ops/tables.py``."""
    copies = {}

    def on(device):
        key = str(device)
        if key not in copies:
            copies[key] = {k: v.to(device) if torch.is_tensor(v) else v
                           for k, v in tensors.items()}
        return copies[key]

    return on


def estimate_tuning_streamed(samples, lengths, cfg: AnalysisConfig, sample_rate: int,
                             chunk_frames: int = 512, mesh=None) -> torch.Tensor:
    """Tuning estimate over the conditioned key spectrogram, streamed
    (lib.rs:1090-1110): partial circular sums per chunk, combined at the end.
    Returns per-track offsets [B] clamped to +-key_tuning_max_abs_semitones."""
    frame_size, _ = _key_stft_params(cfg)
    keep_bins = _key_keep_bins(cfg, sample_rate, frame_size)
    halo = _key_halo(cfg)
    n_bins = keep_bins if keep_bins is not None else frame_size // 2 + 1
    fmin, fmax = 80.0, float(np.clip(2000.0, 81.0, sample_rate / 2))
    step = max(cfg.key_tuning_frame_step, 1)
    thr_rel = float(np.clip(cfg.key_tuning_peak_rel_threshold, 0.0, 1.0))

    def reducer(spec, fidx, fvalid, carry):
        in_band = tables.on(spec.device, chx.band_mask, sample_rate, frame_size, n_bins, fmin,
                            fmax, site="tuning.in_band")
        r_sin, r_cos = tables.on(spec.device, chx.tuning_residual_sin_cos, sample_rate,
                                 frame_size, n_bins)
        cond = _condition_chunk(spec, fvalid, cfg)
        c = spec.shape[1] - 2 * halo
        central = cond[:, halo:halo + c, :].clamp_min(0.0)
        use_frame = fvalid[:, halo:halo + c] & ((fidx[halo:halo + c] % step) == 0)[None, :]
        x = central * in_band
        peak = x.amax(dim=-1, keepdim=True)
        sel = use_frame[..., None] & (x >= peak * thr_rel) & (peak > 1e-12) & in_band
        w = torch.where(sel, torch.sqrt(x), 0.0).to(torch.float32)
        return {"sin": (w * r_sin).sum(dim=-1), "cos": (w * r_cos).sum(dim=-1),
                "w": w.sum(dim=-1)}, carry

    outs, _, _ = _stream_key_stft(samples, lengths, cfg, sample_rate, reducer, halo,
                                  chunk_frames, mesh)
    delta = chx.circular_mean_offset(outs["sin"].sum(dim=-1), outs["cos"].sum(dim=-1),
                                     outs["w"].sum(dim=-1))
    m = abs(cfg.key_tuning_max_abs_semitones)
    return delta.clamp(-m, m)


@dataclasses.dataclass
class HpssMask:
    """The harmonic mask of ``collect_hpss_mask``: ``mask_ds [B, n_ds, band]``
    for bins ``[bin_start, bin_end)`` at every ``step``-th frame."""

    mask_ds: torch.Tensor
    bin_start: int
    bin_end: int
    step: int


def collect_hpss_mask(samples, lengths, cfg: AnalysisConfig, sample_rate: int,
                      chunk_frames: int = 512, mesh=None) -> HpssMask:
    """First pass of the key HPSS median-mask path (extractor.rs:1369-1501):
    collect the band-limited spectrogram, downsample it in time and compute
    the harmonic soft mask on it."""
    frame_size, _ = _key_stft_params(cfg)
    n_bins = frame_size // 2 + 1
    fres = sample_rate / frame_size
    fmin, fmax = 100.0, float(np.clip(5000.0, 101.0, sample_rate / 2))
    bin_start = int(np.clip(np.floor(fmin / fres), 0, n_bins))
    bin_end = int(np.clip(np.ceil(fmax / fres), 0, n_bins))
    step = max(cfg.key_hpss_frame_step, 1)

    def reducer(spec, fidx, fvalid, carry):
        # every step-th frame is all the mask reads (chunk starts need not be
        # multiples of step)
        keep = (fidx % step) == 0
        band = spec[:, keep, bin_start:bin_end]
        return {"band": torch.where(fvalid[:, keep, None], band, 0.0)}, carry

    outs, _, frame_counts = _stream_key_stft(samples, lengths, cfg, sample_rate, reducer, 0,
                                             chunk_frames, mesh)
    ds_counts = -(-frame_counts // step)  # frames 0, step, 2 step, ...
    mask_ds = chx.hpss_median_mask_downsampled(
        outs["band"], ds_counts, cfg.key_hpss_time_margin, cfg.key_hpss_freq_margin,
        cfg.key_hpss_mask_power)
    return HpssMask(mask_ds, bin_start, bin_end, step)


def _hpcp(central, cfg: AnalysisConfig, sample_rate: int, frame_size: int, tuning_offset,
          peaks_per_frame: int, **band):
    return chx.frames_to_hpcp(
        central, sample_rate, frame_size, cfg.soft_mapping_sigma, tuning_offset, peaks_per_frame,
        cfg.key_hpcp_num_harmonics, cfg.key_hpcp_harmonic_decay, cfg.key_hpcp_mag_power,
        cfg.enable_key_hpcp_whitening, cfg.key_hpcp_whitening_smooth_bins,
        approx_peaks=cfg.key_hpcp_approx_peaks, **band)


def _log_frequency_tables(sample_rate: int, frame_size: int) -> dict:
    lproj, s_min = chx.log_frequency_projection(sample_rate, frame_size, 100.0, 5000.0)
    return {"log_proj": lproj, "fold_m": chx.semitone_fold_matrix(lproj.shape[1], s_min)}


def _chroma_projection(sample_rate: int, frame_size: int, soft: bool, sigma: float,
                       tuning: float, keep_bins) -> np.ndarray:
    return chx.chroma_projection_matrix(sample_rate, frame_size, soft, sigma, tuning)[:keep_bins]


def extract_key_features(samples, lengths, cfg: AnalysisConfig, sample_rate: int,
                         tuning_offset=0.0, hpss_mask: HpssMask = None,
                         chunk_frames: int = 512, mesh=None):
    """Stream the key STFT; returns (chroma [B, F, 12], energy [B, F],
    frame_counts [B]). ``tuning_offset`` is a float or per-track offsets [B];
    ``hpss_mask`` is the mask of ``collect_hpss_mask`` for the HPSS path."""
    frame_size, _ = _key_stft_params(cfg)
    keep_bins = _key_keep_bins(cfg, sample_rate, frame_size)
    halo = _key_halo(cfg)
    per_track_tuning = torch.is_tensor(tuning_offset)
    proj = None
    if per_track_tuning and not (cfg.enable_key_log_frequency or cfg.enable_key_hpcp):
        proj = chx.chroma_projection_dynamic(sample_rate, frame_size, cfg.soft_chroma_mapping,
                                             cfg.soft_mapping_sigma, tuning_offset)
        proj = proj[..., :keep_bins, :]
    copies = _device_copies(proj=proj, tuning=tuning_offset,
                            mask_ds=hpss_mask.mask_ds if hpss_mask is not None else None)

    def constants(device) -> dict:
        if cfg.enable_key_log_frequency:
            return tables.on(device, _log_frequency_tables, sample_rate, frame_size,
                             site="key.log_frequency")
        if cfg.enable_key_hpcp or per_track_tuning:
            return {}
        return {"proj": tables.on(device, _chroma_projection, sample_rate, frame_size,
                                  cfg.soft_chroma_mapping, cfg.soft_mapping_sigma,
                                  float(tuning_offset), keep_bins, site="key.chroma_projection")}

    def reducer(spec, fidx, fvalid, carry):
        k = copies(spec.device) | constants(spec.device)
        tuning = k["tuning"]
        cond = _condition_chunk(spec, fvalid, cfg)
        c = spec.shape[1] - 2 * halo
        central_valid = fvalid[:, halo:halo + c]
        central = torch.where(central_valid[..., None], cond[:, halo:halo + c, :], 0.0)

        if hpss_mask is not None:
            # the downsampled harmonic mask; bins outside its band are zeroed
            # (extractor.rs:1478-1498)
            k_idx = (fidx[halo:halo + c] // hpss_mask.step).clamp(0, k["mask_ds"].shape[1] - 1)
            full_m = torch.zeros(central.shape, dtype=torch.float32, device=spec.device)
            full_m[..., hpss_mask.bin_start:hpss_mask.bin_end] = k["mask_ds"][:, k_idx]
            central = central.clamp_min(0.0) * full_m

        if cfg.enable_key_log_frequency:
            logspec = torch.matmul(central.to(torch.float32), k["log_proj"])
            ch = torch.matmul(logspec, k["fold_m"])
            ch = torch.where(logspec.sum(dim=-1, keepdim=True) > 0, l2_normalize_zero(ch), 0.0)
            energy = (logspec * logspec).sum(dim=-1)
        else:
            if not cfg.enable_key_hpcp:
                ch = chx.frames_to_chroma(central, k["proj"])
            elif cfg.enable_key_hpcp_bass_blend:
                full = _hpcp(central, cfg, sample_rate, frame_size, tuning,
                             cfg.key_hpcp_peaks_per_frame)
                bass = _hpcp(central, cfg, sample_rate, frame_size, tuning,
                             int(np.clip(cfg.key_hpcp_peaks_per_frame, 1, 12)),
                             fmin_hz=cfg.key_hpcp_bass_fmin_hz, fmax_hz=cfg.key_hpcp_bass_fmax_hz)
                w = float(np.clip(cfg.key_hpcp_bass_weight, 0.0, 1.0))
                ch = l2_normalize_zero((1.0 - w) * full + w * bass)
            else:
                ch = _hpcp(central, cfg, sample_rate, frame_size, tuning,
                           cfg.key_hpcp_peaks_per_frame)
            ce = central.to(torch.float32)
            energy = (ce * ce).sum(dim=-1)
        return {"chroma": torch.where(central_valid[..., None], ch, 0.0),
                "energy": torch.where(central_valid, energy, 0.0)}, carry

    outs, _, frame_counts = _stream_key_stft(samples, lengths, cfg, sample_rate, reducer, halo,
                                             chunk_frames, mesh)
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


def _shift_frames(x: torch.Tensor, start: torch.Tensor) -> torch.Tensor:
    """Row b of ``x [B, F, ...]`` moved left by ``start[b]`` frames, zeros
    coming in at the end."""
    f = x.shape[1]
    idx = torch.arange(f, device=x.device)[None, :] + start[:, None]
    idx = idx.reshape(idx.shape + (1,) * (x.dim() - 2))
    padded = torch.cat([x, torch.zeros_like(x)], dim=1)
    return torch.gather(padded, 1, idx.expand(x.shape))


def detect_key_batch(samples, lengths, cfg: AnalysisConfig, sample_rate: int,
                     beat_times=None, beat_valid=None, mesh=None, *,
                     chunk_batch=None) -> KeyResult:
    """Key path for a batch (lib.rs:961-1559): the optional tuning, HPSS and
    beat-synchronous pre-passes, extract and condition, sharpen, median-smooth,
    weight, then the configured detector. ``mesh``: every key STFT pass in
    time blocks (``_stream_key_stft``); ``chunk_batch``: the batch its
    chunks are sized for (default: this one; a tracks shard passes the whole
    batch's size, whose chunk is never larger than its own)."""
    b = chunk_batch if chunk_batch is not None else samples.shape[0]
    stream = dict(mesh=mesh, chunk_frames=_auto_chunk(b, _key_stft_params(cfg)[0], 512))
    tuning = 0.0
    if cfg.enable_key_tuning_compensation and not cfg.enable_key_log_frequency:
        with tracing.span("key.tuning"):
            tuning = estimate_tuning_streamed(samples, lengths, cfg, sample_rate, **stream)
    hpss_mask = None
    if cfg.enable_key_hpss_harmonic:
        with tracing.span("key.hpss_mask"):
            hpss_mask = collect_hpss_mask(samples, lengths, cfg, sample_rate, **stream)

    beat_sync = (cfg.enable_key_beat_synchronous and not cfg.enable_key_log_frequency
                 and beat_times is not None)
    with tracing.span("key.stft"):
        # per-frame plain chroma, not HPCP, for the beat-synchronous path
        # (extractor.rs:884-891)
        chroma, energy, frame_counts = extract_key_features(
            samples, lengths, cfg.replace(enable_key_hpcp=False) if beat_sync else cfg,
            sample_rate, tuning, hpss_mask, **stream)
    with tracing.span("key.chroma"):
        if beat_sync:
            frame_rate = sample_rate / _key_stft_params(cfg)[1]
            fval = masked.length_mask(frame_counts, chroma.shape[1])
            chroma, energy, interval_valid = chx.beat_synchronous_chroma(
                chroma, energy, fval, beat_times, beat_valid, frame_rate)
            # the intervals become the frames, the valid ones first
            frame_counts = interval_valid.sum(dim=-1)
            order = torch.sort((~interval_valid).to(torch.uint8), dim=-1, stable=True).indices
            chroma = torch.gather(chroma, 1, order[..., None].expand(chroma.shape))
            energy = torch.gather(energy, 1, order)
        f = chroma.shape[1]
        fvalid = masked.length_mask(frame_counts, f)
        if cfg.chroma_sharpening_power > 1.0:
            chroma = torch.where(fvalid[..., None],
                                 sharpen_chroma(chroma, cfg.chroma_sharpening_power), 0.0)
        # temporal median, window 5, only with more than 5 frames (lib.rs:1211-1213)
        smoothed = smooth_chroma_median(chroma, frame_counts, 5)
        chroma = torch.where((frame_counts > 5)[:, None, None], smoothed, chroma)

        if cfg.enable_key_edge_trim:
            frac = float(np.clip(cfg.key_edge_trim_fraction, 0.0, 0.49))
            n = frame_counts.to(torch.float32)
            start = torch.round(n * frac).to(torch.int64)
            end = torch.round(n * (1.0 - frac)).to(torch.int64)
            do = (frame_counts >= 200) & (end > start + 50) & (end <= frame_counts)
            start = torch.where(do, start, 0)
            frame_counts = torch.where(do, end - start, frame_counts)
            fvalid = masked.length_mask(frame_counts, f)
            chroma = torch.where(fvalid[..., None], _shift_frames(chroma, start), 0.0)
            energy = torch.where(fvalid, _shift_frames(energy, start), 0.0)

        weights = key_frame_weights(chroma, energy, fvalid, cfg)
        frame_mask = fvalid.to(chroma.dtype)
    with tracing.span("key.score"):
        if cfg.enable_key_ensemble:
            res = detector.detect_key_ensemble(chroma, weights, frame_mask, cfg)
        elif cfg.enable_key_multi_scale and cfg.key_multi_scale_lengths:
            res = detector.detect_key_multi_scale(chroma, weights, frame_mask, frame_counts, cfg)
        elif cfg.enable_key_segment_voting:
            res = detector.detect_key_segment_voting(chroma, weights, frame_mask, frame_counts,
                                                     cfg)
        elif cfg.enable_key_median:
            res = detector.detect_key_median(chroma, weights, frame_mask, frame_counts, cfg)
        else:
            res = detector.detect_key_weighted(chroma, weights, frame_mask, cfg)
    # a track too short for one frame: the default key, zero confidence
    ok = frame_counts > 0
    return KeyResult(key_idx=torch.where(ok, res.key_idx, 0),
                     confidence=torch.where(ok, res.confidence, 0.0),
                     clarity=torch.where(ok, res.clarity, 0.0),
                     scores=torch.where(ok[:, None], res.scores, 0.0))
