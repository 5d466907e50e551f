"""Batched analysis orchestrator (port of
``stratum_dsp_tpu/analysis/pipeline.py``): preprocessing -> onsets ->
streamed BPM spectral features -> tempograms + legacy estimate ->
multi-resolution escalation of the ambiguous tracks -> percussive fallback ->
BPM selection (tempogram, fused with or forced to the legacy estimate) ->
beat grid -> key -> warnings and confidence, over a padded ``[B, T]`` batch.

Every ``AnalysisConfig`` runs (``SLICE_CONFIG`` is the default with the
multi-resolution escalation off), every stage on ``device``, or sharded over
the devices of a ``parallel.mesh.Mesh``.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict

import numpy as np
import torch

from .. import tracing
from ..config import AnalysisConfig

from ..ops.masked import cdiv
from ..features.beat.grid import (fit_grid_drift, generate_beat_grid, search_downbeat_phase,
                                  search_phase_anchor)
from ..features.key.pipeline import detect_key_batch
from ..features.onset.consensus import consensus_onsets, vote_onsets
from ..features.onset.energy_flux import detect_energy_flux_onsets
from ..features.onset.hpss import hpss_decompose, percussive_energy_flux
from ..features.onset.spectral import flux_onsets_from_curve, hfc_flux
from ..features.period import legacy as legacy_mod
from ..features.period import multi_resolution as mr
from ..features.period import novelty as nov
from ..features.period import tempogram as tg
from ..features.period import tempogram_fft as tft
from ..ops.stft import stft_reduce
from ..preprocessing.normalization import normalize
from ..preprocessing.silence import detect_and_trim
from . import confidence as conf_mod

SLICE_CONFIG = AnalysisConfig(enable_tempogram_multi_resolution=False)
EPSILON = 1e-6
FAMILY_RELS = (2.0, 1.5, 4.0 / 3.0)


@dataclasses.dataclass(frozen=True)
class PipelineCaps:
    """Static capacities (sized for a 3-minute track by default). A row that
    a capacity cuts is counted in ``capped_rows`` on the call's span."""

    max_onsets: int = 2048
    max_beats: int = 1024
    seg_beat_cap: int = 64
    max_segments: int = 48
    chunk_frames: int = 256


def _collect_spec(samples, lengths, frame_size: int, hop: int, chunk_frames: int,
                  bf16: bool = False, time_mesh=None):
    """The whole magnitude spectrogram ``[B, F, K]`` and the frame counts
    (the HPSS paths only; everything else streams). Under a time axis it is
    taken in time blocks and its frames gather on the row's first device."""
    def keep(spec, fidx, fvalid, carry):
        return {"spec": spec}, carry

    if time_mesh is not None:
        from ..parallel.timeblocks import stft_reduce_sharded

        outs, _, frame_counts = stft_reduce_sharded(
            samples, lengths, frame_size, hop, keep, lambda b: None, time_mesh, prev_frames=0,
            chunk_frames=chunk_frames, bf16=bf16)
    else:
        outs, _, frame_counts = stft_reduce(samples, lengths, frame_size, hop, keep,
                                            lambda b: None, chunk_frames=chunk_frames, bf16=bf16)
    return outs["spec"], frame_counts


def _family_related(rel):
    out = torch.zeros_like(rel, dtype=torch.bool)
    for r in FAMILY_RELS:
        out = out | ((rel - r).abs() < 0.05)
    return out


def _tempogram_estimate(curves, nov_mask, n_valid, cfg, frame_rate, top_n):
    fft_size = tft.padded_fft_size(curves["full"].shape[-1], frame_rate)
    variants = tg.compute_variants(curves, nov_mask, n_valid, frame_rate, cfg, fft_size)
    return tg.estimate_bpm_tempogram(variants, cfg, frame_rate, fft_size, top_n)


# ``debug_stop_after`` boundaries, in pipeline order; "" runs to the end
STAGES = ("onsets", "legacy", "multires", "bpm_select", "grid", "")


def analyze_batch_arrays(samples: torch.Tensor, lengths: torch.Tensor, cfg: AnalysisConfig,
                         sample_rate: int, caps: PipelineCaps = PipelineCaps(),
                         debug_stop_after: str = "", mesh=None, *,
                         device=None) -> Dict[str, torch.Tensor]:
    """Run the pipeline on ``samples [B, T]`` f32 / ``lengths [B]`` on
    ``device`` (the current CUDA device when None; see ``analyze_batch``);
    returns a flat dict of result arrays [B, ...] with the keys, shapes and
    dtypes of the reference. Tracks that are empty or all silent have ``ok``
    False and zeroed outputs.

    ``debug_stop_after`` (one of ``STAGES``) returns early at that stage's
    boundary with the reference's keys there; nothing after it runs, so the
    time of such a call is the time of the prefix (``timing.stage_timings``).

    With ``cfg.emit_tempogram_candidates`` or ``cfg.debug_track_id`` the dict
    also holds the chosen estimate's candidate table (``cand_*`` [B, k]), and
    with ``cfg.debug_track_id`` the ambiguity gate's signals (``dbg_*`` [B])
    that ``debug.format_debug_dump`` prints.

    ``mesh`` (a ``parallel.mesh.Mesh``; ``device`` is then its first device
    or None): the batch is cut into one shard a row of the mesh's
    ``tracks`` axis, B divisible by its size, each shard on its row's first
    device. With a ``time`` axis (T divisible by n_time * 1024,
    ``parallel.mesh.pad_batch_for_mesh``) each time position of a row holds
    only its own block of the shard's samples (``parallel.timeblocks.
    TimeBlocks``; ``samples`` may then also be a numpy array, cut on the
    host), and every sample-domain stage (normalization, the silence RMS and
    trim shift, onset RMS, the BPM, hop-256, HPSS and key STFTs) runs block
    by block on the row's devices; the per-frame features gather on the
    row's first device, where the rest runs. The result lies on the mesh's
    first device.

    Each call is one ``analyze`` span of ``tracing`` (one a shard under a
    mesh, inside a ``mesh`` span), tiled by a span a stage."""
    if debug_stop_after not in STAGES:
        raise ValueError(f"debug_stop_after must be one of {STAGES}, got {debug_stop_after!r}")
    if mesh is not None:
        return _analyze_on_mesh(samples, lengths, cfg, sample_rate, caps, debug_stop_after, mesh,
                                device)
    device = _batch_device(samples, lengths, device)
    return _analyze(samples, lengths, device, cfg, sample_rate, caps, debug_stop_after, None,
                    samples.shape[0])


def _analyze_on_mesh(samples, lengths, cfg: AnalysisConfig, sample_rate: int, caps: PipelineCaps,
                     debug_stop_after: str, mesh, device) -> Dict[str, torch.Tensor]:
    """``analyze_batch_arrays`` over a mesh: one tracks shard a mesh row, each
    on the row's first device (in one host thread each where those devices
    are distinct CUDA devices), its chunk sizes those of the whole batch."""
    from ..parallel.mesh import TIME_QUANTUM, Mesh, check_tracks_split, map_on_devices

    if not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a parallel.mesh.Mesh, got {type(mesh).__name__}")
    grid = mesh.grid()
    home = grid[0, 0]
    if device is not None and torch.device(device) != home:
        raise ValueError(f"analyze_batch: device {device} is not the mesh's first device {home}")
    on_mesh = {str(d) for d in grid.flat}
    for x in (samples, lengths):
        if torch.is_tensor(x) and x.device.type != "cpu" and str(x.device) not in on_mesh:
            raise ValueError(f"analyze_batch: an input lies on {x.device}, which is not a "
                             "device of the mesh")
    b, t = samples.shape
    bl = check_tracks_split(b, mesh)
    n_time = mesh.shape.get("time", 1)
    if n_time > 1 and t % (n_time * TIME_QUANTUM):
        raise ValueError(f"a time axis of {n_time} needs T divisible by {n_time * TIME_QUANTUM}, "
                         f"got {t}: pad with parallel.mesh.pad_batch_for_mesh")

    def run(i):
        rows = slice(i * bl, (i + 1) * bl)
        return _analyze(samples[rows], lengths[rows], grid[i, 0], cfg, sample_rate, caps,
                        debug_stop_after, mesh.row(i) if n_time > 1 else None, b)

    with tracing.span("mesh", device=home, call=True, tracks=b):
        outs = map_on_devices(run, list(range(grid.shape[0])), list(grid[:, 0]))
        return {k: torch.cat([o[k].to(home) for o in outs]) for k in outs[0]}


def _to_device(samples, lengths, device, time_mesh):
    """The batch on ``device``: a host batch is copied there, its bytes
    counted (``h2d_bytes``); under a time axis the samples are cut into the
    ``TimeBlocks`` of ``time_mesh``, which count their own."""
    if time_mesh is not None:
        from ..parallel.timeblocks import TimeBlocks

        samples = TimeBlocks.from_samples(samples, time_mesh)
    copied = [x for x in (samples, lengths) if torch.is_tensor(x) and x.device != device]
    if copied and device.type == "cuda":
        tracing.count("h2d_bytes", sum(x.numel() * x.element_size() for x in copied
                                       if x.device.type == "cpu"))
    with tracing.host_read("to_device") if copied else contextlib.nullcontext():
        if time_mesh is None:
            samples = samples.to(device)
        lengths = lengths.to(device)
    if time_mesh is None:
        samples = samples.to(device=device, dtype=torch.float32)
    return samples, lengths.to(device=device, dtype=torch.int64)


def _analyze(samples, lengths, device, cfg: AnalysisConfig, sample_rate: int, caps: PipelineCaps,
             debug_stop_after: str, time_mesh, chunk_batch: int) -> Dict[str, torch.Tensor]:
    """The pipeline on ``device``, where a host batch is copied first.
    ``time_mesh``: a ``(1, n_time)`` mesh whose devices take the time blocks
    of ``samples`` (``parallel.timeblocks.TimeBlocks``; ``device`` is its
    first), or None; ``chunk_batch``: the batch size the key and BPM chunk
    sizes are sized for (the whole batch's, as one SPMD program sees it)."""
    with tracing.span("analyze", device=device, call=True, tracks=int(lengths.shape[0])):
        with tracing.span("to_device"):
            if device.type == "cuda":
                # f32 matmuls stay f32 (the reference's band sums are f32-exact);
                # these switches are process-wide in PyTorch
                torch.backends.cuda.matmul.allow_tf32 = False
                torch.backends.cudnn.allow_tf32 = False
            samples, lengths = _to_device(samples, lengths, device, time_mesh)
            t = samples.shape[1]
            track_ok = lengths > 0
        # the rows a capacity cut, read with the tempo variation's flag
        with tracing.capped_rows() as capped:
            out = _run_stages(samples, lengths, track_ok, t, cfg, sample_rate, caps,
                              debug_stop_after, time_mesh, chunk_batch)
        if capped.count is not None:
            tracing.count("capped_rows", capped.count)
        return out


def _run_stages(samples, lengths, track_ok, t: int, cfg: AnalysisConfig, sample_rate: int,
                caps: PipelineCaps, debug_stop_after: str, time_mesh,
                chunk_batch: int) -> Dict[str, torch.Tensor]:
    """``_analyze``'s stages after the copy to the device, one span each."""
    with tracing.span("preprocess"):
        if cfg.enable_normalization:
            samples, _ = normalize(samples, lengths, cfg.normalization, sample_rate,
                                   target_loudness_lufs=-14.0, max_headroom_db=1.0)
        trim_start = torch.zeros_like(lengths)
        if cfg.enable_silence_trimming:
            samples, lengths, sil = detect_and_trim(samples, lengths, sample_rate,
                                                    cfg.min_amplitude_db,
                                                    frame_size=cfg.frame_size, mesh=time_mesh)
            track_ok = track_ok & ~sil["all_silent"]
            trim_start = sil["trim_start"]
        duration_s = cdiv(lengths.to(torch.float32), sample_rate)

    with tracing.span("onsets"):
        e_pos, e_valid = detect_energy_flux_onsets(samples, lengths, cfg.frame_size,
                                                   cfg.hop_size, -20.0, caps.max_onsets,
                                                   mesh=time_mesh)

    with tracing.span("bpm_features"):
        if time_mesh is not None:
            from ..parallel.timeblocks import compute_bpm_spectral_features_sharded

            feats, frame_counts, _ = compute_bpm_spectral_features_sharded(
                samples, lengths, cfg, sample_rate, cfg.frame_size, cfg.hop_size, time_mesh)
        else:
            feats, frame_counts, _ = nov.compute_bpm_spectral_features(
                samples, lengths, cfg, sample_rate, cfg.frame_size, cfg.hop_size,
                chunk_frames=caps.chunk_frames, chunk_batch=chunk_batch)
        curves, nov_mask, n_valid = nov.assemble_novelty_curves(feats, frame_counts, cfg)
        frame_rate = sample_rate / cfg.hop_size

    if cfg.enable_hpss_onsets or cfg.enable_tempogram_percussive_fallback:
        with tracing.span("hpss"):
            with tracing.span("hpss.spectrogram"):
                full_spec, _ = _collect_spec(samples, lengths, cfg.frame_size, cfg.hop_size,
                                             caps.chunk_frames, bf16=cfg.stft_bf16,
                                             time_mesh=time_mesh)
            with tracing.span("hpss.decompose"):
                _, perc_spec = hpss_decompose(full_spec, frame_counts, cfg.hpss_margin)
                del full_spec

    with tracing.span("consensus"):
        onsets_pos, onsets_valid = e_pos, e_valid
        consensus_used = torch.zeros_like(track_ok)
        if cfg.enable_onset_consensus:
            s_pos, s_valid = flux_onsets_from_curve(
                feats["onset_sflux"][:, 1:], (frame_counts - 1).clamp_min(0),
                cfg.onset_threshold_percentile, cfg.hop_size, lengths, caps.max_onsets)
            hflux, h_n = hfc_flux(feats["hfc"][:, :, 0], frame_counts)
            h_pos, h_valid = flux_onsets_from_curve(hflux, h_n, cfg.onset_threshold_percentile,
                                                    cfg.hop_size, lengths, caps.max_onsets)
            if cfg.enable_hpss_onsets:
                pflux, p_n = percussive_energy_flux(perc_spec, frame_counts)
                p_pos, p_valid = flux_onsets_from_curve(pflux, p_n,
                                                        cfg.onset_threshold_percentile,
                                                        cfg.hop_size, lengths, caps.max_onsets)
            else:
                p_pos, p_valid = torch.zeros_like(e_pos), torch.zeros_like(e_valid)
            vote = vote_onsets([e_pos, s_pos, h_pos, p_pos], [e_valid, s_valid, h_valid, p_valid],
                               list(cfg.onset_consensus_weights), cfg.onset_consensus_tolerance_ms,
                               sample_rate)
            c_pos, c_valid = consensus_onsets(vote, caps.max_onsets)
            consensus_used = c_valid.any(dim=-1)
            onsets_pos = torch.where(consensus_used[:, None], c_pos, e_pos)
            onsets_valid = torch.where(consensus_used[:, None], c_valid, e_valid)

        if debug_stop_after == "onsets":
            # positions index with int64 inside the port; the boundary gives the
            # reference's int32
            return {"pos": onsets_pos.to(torch.int32), "valid": onsets_valid}

    with tracing.span("legacy"):
        legacy = legacy_mod.estimate_bpm_legacy(onsets_pos, onsets_valid, t, sample_rate, cfg)
        if debug_stop_after == "legacy":
            return dict(legacy, method_agreement=legacy["method_agreement"].to(torch.int32))

    with tracing.span("tempogram"):
        base_top_n = max(cfg.tempogram_candidates_top_n, cfg.tempogram_multi_res_top_k, 10)
        base = _tempogram_estimate(curves, nov_mask, n_valid, cfg, frame_rate, base_top_n)
        tempo_ok = frame_counts > 1

        # ambiguity gate (lib.rs:412-459)
        tol = max(2.0, cfg.bpm_resolution)
        look = lambda q: tg.cand_lookup_nearest(  # noqa: E731
            base["cand_bpm"], base["cand_score"], base["cand_valid"], q, tol)
        s_base, s_2x, s_half = look(base["bpm"]), look(base["bpm"] * 2.0), look(base["bpm"] * 0.5)
        trap_low = (base["bpm"] >= 55.0) & (base["bpm"] <= 80.0)
        trap_high = (base["bpm"] >= 170.0) & (base["bpm"] <= 200.0)
        family_competes = (((s_2x > 0.0) & (s_2x >= s_base * 0.90))
                           | ((s_half > 0.0) & (s_half >= s_base * 0.90)))
        fold_into_trap = (base["bpm"] * 2.0 >= 170.0) & (base["bpm"] * 2.0 <= 200.0)
        weak_base = (base["method_agreement"] == 0) | (base["confidence"] < 0.06)
        ambiguous = trap_low | trap_high | family_competes | (weak_base & fold_into_trap)
        mr_triggered = ambiguous & tempo_ok
        # the percussive fallback's gate: ambiguous tracks in the low trap
        perc_needed = ambiguous & trap_low
        perc_used = torch.zeros_like(perc_needed)

    with tracing.span("escalate"):
        chosen_bpm, chosen_conf = base["bpm"], base["confidence"]
        chosen_agree = base["method_agreement"]
        cand_arrays = {k: base[k] for k in mr.CAND_KEYS}
        mr_used = torch.zeros_like(ambiguous)
        if cfg.enable_tempogram_multi_resolution:
            mres = _escalate(samples, lengths, mr_triggered, cfg, sample_rate, base, feats,
                             frame_counts, curves["full"], n_valid, time_mesh)
            if mres is not None:
                rel = torch.where(
                    chosen_bpm > EPSILON,
                    torch.maximum(mres["bpm"] / chosen_bpm.clamp_min(EPSILON),
                                  chosen_bpm / mres["bpm"].clamp_min(EPSILON)), 1.0)
                family_related = _family_related(rel)
                forbid_high = (chosen_bpm <= 180.0) & (mres["bpm"] > 180.0)
                mr_better = ~forbid_high & (
                    (mres["confidence"] >= chosen_conf + 0.05)
                    | ((mres["method_agreement"] > chosen_agree)
                       & (mres["confidence"] >= chosen_conf * 0.90))
                    | ((trap_low | trap_high) & family_related
                       & (mres["confidence"] >= chosen_conf * 0.88)
                       & (((mres["bpm"] >= 70.0) & (mres["bpm"] <= 180.0))
                          | (chosen_bpm > 180.0))))
                mr_used = ambiguous & mr_better & mres["ok"]
                chosen_bpm = torch.where(mr_used, mres["bpm"], chosen_bpm)
                chosen_conf = torch.where(mr_used, mres["confidence"], chosen_conf)
                chosen_agree = torch.where(mr_used, mres["method_agreement"], chosen_agree)
                # the table follows the estimate that was chosen (the escalation's
                # is top_k wide, like the base's under the default settings)
                cand_arrays = {k: torch.where(mr_used[:, None], mres[k][:, :v.shape[-1]], v)
                               for k, v in cand_arrays.items()}

        if debug_stop_after == "multires":
            return {"bpm": chosen_bpm, "conf": chosen_conf}

    # percussive fallback (lib.rs:587-683): the tempogram of the HPSS
    # percussive part, for ambiguous tracks in the low trap
    if cfg.enable_tempogram_percussive_fallback:
        with tracing.span("percussive_fallback"):
            pfeats = nov.compute_bpm_features_from_spec(
                perc_spec, frame_counts, cfg, sample_rate, cfg.frame_size, emit_stride2=False,
                emit_onset_flux=False)
            pcurves, pmask, pn = nov.assemble_novelty_curves(pfeats, frame_counts, cfg)
            pest = _tempogram_estimate(pcurves, pmask, pn, cfg, frame_rate, base_top_n)
            rel = torch.maximum(pest["bpm"] / chosen_bpm.clamp_min(EPSILON),
                                chosen_bpm / pest["bpm"].clamp_min(EPSILON))
            forbid_high = (chosen_bpm <= 180.0) & (pest["bpm"] > 180.0)
            base_low_trap = trap_low | (base["bpm"] < 95.0)
            in_common = (pest["bpm"] >= 70.0) & (pest["bpm"] <= 180.0)
            p_better = ~forbid_high & _family_related(rel) & in_common & (
                (pest["confidence"] >= chosen_conf + 0.04)
                | (base_low_trap & (pest["confidence"] >= chosen_conf * 0.85))
                | ((pest["method_agreement"] > chosen_agree)
                   & (pest["confidence"] >= chosen_conf * 0.92)))
            perc_used = perc_needed & p_better
            chosen_bpm = torch.where(perc_used, pest["bpm"], chosen_bpm)
            chosen_conf = torch.where(perc_used, pest["confidence"], chosen_conf)

    # BPM selection (lib.rs:814-900)
    with tracing.span("select"):
        legacy_bpm = torch.where(legacy["ok"], legacy["bpm"], 0.0)
        legacy_conf = torch.where(legacy["ok"], legacy["confidence"], 0.0)
        if cfg.force_legacy_bpm:
            tempo_valid = torch.zeros_like(tempo_ok)
            bpm, bpm_confidence = legacy_bpm, legacy_conf
        else:
            tempo_valid = tempo_ok & (chosen_bpm > 0.0)
            tempo_conf = chosen_conf
            if cfg.enable_bpm_fusion:
                # the legacy estimate raises the confidence where it agrees with
                # the tempogram up to a metrical factor, and lowers it where not
                l_conf = legacy["confidence"].clamp(0.0, 1.0)
                t_conf = chosen_conf.clamp(0.0, 1.0)
                diffs = torch.stack([(legacy["bpm"] - chosen_bpm * m).abs()
                                     for m in (1.0, 0.5, 2.0, 2.0 / 3.0, 1.5)], dim=-1)
                has_legacy = legacy["ok"] & (legacy["bpm"] > 0.0)
                agree = has_legacy & (diffs <= 2.0).any(dim=-1)
                tempo_conf = torch.where(
                    agree, (t_conf + 0.12 * l_conf).clamp(0.0, 1.0),
                    torch.where(has_legacy, (t_conf * 0.90).clamp(0.0, 1.0), t_conf))
            bpm = torch.where(tempo_valid, chosen_bpm, legacy_bpm)
            bpm_confidence = torch.where(tempo_valid, tempo_conf, legacy_conf)
        bpm = torch.where(track_ok, bpm, 0.0)
        bpm_confidence = torch.where(track_ok, bpm_confidence, 0.0)
        legacy_used = track_ok & (bpm > 0.0) & ~tempo_valid
        if debug_stop_after == "bpm_select":
            return {"bpm": bpm, "conf": bpm_confidence}

    # beat grid (lib.rs:913-958)
    with tracing.span("grid"):
        onset_seconds = cdiv(onsets_pos.to(torch.float32), sample_rate)
        grid_onsets = onsets_valid & track_ok[:, None]
        phase_nov = curves["low"] + 0.5 * curves["mid"] if "low" in curves else curves["full"]
        anchor = iscale = None
        if cfg.enable_beat_phase_search:
            anchor = search_phase_anchor(bpm, onset_seconds, grid_onsets, phase_nov, n_valid,
                                         frame_rate, caps.max_beats)
            anchor, iscale = fit_grid_drift(anchor, bpm, onset_seconds, grid_onsets,
                                            caps.max_beats)
        grid = generate_beat_grid(bpm, bpm_confidence, onset_seconds, grid_onsets,
                                  max_beats=caps.max_beats, seg_beat_cap=caps.seg_beat_cap,
                                  max_segments=caps.max_segments, anchor=anchor,
                                  interval_scale=iscale, fill=cfg.enable_beat_grid_fill)
        if cfg.enable_downbeat_phase_search:
            grid = search_downbeat_phase(grid, phase_nov, n_valid, frame_rate)
        if debug_stop_after == "grid":
            return {"bpm": bpm, "stability": grid.stability}

    # key (lib.rs:961-1559)
    with tracing.span("key"):
        if cfg.enable_key_beat_synchronous:
            key = detect_key_batch(samples, lengths, cfg, sample_rate, grid.beat_times,
                                   grid.beat_valid, mesh=time_mesh, chunk_batch=chunk_batch)
        else:
            key = detect_key_batch(samples, lengths, cfg, sample_rate, mesh=time_mesh,
                                   chunk_batch=chunk_batch)
        key_ok = track_ok & (lengths >= cfg.frame_size)
        key_idx = torch.where(key_ok, key.key_idx, 0)
        key_confidence = torch.where(key_ok, key.confidence, 0.0)
        key_clarity = torch.where(key_ok, key.clarity, 0.0)

    with tracing.span("finish"):
        warn_bpm = bpm == 0.0
        warn_grid = grid.stability < 0.5
        warn_key_conf = key_confidence < 0.3
        warn_key_clarity = key_clarity < 0.2
        conf = conf_mod.compute_confidence(bpm, bpm_confidence, key_confidence, key_clarity,
                                           grid.stability, bpm_warning=warn_bpm,
                                           key_warning=warn_key_conf | warn_key_clarity)
        i32 = torch.int32
        out = {
            "ok": track_ok,
            "bpm": bpm,
            "bpm_confidence": bpm_confidence,
            "key_idx": key_idx.to(i32),
            "key_confidence": key_confidence,
            "key_clarity": key_clarity,
            "beat_times": grid.beat_times,
            "beat_valid": grid.beat_valid,
            "downbeat_times": grid.downbeat_times,
            "downbeat_valid": grid.downbeat_valid,
            "grid_stability": torch.where(track_ok, grid.stability, 0.0),
            "time_signature": grid.time_signature.to(i32),
            "has_tempo_variation": grid.has_tempo_variation,
            "duration_seconds": duration_s,
            "trim_start_seconds": cdiv(trim_start.to(torch.float32), sample_rate),
            "onset_count": onsets_valid.sum(dim=-1).to(i32),
            "onset_consensus_used": consensus_used,
            "legacy_used": legacy_used,
            "multi_res_triggered": mr_triggered,
            "multi_res_used": mr_used,
            "percussive_triggered": perc_needed if cfg.enable_tempogram_percussive_fallback
            else torch.zeros_like(perc_needed),
            "percussive_used": perc_used,
            "warn_bpm_failed": warn_bpm,
            "warn_low_grid_stability": warn_grid,
            "warn_low_key_confidence": warn_key_conf,
            "warn_low_key_clarity": warn_key_clarity,
        }
        out.update({f"confidence_{k}": v for k, v in conf.items()})
        if cfg.emit_tempogram_candidates or cfg.debug_track_id is not None:
            k = min(cfg.tempogram_candidates_top_n, cand_arrays["cand_bpm"].shape[-1])
            out.update({name: arr[:, :k] for name, arr in cand_arrays.items()})
        if cfg.debug_track_id is not None:
            # the ambiguity gate's signals and the estimate before the escalation
            # (lib.rs:461-487), formatted on the host by analysis/debug.py
            out.update(
                dbg_base_bpm=base["bpm"], dbg_base_conf=base["confidence"],
                dbg_base_agree=base["method_agreement"].to(i32),
                dbg_s_base=s_base, dbg_s_2x=s_2x, dbg_s_half=s_half,
                dbg_trap_low=trap_low, dbg_trap_high=trap_high,
                dbg_family_competes=family_competes, dbg_weak_base=weak_base,
                dbg_fold_into_trap=fold_into_trap, dbg_ambiguous=ambiguous)
        return out


def _escalate(samples, lengths, esc, cfg: AnalysisConfig, sample_rate: int, base, feats,
              frame_counts, novelty_full, n_valid, mesh=None):
    """The multi-resolution estimate of the escalated tracks ``esc [B]``
    scattered into batch-sized arrays (zeros, ``ok`` False elsewhere), or
    None when no track escalates.

    The escalated rows are gathered with one host read of their count, and
    the sub-batch keeps the batch's T, so its curve lengths and FFT sizes
    are those of the full batch. The base pass is the hop-512 pass when
    ``cfg.hop_size`` is 512: its estimate, features and novelty go along and
    only the hop-256 STFT runs anew, in time blocks under a ``mesh`` with a
    time axis (the rows gathered block by block, ``TimeBlocks.index_select``).
    (The JAX package runs the whole batch there; each row's result is the
    same, since the sub-batch keeps T.)"""
    with tracing.span("escalate.gather"):
        with tracing.host_read("escalate.nonzero"):
            idx = torch.nonzero(esc).squeeze(1)
        tracing.count("escalated_rows", idx.numel())
        if idx.numel() == 0:
            return None
        take = lambda x: x.index_select(0, idx)  # noqa: E731
        precomputed = None
        if cfg.hop_size == 512:
            precomputed = {
                "est": {k: take(base[k]) for k in mr.CAND_KEYS},
                "feats": {k: take(feats[k]) for k in ("superflux", "superflux2", "energy", "hfc",
                                                      "mel") if k in feats},
                "frame_counts": take(frame_counts),
                "novelty_full": take(novelty_full),
                "n_valid": take(n_valid),
            }
        sub_samples, sub_lengths = take(samples), take(lengths)
    sub = mr.multi_resolution_estimate(sub_samples, sub_lengths, cfg, sample_rate, precomputed,
                                       mesh=mesh)
    with tracing.span("escalate.scatter"):
        return {k: torch.zeros((esc.shape[0],) + v.shape[1:], dtype=v.dtype,
                               device=v.device).index_copy_(0, idx, v)
                for k, v in sub.items()}


def _batch_device(samples, lengths, device) -> torch.device:
    """The device the batch runs on: the current CUDA device unless ``device``
    names one (``"cpu"`` included). Raises ``RuntimeError`` when that is a
    CUDA device and none is available, and ``ValueError`` for a tensor input
    that lies on an accelerator other than ``device``: host inputs (numpy
    arrays, CPU tensors) are copied to the card, nothing else ever moves."""
    device = torch.device("cuda" if device is None else device)
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"analyze_batch runs on a CPU or CUDA device, not {device}")
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("analyze_batch: device is CUDA but no CUDA device is available; "
                               'pass device="cpu" to run on the CPU')
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    for x in (samples, lengths):
        if x.device != device and x.device.type != "cpu":
            raise ValueError(f"analyze_batch: an input lies on {x.device} but device is "
                             f"{device}; move it there first")
    return device


def analyze_batch(samples, lengths, cfg: AnalysisConfig = AnalysisConfig(),
                  sample_rate: int = 44100, caps: PipelineCaps = PipelineCaps(),
                  jit: bool = True, *, device=None,
                  debug_stop_after: str = "") -> Dict[str, torch.Tensor]:
    """User-facing entry: numpy arrays or tensors in, result-array dict out,
    every stage on ``device``. Without ``device`` the batch runs on the
    current CUDA device, and host inputs (numpy arrays, CPU tensors) are
    copied there; it raises ``RuntimeError`` when no card is present. The CPU
    is taken only on ``device="cpu"``. A tensor that lies on another
    accelerator than ``device`` raises ``ValueError``.

    ``jit`` is the JAX entry point's parameter, in its place, and does
    nothing here: PyTorch runs eagerly and has nothing to trace. The
    port's own parameters (``device``, ``debug_stop_after``) are
    keyword-only."""
    del jit
    if not torch.is_tensor(samples):
        samples = torch.as_tensor(np.asarray(samples, np.float32))
    if not torch.is_tensor(lengths):
        lengths = torch.as_tensor(np.asarray(lengths))
    with torch.no_grad():
        return analyze_batch_arrays(samples, lengths, cfg, sample_rate, caps,
                                    debug_stop_after=debug_stop_after, device=device)
