"""Host-side decode: result tensors -> per-track ``AnalysisResult`` (port of
``stratum_dsp_tpu/analysis/decode.py``).

Mirrors the reference's result assembly (lib.rs:1595-1619) and the CLI's
JSON schema (examples/analyze_file.rs:724-731).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from .. import tracing
from ..result import AnalysisMetadata, AnalysisResult, BeatGrid, Key, TempoCandidateDebug

SIG_NAMES = {0: "4/4", 1: "3/4", 2: "6/8"}


def one_copy(tensors: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """Tensors of one device as numpy arrays through a single transfer: they
    are packed into one byte buffer where they lie (widest elements first, so
    that every entry starts aligned to its type) and cut apart on the host."""
    packed = sorted(tensors.items(), key=lambda kv: -kv[1].element_size())
    flat = torch.cat([v.contiguous().reshape(-1).view(torch.uint8) for _, v in packed])
    with tracing.host_read("results"):
        flat = flat.cpu()
    host, offset = {}, 0
    for k, v in packed:
        n = v.numel() * v.element_size()
        host[k] = flat[offset:offset + n].view(v.dtype).reshape(v.shape).numpy()
        offset += n
    return host


def to_host(out: Dict, keys=None) -> Dict[str, np.ndarray]:
    """The result dict (tensors on any device, or arrays) as numpy arrays.
    Tensors on a card come over in one transfer, so the host waits for the
    device once and not once per output. ``keys`` keeps only the entries it
    accepts."""
    out = {k: v for k, v in out.items() if keys is None or keys(k)}
    on_card = {k: v for k, v in out.items() if torch.is_tensor(v) and v.device.type != "cpu"}
    host = {k: np.asarray(v) for k, v in out.items() if k not in on_card}
    if on_card:
        host.update(one_copy(on_card))
    return host


def decode_results(out: Dict, sample_rate: int) -> List[AnalysisResult]:
    """Convert the pipeline's result dict to AnalysisResult objects."""
    host = to_host(out)
    b = host["bpm"].shape[0]
    results = []
    for i in range(b):
        beats = host["beat_times"][i][host["beat_valid"][i]].tolist()
        downbeats = host["downbeat_times"][i][host["downbeat_valid"][i]].tolist()
        grid = BeatGrid(downbeats=downbeats, beats=beats, bars=list(downbeats))

        warnings = []
        flags = []
        if host["warn_bpm_failed"][i]:
            warnings.append("BPM detection failed: insufficient onsets or estimation error")
        if host["warn_low_grid_stability"][i]:
            warnings.append(f"Low beat grid stability: {host['grid_stability'][i]:.2f} "
                            "(may indicate tempo variation)")
        if host["warn_low_key_confidence"][i]:
            warnings.append(f"Low key detection confidence: {host['key_confidence'][i]:.2f} "
                            "(may indicate ambiguous or atonal music)")
        if host["warn_low_key_clarity"][i]:
            warnings.append(f"Low key clarity: {host['key_clarity'][i]:.2f} "
                            "(track may be atonal or have weak tonality)")
            flags.append("WeakTonality")
        if host.get("confidence_flag_multimodal_bpm") is not None:
            if host["confidence_flag_multimodal_bpm"][i]:
                flags.append("MultimodalBpm")
            if host["confidence_flag_tempo_variation"][i]:
                flags.append("TempoVariation")

        cands = None
        if "cand_bpm" in host:
            cands = [
                TempoCandidateDebug(
                    bpm=float(host["cand_bpm"][i, j]),
                    score=float(host["cand_score"][i, j]),
                    fft_norm=float(host["cand_fft"][i, j]),
                    autocorr_norm=float(host["cand_ac"][i, j]),
                    selected=bool(host["cand_selected"][i, j]),
                )
                for j in range(host["cand_bpm"].shape[1])
                if host["cand_valid"][i, j]
            ]

        # Per-track method list from the pipeline's actual decision booleans.
        # The reference hardcodes exactly three entries (lib.rs:1605-1609);
        # those stay for schema compatibility, and the escalation/fallback
        # paths that actually ran (consensus, multi-res, percussive, legacy
        # -- lib.rs:1613-1617 only exposes them as separate booleans) are
        # appended so the list is truthful per track.
        methods = ["energy_flux"]
        if host.get("onset_consensus_used") is not None and bool(host["onset_consensus_used"][i]):
            methods.append("onset_consensus")
        if host.get("legacy_used") is not None and bool(host["legacy_used"][i]):
            methods.append("legacy_autocorr_comb")
        elif host["bpm"][i] > 0.0:
            methods.append("tempogram")
        if host["multi_res_used"][i]:
            methods.append("multi_resolution")
        if host["percussive_used"][i]:
            methods.append("percussive_fallback")
        methods += ["chroma_extraction", "key_detection"]

        meta = AnalysisMetadata(
            duration_seconds=float(host["duration_seconds"][i]),
            sample_rate=sample_rate,
            processing_time_ms=float(host["processing_time_ms"][i])
            if "processing_time_ms" in host else 0.0,
            onset_method_consensus=1.0 if host["onset_count"][i] > 0 else 0.0,
            methods_used=methods,
            flags=flags,
            confidence_warnings=warnings,
            tempogram_candidates=cands,
            tempogram_multi_res_triggered=bool(host["multi_res_triggered"][i]),
            tempogram_multi_res_used=bool(host["multi_res_used"][i]),
            tempogram_percussive_triggered=bool(host["percussive_triggered"][i]),
            tempogram_percussive_used=bool(host["percussive_used"][i]),
        )
        results.append(AnalysisResult(
            bpm=float(host["bpm"][i]),
            bpm_confidence=float(host["bpm_confidence"][i]),
            key=Key.from_index(int(host["key_idx"][i])),
            key_confidence=float(host["key_confidence"][i]),
            key_clarity=float(host["key_clarity"][i]),
            beat_grid=grid,
            grid_stability=float(host["grid_stability"][i]),
            metadata=meta,
        ))
    return results
