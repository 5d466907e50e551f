"""What ``chip_smoke.py`` and ``scripts/torch_port_bench.py`` share: the
device timer, the kernels' inputs at the main path's shapes, the empty launch
that latency-bound kernels are held against, the two real-size mixes of
tracks, a mix written out as WAV files, and the opt-in configurations that
are measured at the real size with the run that measures them.

The port is imported by its absolute name inside each function, so that a
script which loads this file on its own (``torch_port_bench.py --tree DIR``)
times another checkout's port with this checkout's inputs and timer. Nothing
here is on the analysis path.
"""

from __future__ import annotations

import numpy as np
import torch

B_REAL, SECONDS_REAL = 40, 180.0  # the real-size batch: tracks, seconds each at 44.1 kHz
# kernel A on the main path: R, ext (a 192-frame chunk + 2 * 12), keep, KP
STAGE2_SHAPE = (16, 216, 931, 1024)
# kernel A under enable_key_log_frequency, which keeps every bin of the
# 8192-point STFT: R, ext, keep, KP
STAGE2_WIDE_SHAPE = (16, 216, 4097, 4224)
D_VARIANTS = {"base": dict(emit_stride2=True, emit_onset=True, use_mel=True),
              "aux": dict(emit_stride2=False, emit_onset=False, use_mel=True)}
# kick tempi of the mixes; the other tracks of a batch are C-major scales.
# The adversarial mix has 28 core kicks and 12 in the escalation's trap zones
CLEAN_BPMS = np.round(np.linspace(85, 168, 32)).astype(np.float32)
ADVERSARIAL_BPMS = np.concatenate([np.round(np.linspace(85.0, 168.0, 28)),
                                   np.round(np.linspace(56.0, 79.0, 6)),
                                   np.round(np.linspace(172.0, 199.0, 6))]).astype(np.float32)


# The opt-in configurations measured at the real size (overrides of the
# default config; "loudness" is the NormalizationMethod's value), and what
# each changes in a batch's launches: key STFT passes (81 launches of kernel A
# each), one whole-track launch of kernel D by the percussive fallback, the
# windowed medians (the chroma smoothing's one, and two an HPSS iteration),
# and the HPCP kernel's (one a key chunk where the bisection picks the peaks).
OPT_IN_CONFIGS = {
    "hpss": dict(overrides=dict(enable_hpss_onsets=True,
                                enable_tempogram_percussive_fallback=True,
                                normalization="loudness"), key_passes=1, whole_track_d=1,
                 medians=21, hpcp=81),
    "tuned-exact": dict(overrides=dict(enable_key_tuning_compensation=True,
                                       key_hpcp_approx_peaks=False), key_passes=2,
                        whole_track_d=0, medians=1, hpcp=0),
    "log-frequency": dict(overrides=dict(enable_key_log_frequency=True, enable_key_hpcp=False),
                          key_passes=1, whole_track_d=0, medians=1, hpcp=0),
}


def cuda_time_ms(fn, reps: int) -> float:
    """Device time of one call of ``fn``, between two CUDA events."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    # keep the card busy for ~20 ms while the host queues the launches, so
    # that the events time the device and not the host's launch path
    torch.cuda._sleep(30_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def empty_launch_ms(blocks: int, threads: int, smem: int = 0, reps: int = 200) -> float:
    """Device time of one launch of an empty kernel of that grid, by the same
    timer: the measured floor under a kernel that is bound by latency."""
    from stratum_dsp_tpu_torch.ops import cuda_build

    lib = cuda_build.library()

    def launch():
        cuda_build.check(lib.stratum_empty_launch(
            blocks, threads, smem, torch.cuda.current_stream().cuda_stream), "empty_launch")

    return cuda_time_ms(launch, reps)


def walk_inputs(device, seed: int = 11) -> dict:
    """Kernel B's inputs at the main path's shape, N = 3072 beat slots for 40
    tracks: ``times``, ``bar``, and two sets of counts. ``n_beats_drawn`` is
    drawn from 1..N-1 with rows of 0 and N, and rows 0-3 land beats exactly
    on the +-10% edges of one bar; ``n_beats_main`` is what the main path
    gives: the beats of a 180 s track at 85-168 BPM."""
    import stratum_dsp_tpu_torch as port

    caps = port.PipelineCaps()
    n = max(caps.max_segments * caps.seg_beat_cap, caps.max_beats)
    rng = np.random.default_rng(seed)
    bar = torch.as_tensor(rng.uniform(1.2, 3.0, B_REAL).astype(np.float32), device=device)
    times = torch.cumsum((bar / 4.0)[:, None] * torch.as_tensor(
        rng.uniform(0.9, 1.1, (B_REAL, n)).astype(np.float32), device=device), dim=1)
    k = torch.arange(n, device=device, dtype=torch.float32)
    for row, sign in ((0, 1.0), (1, -1.0), (2, 1.0), (3, -1.0)):
        times[row] = k * (bar[row] * (1.0 + sign * 0.1) / 4.0)
    drawn = torch.as_tensor(rng.integers(1, n, B_REAL), device=device, dtype=torch.int32)
    drawn[0], drawn[1], drawn[4], drawn[5] = n, n, 0, n
    bpms = np.round(np.linspace(85.0, 168.0, B_REAL))
    main = torch.as_tensor(np.floor(SECONDS_REAL * bpms / 60.0), device=device, dtype=torch.int32)
    return {"times": times, "bar": bar, "n_beats_drawn": drawn, "n_beats_main": main}


def decode_inputs(device, seed: int = 12) -> dict:
    """Kernel C's inputs at the main path's shape, [40, 1024]: ``em`` has
    uniform(0.01, 1) rows, a row of 1e-3 that underflows through denormals to
    0, and rows with a zero tail; ``em_aligned`` (rows of 1.0: every beat on
    an onset, the longest-lived probabilities the HMM's emissions can give)
    sinks to the smallest denormal after ~530 frames and stays there;
    ``em_steady`` (rows near 1.21 = 0.85 / 0.7, the inverse of the edge
    states' normalized self-transition) neither underflows nor overflows. The
    decode of either walks every frame."""
    import stratum_dsp_tpu_torch as port

    t = port.PipelineCaps().max_beats
    rng = np.random.default_rng(seed)
    em = torch.as_tensor(rng.uniform(0.01, 1.0, (B_REAL, t)).astype(np.float32), device=device)
    em[0] = 1e-3
    em[1, 300:] = 0.0
    em[2, :300], em[2, 300:] = 1e-3, 0.0
    steady = torch.full((B_REAL, t), 1.21, device=device)
    steady[1::2] *= torch.as_tensor(rng.uniform(0.97, 1.03, (B_REAL // 2, t)).astype(np.float32),
                                    device=device)
    return {"em": em, "em_aligned": torch.ones((B_REAL, t), device=device), "em_steady": steady}


# kernels B and C past shared memory: a batch of whole two-hour mixes under
# portbench/configs/longmix.json (8 rows; 36,001 beat slots, the downbeat
# walk's 1,800 x 64 = 115,200)
LONG_ROWS, LONG_FRAMES, LONG_SLOTS = 8, 36001, 115200


def long_decode_inputs(device, t: int = LONG_FRAMES, seed: int = 13) -> torch.Tensor:
    """Kernel C's long-path input ``[8, t]``: rows near 1.21 (steady and
    jittered) and of 1.0 that walk every frame, a row of 1e-3 that dies out
    in ~15 frames, a row of uniform(0.01, 1) emissions, a row whose emissions
    end two thirds of the way in (a track shorter than the batch's longest),
    and an empty row (all 0)."""
    rng = np.random.default_rng(seed)
    em = np.full((LONG_ROWS, t), 1.21, np.float32)
    em[1] *= rng.uniform(0.97, 1.03, t).astype(np.float32)
    em[2] = 1.0
    em[3] = 1e-3
    em[4] = rng.uniform(0.01, 1.0, t).astype(np.float32)
    em[5] *= rng.uniform(0.97, 1.03, t).astype(np.float32)
    em[5, 2 * t // 3:] = 0.0
    em[6] = 0.0
    em[7, t // 2:] = 1.0
    return torch.as_tensor(em, device=device)


def long_walk_inputs(device, n: int = LONG_SLOTS, seed: int = 14) -> dict:
    """Kernel B's long-path inputs ``[8, n]``: sorted times at a quarter bar
    (+-10% jitter), a row on the -10% edge of one bar, one unsorted;
    beat counts of 0 (an empty row), 1, one slot past a tile of 4,096, ~20k
    (a two-hour mix at ~168 BPM) and n."""
    rng = np.random.default_rng(seed)
    bar = rng.uniform(1.2, 3.0, LONG_ROWS).astype(np.float32)
    times = np.cumsum((bar[:, None] / np.float32(4.0))
                      * rng.uniform(0.9, 1.1, (LONG_ROWS, n)).astype(np.float32),
                      axis=1).astype(np.float32)
    k = np.arange(n, dtype=np.float32)
    times[1] = k * (bar[1] * np.float32(0.9) / np.float32(4.0))
    times[2] = rng.permutation(times[2])
    counts = np.asarray([n, n, n - 1, 0, 1, 4097, 20160, min(n, 8191)], np.int32)
    return {"times": torch.as_tensor(times, device=device),
            "n_beats": torch.as_tensor(counts, device=device),
            "bar": torch.as_tensor(bar, device=device)}


def stage2_input(rng: np.random.Generator, b: int, ext: int, kp: int, device,
                 spare_rows: int = 0) -> torch.Tensor:
    """Random bf16 block DFTs ``[b, EBP, 2 kp]`` for ``ext`` frames at R = 16."""
    r = STAGE2_SHAPE[0]
    ebp = -(-(ext + r) // r) * r + spare_rows
    bd = rng.standard_normal((b, ebp, 2 * kp), np.float32) * 4.0
    return torch.as_tensor(bd, device=device).to(torch.bfloat16)


def kernel_inputs(device, seed: int = 7):
    """``(bd, r, ext, keep)`` of kernel A and ``(spec, prev2, tables)`` of
    kernel D at the main path's shapes: B = 40, ``[40, 240, 2048]`` block
    DFTs, and a 256-frame chunk of the 2048-point BPM STFT with the zeroed
    frames past a track's end."""
    import stratum_dsp_tpu_torch as port
    from stratum_dsp_tpu_torch import testing
    from stratum_dsp_tpu_torch.features.period.novelty import novelty_tables

    rng = np.random.default_rng(seed)
    r, ext, keep, kp = STAGE2_SHAPE
    bd = stage2_input(rng, B_REAL, ext, kp, device)
    tables = novelty_tables(port.AnalysisConfig(), testing.SAMPLE_RATE, 2048)
    spec = torch.as_tensor(rng.random((B_REAL, 256, tables.n_bins), np.float32) * 3.0,
                           device=device)
    spec[5, 100:] = 0.0
    prev2 = torch.as_tensor(rng.random((B_REAL, 2, tables.n_bins), np.float32), device=device)
    return (bd, r, ext, keep), (spec, prev2, tables)


def whole_track_spectrogram(device, seed: int = 13):
    """Kernel D's inputs as the percussive fallback gives them: ``(spec,
    prev2, tables)`` with ``spec [40, F, 1025]`` f32 made on the card, F the
    2048/512 frame count of a 180 s track, rows past a shorter track's count
    zeroed, and a zero carry."""
    import stratum_dsp_tpu_torch as port
    from stratum_dsp_tpu_torch import testing
    from stratum_dsp_tpu_torch.features.period.novelty import novelty_tables

    tables = novelty_tables(port.AnalysisConfig(), testing.SAMPLE_RATE, 2048)
    frames = (int(SECONDS_REAL * testing.SAMPLE_RATE) - 2048) // 512 + 1
    gen = torch.Generator(device=device).manual_seed(seed)
    spec = torch.rand((B_REAL, frames, tables.n_bins), generator=gen, device=device) * 3.0
    spec[5, frames // 3:] = 0.0
    prev2 = torch.zeros((B_REAL, 2, tables.n_bins), device=device)
    return spec, prev2, tables


def opt_in_config(name: str):
    """The port's ``AnalysisConfig`` of an entry of ``OPT_IN_CONFIGS``."""
    import stratum_dsp_tpu_torch as port

    return port.AnalysisConfig.from_dict(OPT_IN_CONFIGS[name]["overrides"])


def timed_batches(batch, lengths, cfg, device, timed: int) -> dict:
    """A warm-up, then ``timed`` batches of ``cfg`` on the card, each ended by
    a synchronise: the walls, the last batch's result, the launch counts of
    the first timed batch (every count set to 0 just before it) and the peak
    device memory over the timed batches."""
    import time

    import stratum_dsp_tpu_torch as port

    walls, launches, out = [], None, None
    for i in range(timed + 1):
        if i == 1:
            torch.cuda.reset_peak_memory_stats(device)
        port.reset_launch_counts()
        t0 = time.perf_counter()
        out = port.analyze_batch(batch, lengths, cfg, device=device)
        torch.cuda.synchronize(device)
        if i:
            walls.append(time.perf_counter() - t0)
        if i == 1:
            launches = {fn.__name__: fn.launches for fn in port.KERNELS}
    return {"walls_s": walls, "out": out, "launches": launches,
            "peak_memory_gb": torch.cuda.max_memory_allocated(device) / 1e9}


def hpss_stage_times(batch, lengths, cfg, device) -> dict:
    """Seconds of the HPSS path's own stages on ``batch``, each between two
    synchronisations: the materialized BPM spectrogram, the decomposition, and
    the reducer over the whole percussive spectrogram (one launch of kernel D)."""
    import time

    from stratum_dsp_tpu_torch import testing
    from stratum_dsp_tpu_torch.analysis.pipeline import _collect_spec
    from stratum_dsp_tpu_torch.features.onset.hpss import hpss_decompose
    from stratum_dsp_tpu_torch.features.period.novelty import compute_bpm_features_from_spec

    def timed(fn):
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize(device)
        return res, time.perf_counter() - t0

    out = {}
    with torch.no_grad():
        (spec, counts), out["collect_spec_s"] = timed(lambda: _collect_spec(
            batch, lengths, cfg.frame_size, cfg.hop_size, 256, bf16=cfg.stft_bf16))
        (_, perc), out["hpss_decompose_s"] = timed(
            lambda: hpss_decompose(spec, counts, cfg.hpss_margin))
        del spec
        _, out["features_from_spec_s"] = timed(lambda: compute_bpm_features_from_spec(
            perc, counts, cfg, testing.SAMPLE_RATE, cfg.frame_size, emit_stride2=False,
            emit_onset_flux=False))
    return out


def real_size_mixes(device):
    """``({"clean": batch, "adversarial": batch}, lengths)``: 40 tracks x
    180 s made on ``device``, kicks at the mix's tempi and scales."""
    from stratum_dsp_tpu_torch import testing

    n_samples = int(SECONDS_REAL * testing.SAMPLE_RATE)
    scale = testing.c_major_scale(device=device)
    scale = scale.repeat(-(-n_samples // scale.shape[0]))[:n_samples]

    def make_batch(bpms):
        kicks = testing.kick_patterns(bpms, SECONDS_REAL, device=device)
        rest = scale[None, :].expand(B_REAL - len(bpms), n_samples)
        return torch.cat([kicks, rest], dim=0)

    lengths = torch.full((B_REAL,), n_samples, dtype=torch.int64, device=device)
    return {"clean": make_batch(CLEAN_BPMS), "adversarial": make_batch(ADVERSARIAL_BPMS)}, lengths


def write_wavs(batch: torch.Tensor, directory) -> tuple:
    """``batch [B, T]`` f32 as 16-bit mono WAVs ``track_00.wav`` ... under
    ``directory``; returns ``(paths, samples)`` where ``samples [B, T]`` f32,
    on the batch's device, is what decoding those files gives sample for
    sample (the 16-bit values over 32768)."""
    import wave
    from pathlib import Path

    from stratum_dsp_tpu_torch import testing

    x16 = (batch.clamp(-1.0, 1.0) * 32767.0).to(torch.int16)
    host = x16.cpu().numpy()
    paths = []
    for i, row in enumerate(host):
        paths.append(str(Path(directory) / f"track_{i:02d}.wav"))
        with wave.open(paths[-1], "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(testing.SAMPLE_RATE)
            w.writeframes(row.astype("<i2").tobytes())
    return paths, x16.to(torch.float32) / 32768.0
