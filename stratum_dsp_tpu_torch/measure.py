"""What ``chip_smoke.py`` and ``scripts/torch_port_bench.py`` share: the
device timer, kernels A and D's inputs at the main path's shapes, and the
two real-size mixes of tracks.

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
D_VARIANTS = {"base": dict(emit_stride2=True, emit_onset=True, use_mel=True),
              "aux": dict(emit_stride2=False, emit_onset=False, use_mel=True)}
# kick tempi of the mixes; the other tracks of a batch are C-major scales.
# The adversarial mix has 28 core kicks and 12 in the escalation's trap zones
CLEAN_BPMS = np.round(np.linspace(85, 168, 32)).astype(np.float32)
ADVERSARIAL_BPMS = np.concatenate([np.round(np.linspace(85.0, 168.0, 28)),
                                   np.round(np.linspace(56.0, 79.0, 6)),
                                   np.round(np.linspace(172.0, 199.0, 6))]).astype(np.float32)


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
