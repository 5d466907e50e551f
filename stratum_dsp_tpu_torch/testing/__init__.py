"""Synthetic test signals (the port's copy of ``stratum_dsp_tpu/testing``),
and the output contract two result dicts of the pipeline are compared by.

``kick_patterns`` is the closed-form batched kick train of the reference's
``kick_pattern_device`` (also exported under that name): a 3-minute 40-track
batch is made where it is analyzed instead of crossing the host link.
``c_major_scale`` and ``silence_sandwich`` reproduce the reference's numpy
fixtures as tensors (computed in float64, rounded to float32). The numpy
generators ``kick_pattern`` and ``click_track`` (``synth.py``), the
synthetic accuracy battery (``battery.py``) and the FLAC writer
(``flac_writer.py``) are bit-for-bit copies of the reference's.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from .synth import click_track, kick_pattern

SAMPLE_RATE = 44100

# Output contract: bool/int outputs and EXACT_FLOAT_KEYS exactly, BPM to
# BPM_TOL, every other float output (beat/downbeat times in seconds,
# confidences, clarity, stability) to FLOAT_TOL.
EXACT_FLOAT_KEYS = ("duration_seconds", "trim_start_seconds")
BPM_TOL, FLOAT_TOL = 1e-2, 1e-3
# A track whose BPM novelty is rounding noise normalized to full scale (the
# silence sandwich's steady tone) has tempogram confidences that ride on the
# BPM STFT matmul's accumulation order; across matmul libraries they are held
# to NOISE_FLOOR_TOL (ROADMAP.md Queue 3).
NOISE_FLOOR_KEYS = ("bpm_confidence", "confidence_bpm_confidence",
                    "confidence_overall_confidence")
NOISE_FLOOR_TOL = 0.02
# With ``enable_key_minor_harmonic_bonus`` every minor score gains
# weight_sum * w * (leading tone - flat seventh) of the normalized mean chroma:
# a difference of two small bins times a segment's weight sum (hundreds of
# frames), which carries the ~1e-4 chroma differences between two matmul
# orders of the key STFT into the scores at 1e-3 to 6e-3 (the port differs
# from itself by that much between CPU thread counts); that config's clarity
# and confidence are held to LEADING_TONE_BONUS_TOL (ROADMAP.md Queue 3).
LEADING_TONE_BONUS_TOL = 5e-3
def assert_outputs_match(ref: dict, got: dict,
                         noise_floor_track: int | None = None) -> tuple[str, float]:
    """Hold result dict ``got`` to ``ref`` output by output (numpy arrays or
    tensors on any device) and raise ``AssertionError`` at the first output
    out of bounds. Keys, shapes and dtypes must be equal.

    ``noise_floor_track`` holds that track's NOISE_FLOOR_KEYS to
    NOISE_FLOOR_TOL.

    Returns the key and size of the largest float difference compared."""
    ref = {k: np.asarray(v.cpu()) if torch.is_tensor(v) else np.asarray(v) for k, v in ref.items()}
    got = {k: np.asarray(v.cpu()) if torch.is_tensor(v) else np.asarray(v) for k, v in got.items()}
    assert set(got) == set(ref), f"output keys differ: {sorted(set(got) ^ set(ref))}"
    worst = ("", 0.0)
    for k in sorted(ref):
        x, y = got[k], ref[k]
        assert x.shape == y.shape and x.dtype == y.dtype, (k, x.dtype, x.shape, y.dtype, y.shape)
        if y.dtype == bool or y.dtype.kind in "iu" or k in EXACT_FLOAT_KEYS:
            np.testing.assert_array_equal(x, y, err_msg=k)
            continue
        tol = BPM_TOL if k == "bpm" else FLOAT_TOL
        diff = np.abs(x - y)
        if k in NOISE_FLOOR_KEYS and noise_floor_track is not None:
            assert diff[noise_floor_track] <= NOISE_FLOOR_TOL, (k, x.tolist(), y.tolist())
            diff[noise_floor_track] = 0.0
        d = float(diff.max(initial=0.0))
        assert d <= tol, (k, d, tol, x.tolist(), y.tolist())
        if d > worst[1]:
            worst = (k, d)
    return worst


C_MAJOR_FREQS = (261.63, 293.66, 329.63, 349.23, 392.00, 440.00, 493.88, 523.25)


def kick_patterns(bpms, duration_s: float, sample_rate: int = SAMPLE_RATE, device="cpu",
                  kick_ms: float = 100.0, decay: float = 10.0,
                  fundamental_hz: float = 60.0) -> torch.Tensor:
    """``[B, T]`` float32 kick trains, one per BPM: a decaying 60/120/180 Hz
    sine stack at every beat, peak-normalized."""
    n = int(duration_s * sample_rate)
    bpms = torch.as_tensor(bpms, dtype=torch.float32, device=device)
    t = torch.arange(n, device=device, dtype=torch.float32) / sample_rate
    ts = torch.remainder(t[None, :], (60.0 / bpms)[:, None])  # time since the last beat
    w = 2.0 * math.pi * fundamental_hz * ts
    kick = (0.6 * torch.sin(w) + 0.3 * torch.sin(2 * w) + 0.1 * torch.sin(3 * w)) \
        * torch.exp(-decay * ts)
    out = torch.where(ts < kick_ms / 1000.0, kick, 0.0)
    return out / out.abs().amax(dim=-1, keepdim=True).clamp_min(1e-9)


def c_major_scale(note_s: float = 0.5, sample_rate: int = SAMPLE_RATE, fade_ms: float = 50.0,
                  device="cpu") -> torch.Tensor:
    """C-major scale (C4..C5), each note a faded sine."""
    nn = int(note_s * sample_rate)
    fade_n = int(fade_ms / 1000.0 * sample_rate)
    t = torch.arange(nn, dtype=torch.float64, device=device) / sample_rate
    env = torch.ones(nn, dtype=torch.float64, device=device)
    env[:fade_n] = torch.linspace(0.0, 1.0, fade_n, dtype=torch.float64, device=device)
    env[-fade_n:] = torch.linspace(1.0, 0.0, fade_n, dtype=torch.float64, device=device)
    out = torch.cat([torch.sin(2 * math.pi * f * t) * env for f in C_MAJOR_FREQS])
    return (out / out.abs().max()).to(torch.float32)


def silence_sandwich(silence_s: float = 5.0, audio_s: float = 5.0,
                     sample_rate: int = SAMPLE_RATE, tone_hz: float = 440.0,
                     amplitude: float = 0.5, device="cpu") -> torch.Tensor:
    """silence | tone | silence."""
    sil = torch.zeros(int(silence_s * sample_rate), dtype=torch.float32, device=device)
    t = torch.arange(int(audio_s * sample_rate), dtype=torch.float64, device=device) / sample_rate
    tone = (amplitude * torch.sin(2 * math.pi * tone_hz * t)).to(torch.float32)
    return torch.cat([sil, tone, sil])


class AllocationRecorder(TorchDispatchMode):
    """Within ``with AllocationRecorder() as rec:``, ``rec.largest`` is the
    longest axis of any tensor an op allocated, as ``(length, op, shape)``:
    an op's output that shares no storage with its inputs (a view, or the
    caller's own input, is no allocation). A time-blocked run holds it to a
    block and its context, where a whole row would be longer."""

    def __init__(self):
        super().__init__()
        self.largest = (0, "", ())

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        inputs = {t.untyped_storage().data_ptr() for t in tree_leaves((args, kwargs))
                  if isinstance(t, torch.Tensor)}
        for t in tree_leaves(out):
            if (isinstance(t, torch.Tensor) and t.numel()
                    and t.untyped_storage().data_ptr() not in inputs
                    and max(t.shape, default=1) > self.largest[0]):
                self.largest = (max(t.shape, default=1), str(func), tuple(t.shape))
        return out


def pad_batch(tracks, pad_to: int | None = None):
    """Stack 1-D tracks into a zero-padded ``[B, T]`` batch; returns
    (samples, lengths)."""
    lengths = torch.as_tensor([len(x) for x in tracks], dtype=torch.int64)
    t_max = int(pad_to if pad_to is not None else lengths.max())
    out = torch.zeros((len(tracks), t_max), dtype=torch.float32, device=tracks[0].device)
    for i, x in enumerate(tracks):
        out[i, :len(x)] = x
    return out, lengths.to(tracks[0].device)


kick_pattern_device = kick_patterns  # the reference's name for the batched kick trains
