"""Synthetic tracks, made on the device from a few host-drawn numbers.

A track is a kick train at an integer tempo under a tonal layer: block
triads of a two-section progression in one of the 24 keys, a chord a bar,
starting after an offset. The kick is a frozen copy of ``kick_patterns`` in
``stratum_dsp_tpu_torch/testing/__init__.py``; the progression, the voicing,
the tone (six partials under 8 kHz, a 20 ms attack, an exponential decay
over the chord) and the 0.6 / 0.55 mix are frozen copies of ``chord_track``,
``_tone``, ``_note_freq`` and ``combined_track`` in
``stratum_dsp_tpu_torch/testing/battery.py``, both as of commit
83ec59a537072642745bea8c0fcfe37a5a357b67. The battery renders in float64
numpy one track at a time; here every sample is computed on the device in
float32 from per-chord tables, so that a 40 x 180 s batch takes well under a
second to make.
"""

from __future__ import annotations

import math

import numpy as np
import torch

SAMPLE_RATE = 44100
NOTE_NAMES = ["C", "C#", "D", "D#", "E", "F", "F#", "G", "G#", "A", "A#", "B"]

# (degree, chord is major, gain), two alternating sections per mode
# (battery.py:_MAJOR_SECTIONS / _MINOR_SECTIONS)
MAJOR_SECTIONS = [
    [(0, True, 1.25), (5, True, 0.8), (0, True, 1.1), (7, True, 0.8)],
    [(0, True, 1.25), (9, False, 0.75), (5, True, 0.8), (7, True, 0.8)],
]
MINOR_SECTIONS = [
    [(0, False, 1.1), (8, True, 0.85), (3, True, 0.85), (10, True, 0.9)],
    [(0, False, 1.1), (5, False, 0.85), (0, False, 1.0), (7, True, 0.9)],
]
SECTION_CHORDS = 8  # chords a section, as combined_track sets it
N_PARTIALS = 6
PARTIAL_MAX_HZ = 8000.0
ATTACK_S = 0.02


def kick_patterns(bpms, n_samples: int, device, sample_rate: int = SAMPLE_RATE,
                  kick_ms: float = 100.0, decay: float = 10.0,
                  fundamental_hz: float = 60.0) -> torch.Tensor:
    """``[B, T]`` float32 kick trains, one a tempo: a decaying 60/120/180 Hz
    sine stack at every beat, peak-normalized."""
    bpms = torch.as_tensor(np.asarray(bpms, np.float32), device=device)
    t = torch.arange(n_samples, device=device, dtype=torch.float32) / sample_rate
    ts = torch.remainder(t[None, :], (60.0 / bpms)[:, None])  # time since the last beat
    w = 2.0 * math.pi * fundamental_hz * ts
    kick = (0.6 * torch.sin(w) + 0.3 * torch.sin(2 * w) + 0.1 * torch.sin(3 * w)) \
        * torch.exp(-decay * ts)
    out = torch.where(ts < kick_ms / 1000.0, kick, 0.0)
    return out / out.abs().amax(dim=-1, keepdim=True).clamp_min(1e-9)


def note_freq(pc: int, octave: int) -> float:
    midi = 12 * (octave + 1) + pc
    return 440.0 * 2.0 ** ((midi - 69) / 12.0)


def chord_voices(tonic: int, is_major: bool, n_chords: int):
    """``(freqs, gains)`` ``[n_chords, 4]`` float64: the block voicing of
    each chord (root, third, fifth in octave 3 or 4, the root doubled in
    octave 4) and each voice's gain."""
    sections = MAJOR_SECTIONS if is_major else MINOR_SECTIONS
    freqs = np.zeros((n_chords, 4))
    gains = np.zeros((n_chords, 4))
    for ci in range(n_chords):
        prog = sections[(ci // SECTION_CHORDS) % len(sections)]
        deg, maj_triad, gain = prog[ci % len(prog)]
        root = (tonic + deg) % 12
        pcs = (root, root + (4 if maj_triad else 3), root + 7)
        for j, pc in enumerate(pcs):
            octave = 3 + (1 if j and pc % 12 < pcs[0] % 12 else 0)
            freqs[ci, j] = note_freq(pc % 12, octave)
            gains[ci, j] = gain * (0.65 if j == 0 else 0.45)
        freqs[ci, 3] = note_freq(root, 4)
        gains[ci, 3] = gain * 0.3
    return freqs, gains


def chord_layer(tonic: int, is_major: bool, bpm: float, offset_s: float, n_samples: int,
                device, sample_rate: int = SAMPLE_RATE) -> torch.Tensor:
    """``[T]`` float32: the progression of one key, a chord a bar at
    ``bpm``, silent before ``offset_s``, peak-normalized."""
    chord_s = 4.0 * 60.0 / bpm
    n_chords = max(int(math.ceil((n_samples / sample_rate - offset_s) / chord_s)), 1)
    freqs, gains = chord_voices(tonic, is_major, n_chords)
    starts = np.round((offset_s + chord_s * np.arange(n_chords)) * sample_rate).astype(np.int64)
    n = torch.arange(n_samples, device=device)
    starts_d = torch.as_tensor(starts, device=device)
    ci = (torch.searchsorted(starts_d, n, right=True) - 1).clamp_min(0)
    audible = n >= starts_d[0]
    tl = ((n - starts_d[ci]).to(torch.float32) / sample_rate).clamp_min(0.0)
    env = torch.minimum(torch.ones_like(tl), tl / ATTACK_S) * torch.exp(-tl / (chord_s * 0.9))
    out = torch.zeros(n_samples, device=device)
    for v in range(4):
        f = torch.as_tensor(freqs[:, v].astype(np.float32), device=device)[ci]
        g = torch.as_tensor(gains[:, v].astype(np.float32), device=device)[ci]
        tone = torch.zeros_like(tl)
        for h in range(1, N_PARTIALS + 1):
            tone += torch.where(f * h <= PARTIAL_MAX_HZ,
                                torch.sin((2.0 * math.pi * h) * f * tl) / h ** 1.3, 0.0)
        out += g * tone
    out = torch.where(audible, out * env, 0.0)
    return out / out.abs().max().clamp_min(1e-9)


def tracks(specs, n_samples: int, device, sample_rate: int = SAMPLE_RATE) -> torch.Tensor:
    """``[B, n_samples]`` float32 on ``device``: track ``i`` of ``specs``
    (dicts with ``bpm``, ``key`` 0-23 as ``Key.index`` counts them, 0-11
    major, ``offset_s`` and ``seconds``), zero past its own length."""
    out = torch.zeros((len(specs), n_samples), device=device)
    for i, s in enumerate(specs):
        n = int(round(s["seconds"] * sample_rate))
        kick = kick_patterns([s["bpm"]], n, device, sample_rate)[0]
        layer = chord_layer(s["key"] % 12, s["key"] < 12, s["bpm"], s["offset_s"], n, device,
                            sample_rate)
        mix = 0.6 * kick + 0.55 * layer
        out[i, :n] = mix / mix.abs().max().clamp_min(1e-9)
    return out


def key_name(idx: int) -> str:
    return NOTE_NAMES[idx % 12] + ("" if idx < 12 else "m")
