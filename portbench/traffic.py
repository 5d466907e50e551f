"""The one generator of traffic: a mix file of ``portbench/traffic/`` and a
seed in, the tracks' specs out.

A mix file holds only numbers and names (see ``traffic/*.json``):

* ``driver``: the loop that sends the tracks (``portbench/drivers.py``);
* ``track_seconds`` or ``lengths_s`` with ``tracks_per_length``: how long
  the tracks are;
* ``trap_share``, ``core_bpm``, ``trap_low_bpm``, ``trap_high_bpm``: the
  tempo mix of ``bench.py:64-84``, the escalation's trap zones at a share of
  the tracks (``n_trap = max(2, round(trap_share * n))``, half of them low);
* ``tonal_offset_s``: the range the tonal layer's start is drawn from;
* the driver's own parameters (``ring``, ``copies``, ``trace_seconds``).

Every seed gets the same tempi and lengths, paired alike, so that two seeds
differ only in the keys and offsets of the tonal layers and, for a driver
that sends tracks one at a time, in their order: the seed changes what the
answers are, not how much work they take.
"""

from __future__ import annotations

import numpy as np

N_KEYS = 24
PAIRING_SEED = 0  # the one fixed order that pairs tempi with lengths


def tempo_groups(n: int, mix: dict):
    """``[(count, lo, hi), ...]`` of the core and the two trap zones for
    ``n`` tracks (``bench.py``'s formula)."""
    n_trap = max(2, int(round(mix["trap_share"] * n))) if n > 2 else 0
    lo = n_trap // 2
    return [(n - n_trap, *mix["core_bpm"]), (lo, *mix["trap_low_bpm"]),
            (n_trap - lo, *mix["trap_high_bpm"])]


def tempi(n: int, mix: dict) -> tuple:
    """``(tempi, zones)`` of ``n`` tracks: each group's integer tempi evenly
    over its range, as ``bench.py`` rounds them; core first, then the low
    and the high trap zone. The same for every seed."""
    bpms, zones = [], []
    for zone, (count, lo, hi) in zip(("core", "low", "high"), tempo_groups(n, mix)):
        bpms += np.round(np.linspace(lo, hi, count)).tolist()
        zones += [zone] * count
    return np.asarray(bpms, np.float64), zones


def draw_keys(n: int, rng: np.random.Generator) -> np.ndarray:
    """Key indices 0-23: every key once in each run of 24 tracks."""
    runs = -(-n // N_KEYS)
    return np.concatenate([rng.permutation(N_KEYS) for _ in range(runs)])[:n]


def track_lengths(mix: dict) -> list:
    """Each track's seconds: ``track_seconds`` for a batch of the config's
    size, or ``tracks_per_length`` tracks of each of ``lengths_s``."""
    if "lengths_s" in mix:
        return [float(s) for s in mix["lengths_s"] for _ in range(mix["tracks_per_length"])]
    return None


def draw_specs(mix: dict, n: int, rng: np.random.Generator) -> list:
    """``n`` track specs (``bpm``, ``zone``, ``key``, ``offset_s``,
    ``seconds``). Tempi and lengths are the same for every seed, paired in
    one fixed order; the seed draws each track's key and offset. With
    ``lengths_s`` in the mix, ``n`` is the number of lengths times
    ``tracks_per_length``."""
    lengths = track_lengths(mix)
    if lengths is not None:
        n = len(lengths)
    else:
        lengths = [float(mix["track_seconds"])] * n
    bpms, zones = tempi(n, mix)
    pairing = np.random.default_rng(PAIRING_SEED).permutation(n)
    keys = draw_keys(n, rng)
    lo, hi = mix["tonal_offset_s"]
    offsets = rng.uniform(lo, hi, n)
    return [{"bpm": float(bpms[pairing[i]]), "zone": zones[pairing[i]], "key": int(keys[i]),
             "offset_s": float(offsets[i]), "seconds": lengths[i]} for i in range(n)]
