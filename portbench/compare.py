"""The comparison that decides ``correct``: what the timed path produced
against the plain reference, answer by answer (a track's outputs), as two
numbers over all the answers compared:

* ``score_gap_p50``: the median over answers of an answer's widest float
  gap outside the BPM (BPM confidence, key confidence and clarity, grid
  stability, the confidence block, duration and trim start);
* ``decision_mismatch_pct``: the per cent of answers that decide otherwise:
  a BPM more than ``BPM_TOL`` off the reference's, a discrete output that
  differs in any place (``ok``, key, time signature, onset count, every
  flag, the beat and downbeat masks), a beat or downbeat time more than
  ``BEAT_TOL_S`` off where both sides mark the slot valid, or an answer
  that never came.

Why these and not the widest gaps: the port's kernel D
(``fused_novelty_features``) agrees with its plain version to the last bits
only, and on about one track in forty those bits tip a threshold (an onset
more or less, a beat grid a frame apart) and with it that track's scores.
The widest gaps (``Tally.widest``, printed on an earlier line) then swing
with such tracks from seed to seed, where the median and the share do not.

For the batch CLI the same numbers are taken over its JSON records: the
floats of a record (``bpm``; ``bpm_confidence``, ``key_confidence``,
``key_clarity``, ``grid_stability``, ``duration_seconds``), and every other
field but ``processing_time_ms`` exactly.

Each number is held to the limit of its cell (``portbench/limits/<cell>.json``).
"""

from __future__ import annotations

import numpy as np

BPM_TOL = 0.01  # BPM: the port's own output contract (stratum_dsp_tpu_torch/testing)
BEAT_TOL_S = 1e-3  # a tenth of a hop-512 frame
TIME_KEYS = (("beat_times", "beat_valid"), ("downbeat_times", "downbeat_valid"))
RECORD_FLOATS = ("bpm_confidence", "key_confidence", "key_clarity", "grid_stability",
                 "duration_seconds")
RECORD_IGNORED = ("processing_time_ms", "file")


class Tally:
    """Per-answer gaps and mismatches, gathered over a run's answers."""

    def __init__(self):
        self.score_gaps, self.bpm_gaps, self.decisions = [], [], []
        self.widest_beat_gap_s = 0.0

    def add(self, score_gap: float, bpm_gap: float, decision_differs: bool) -> None:
        self.score_gaps.append(score_gap)
        self.bpm_gaps.append(bpm_gap)
        self.decisions.append(bool(decision_differs))

    def numbers(self) -> dict:
        n = max(len(self.decisions), 1)
        differs = sum(d or g > BPM_TOL for d, g in zip(self.decisions, self.bpm_gaps))
        return {
            "score_gap_p50": float(np.median(self.score_gaps)) if self.score_gaps else 0.0,
            "decision_mismatch_pct": 100.0 * differs / n,
        }

    def widest(self) -> dict:
        return {"bpm_gap": max(self.bpm_gaps, default=0.0),
                "score_gap": max(self.score_gaps, default=0.0),
                "beat_gap_s": self.widest_beat_gap_s, "answers": len(self.decisions)}


def _gaps(x, y) -> np.ndarray:
    """``|x - y|`` in float64; a NaN or an infinity on one side only is as
    wide as a gap gets."""
    x, y = np.asarray(x, np.float64), np.asarray(y, np.float64)
    d = np.abs(x - y)
    d = np.where(np.isnan(x) & np.isnan(y), 0.0, d)
    return np.nan_to_num(d, nan=np.inf)


def add_batch(tally: Tally, got: dict, ref: dict, where=None) -> None:
    """Tally one batch's result arrays (numpy, ``[B, ...]``) against the
    reference's for the same batch. ``where`` (a set) gathers ``(track,
    output)`` of every discrete output that differs."""
    if set(got) != set(ref):
        raise ValueError(f"output keys differ: {sorted(set(got) ^ set(ref))}")
    b = ref["ok"].shape[0]
    score = np.zeros(b)
    bad = np.zeros(b, bool)
    for k in sorted(ref):
        x, y = np.asarray(got[k]), np.asarray(ref[k])
        if x.shape != y.shape:
            raise ValueError(f"{k}: shape {x.shape} where the reference has {y.shape}")
        if k in ("bpm", "beat_times", "downbeat_times"):
            continue
        if y.dtype.kind == "f":
            score = np.maximum(score, _gaps(x, y).reshape(b, -1).max(axis=1))
        else:
            differs = (x != y).reshape(b, -1).any(axis=1)
            bad |= differs
            if where is not None:
                where.update((int(r), k) for r in np.nonzero(differs)[0])
    for times, valid in TIME_KEYS:
        both = np.asarray(got[valid]) & np.asarray(ref[valid])
        d = np.where(both, _gaps(got[times], ref[times]), 0.0)
        tally.widest_beat_gap_s = max(tally.widest_beat_gap_s, float(d.max(initial=0.0)))
        off = (d > BEAT_TOL_S).any(axis=1)
        bad |= off
        if where is not None:
            where.update((int(r), times) for r in np.nonzero(off)[0])
    bpm = _gaps(got["bpm"], ref["bpm"])
    for i in range(b):
        tally.add(float(score[i]), float(bpm[i]), bad[i])


def add_record(tally: Tally, got, ref: dict) -> None:
    """Tally one JSON record of the batch CLI against the reference's record
    of the same file (``got`` None: never written)."""
    if got is None or "error" in got:
        tally.add(np.inf, np.inf, True)
        return
    score = max(float(_gaps(got.get(k, np.nan), ref[k])) for k in RECORD_FLOATS)
    others = (set(got) | set(ref)) - set(RECORD_FLOATS) - set(RECORD_IGNORED) - {"bpm"}
    tally.add(score, float(_gaps(got.get("bpm", np.nan), ref["bpm"])),
              any(got.get(k) != ref.get(k) for k in others))


def judge(numbers: dict, limits: dict) -> tuple:
    """``(correct, checks)``: every number of ``limits`` within its limit;
    ``checks`` maps each to its value and limit, in the order of ``limits``."""
    checks = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    return all(c["value"] <= c["limit"] for c in checks.values()), checks
