"""Analysis result types (the port's copy of ``stratum_dsp_tpu/result.py``,
field for field, so that both packages print the same JSON).

Host-side result structures mirroring the reference's
``src/analysis/result.rs`` (Key with Camelot notation, BeatGrid,
AnalysisResult/Metadata, flags). The device pipeline returns a flat dict of
tensors (see ``analysis/pipeline.py``); these classes are the user-facing
decode of one track's slice of that dict (``analysis/decode.py``).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, List, Optional

NOTE_NAMES = ["C", "C#", "D", "D#", "E", "F", "F#", "G", "G#", "A", "A#", "B"]

# Circle-of-fifths orders for Camelot-style numerical notation
# (reference result.rs:60-140).
CIRCLE_OF_FIFTHS_MAJOR = [0, 7, 2, 9, 4, 11, 6, 1, 8, 3, 10, 5]
CIRCLE_OF_FIFTHS_MINOR = [9, 4, 11, 6, 1, 8, 3, 10, 5, 0, 7, 2]


@dataclass(frozen=True)
class Key:
    """Musical key: tonic pitch class 0-11 (C..B) and mode.

    Mirrors reference ``Key::Major(u32)/Key::Minor(u32)``
    (``analysis/result.rs:6-12``).
    """

    tonic: int  # 0 = C .. 11 = B
    is_major: bool

    @staticmethod
    def major(tonic: int) -> "Key":
        return Key(tonic % 12, True)

    @staticmethod
    def minor(tonic: int) -> "Key":
        return Key(tonic % 12, False)

    @staticmethod
    def from_index(idx: int) -> "Key":
        """Decode from flat index 0-23 (0-11 major, 12-23 minor)."""
        idx = int(idx) % 24
        if idx < 12:
            return Key(idx, True)
        return Key(idx - 12, False)

    @property
    def index(self) -> int:
        """Flat 0-23 index (0-11 major, 12-23 minor)."""
        return self.tonic if self.is_major else 12 + self.tonic

    def name(self) -> str:
        """Musical notation, e.g. "C", "F#", "Am" (result.rs:31-39)."""
        base = NOTE_NAMES[self.tonic % 12]
        return base if self.is_major else base + "m"

    def numerical(self) -> str:
        """DJ numerical (Camelot-style) notation, e.g. "1A" (result.rs:60-87)."""
        if self.is_major:
            pos = CIRCLE_OF_FIFTHS_MAJOR.index(self.tonic % 12)
            return f"{pos + 1}A"
        pos = CIRCLE_OF_FIFTHS_MINOR.index(self.tonic % 12)
        return f"{pos + 1}B"

    @staticmethod
    def from_numerical(notation: str) -> Optional["Key"]:
        """Inverse of :meth:`numerical` (result.rs:113-140)."""
        if len(notation) < 2:
            return None
        num_str, suffix = notation[:-1], notation[-1]
        try:
            num = int(num_str)
        except ValueError:
            return None
        if not 1 <= num <= 12:
            return None
        if suffix == "A":
            return Key(CIRCLE_OF_FIFTHS_MAJOR[num - 1], True)
        if suffix == "B":
            return Key(CIRCLE_OF_FIFTHS_MINOR[num - 1], False)
        return None


@dataclass
class BeatGrid:
    """Beat grid (result.rs:144-154)."""

    downbeats: List[float] = field(default_factory=list)
    beats: List[float] = field(default_factory=list)
    bars: List[float] = field(default_factory=list)


class AnalysisFlag:
    """Analysis flags (result.rs:157-167)."""

    MULTIMODAL_BPM = "MultimodalBpm"
    WEAK_TONALITY = "WeakTonality"
    TEMPO_VARIATION = "TempoVariation"
    ONSET_DETECTION_AMBIGUOUS = "OnsetDetectionAmbiguous"


@dataclass
class TempoCandidateDebug:
    """Tempogram candidate diagnostics (result.rs:170-182)."""

    bpm: float
    score: float
    fft_norm: float
    autocorr_norm: float
    selected: bool


@dataclass
class AnalysisMetadata:
    """Analysis metadata (result.rs:218-263)."""

    duration_seconds: float = 0.0
    sample_rate: int = 0
    processing_time_ms: float = 0.0
    algorithm_version: str = "0.1.0-torch"
    onset_method_consensus: float = 0.0
    methods_used: List[str] = field(default_factory=list)
    flags: List[str] = field(default_factory=list)
    confidence_warnings: List[str] = field(default_factory=list)
    tempogram_candidates: Optional[List[TempoCandidateDebug]] = None
    tempogram_multi_res_triggered: Optional[bool] = None
    tempogram_multi_res_used: Optional[bool] = None
    tempogram_percussive_triggered: Optional[bool] = None
    tempogram_percussive_used: Optional[bool] = None


@dataclass
class AnalysisResult:
    """Complete analysis result (result.rs:185-215)."""

    bpm: float = 0.0
    bpm_confidence: float = 0.0
    key: Key = field(default_factory=lambda: Key.major(0))
    key_confidence: float = 0.0
    key_clarity: float = 0.0
    beat_grid: BeatGrid = field(default_factory=BeatGrid)
    grid_stability: float = 0.0
    metadata: AnalysisMetadata = field(default_factory=AnalysisMetadata)

    def to_dict(self) -> Dict:
        """JSON-serializable dict matching the reference CLI output schema."""
        return {
            "bpm": self.bpm,
            "bpm_confidence": self.bpm_confidence,
            "key": self.key.name(),
            "key_numerical": self.key.numerical(),
            "key_confidence": self.key_confidence,
            "key_clarity": self.key_clarity,
            "grid_stability": self.grid_stability,
            "beat_count": len(self.beat_grid.beats),
            "downbeat_count": len(self.beat_grid.downbeats),
            "duration_seconds": self.metadata.duration_seconds,
            "sample_rate": self.metadata.sample_rate,
            "processing_time_ms": self.metadata.processing_time_ms,
            "flags": list(self.metadata.flags),
            "methods_used": list(self.metadata.methods_used),
            "confidence_warnings": list(self.metadata.confidence_warnings),
            "tempogram_multi_res_triggered": self.metadata.tempogram_multi_res_triggered,
            "tempogram_multi_res_used": self.metadata.tempogram_multi_res_used,
            "tempogram_percussive_triggered": self.metadata.tempogram_percussive_triggered,
            "tempogram_percussive_used": self.metadata.tempogram_percussive_used,
            "tempogram_candidates": (
                [dataclasses.asdict(c) for c in self.metadata.tempogram_candidates]
                if self.metadata.tempogram_candidates is not None
                else None
            ),
        }


@dataclass
class AnalysisConfidence:
    """Comprehensive confidence scores (analysis/confidence.rs:33-68)."""

    bpm_confidence: float = 0.0
    key_confidence: float = 0.0
    grid_stability: float = 0.0
    overall_confidence: float = 0.0
    flags: List[str] = field(default_factory=list)

    def is_high_confidence(self) -> bool:
        return self.overall_confidence >= 0.7

    def is_low_confidence(self) -> bool:
        return self.overall_confidence < 0.5

    def is_medium_confidence(self) -> bool:
        return 0.5 <= self.overall_confidence < 0.7

    def confidence_level(self) -> str:
        if self.is_high_confidence():
            return "High"
        if self.is_low_confidence():
            return "Low"
        return "Medium"
