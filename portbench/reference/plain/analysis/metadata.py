"""Standalone analysis-metadata struct (the port's copy of
``stratum_dsp_tpu/analysis/metadata.py``; parity with the reference's
``src/analysis/metadata.rs:1-30``).

The reference keeps an older ``AnalysisMetadata`` in ``analysis/metadata.rs``
that was superseded by the richer version embedded in ``analysis/result.rs``
(``result.AnalysisMetadata`` here). It is kept for inventory completeness; new
code should use ``result.AnalysisMetadata``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List

from ..result import AnalysisFlag

ALGORITHM_VERSION = "0.1.0"  # the JAX package's ``__version__``


@dataclass
class LegacyAnalysisMetadata:
    """Mirror of the superseded struct (metadata.rs:7-19)."""

    algorithm_version: str = ALGORITHM_VERSION
    onset_method_consensus: float = 0.0
    methods_used: List[str] = field(default_factory=list)
    flags: List[AnalysisFlag] = field(default_factory=list)
