"""ML refinement placeholders (reference ``src/ml/*.rs``; the port's copy of
``stratum_dsp_tpu/ml/refinement.py``)."""

from __future__ import annotations

from typing import List

from ..errors import NotImplementedYet


class OnnxModel:
    """Placeholder for a learned refinement model (ml/onnx_model.rs:14-40)."""

    def __init__(self, path: str):
        self.path = path

    @staticmethod
    def load(path: str) -> "OnnxModel":
        raise NotImplementedYet("ML model loading is a Phase-2 feature")

    def infer(self, features):
        raise NotImplementedYet("ML inference is a Phase-2 feature")


class MlRefinement:
    """Placeholder for ML-based result refinement (ml/refinement.rs:21-30)."""

    def refine_bpm(self, result):
        raise NotImplementedYet("ML BPM refinement is a Phase-2 feature")

    def refine_key(self, result):
        raise NotImplementedYet("ML key refinement is a Phase-2 feature")


def detect_edge_cases(result) -> List[str]:
    """Edge-case detector: returns no findings (ml/edge_cases.rs:17-20)."""
    return []
