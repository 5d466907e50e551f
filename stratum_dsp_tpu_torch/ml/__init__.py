"""Phase-2 ML refinement stubs (the port's copy of ``stratum_dsp_tpu/ml``).

Mirror of reference ``src/ml/`` (feature-gated ``--features ml``): ONNX-based
BPM/key refinement placeholders that raise ``NotImplementedYet``
(ml/onnx_model.rs:14-40, ml/refinement.rs:21-30) and an edge-case detector
returning no findings (ml/edge_cases.rs:17-20).
"""

from .refinement import MlRefinement, OnnxModel, detect_edge_cases
