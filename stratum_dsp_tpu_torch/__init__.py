"""stratum_dsp_tpu_torch: the PyTorch + CUDA port of stratum_dsp_tpu.

Batched BPM + beat-grid + key analysis over a padded ``[B, T]`` track
batch, on the current CUDA device unless the caller names another
(``device="cpu"`` for the CPU). It has its own ``AnalysisConfig``
(``config.py``, field for field the JAX package's; ``from_dict`` carries one
over) and returns the same result arrays under the same keys;
``decode_results`` turns them into the same ``AnalysisResult`` objects, and
``cli/analyze_file.py`` and ``cli/analyze_batch.py`` print the same JSON from
audio files. The four TPU kernels of the main path are hand-written CUDA C++
for Hopper (``csrc/``), built with ``nvcc`` on first use; every kernel has a
plain PyTorch version that CPU tensors take.

This package imports ``torch``, never ``jax`` and nothing of the JAX
package. It runs every ``AnalysisConfig`` the JAX package runs
(``SLICE_CONFIG`` is the default with the multi-resolution escalation off),
on one device or sharded over a mesh of devices (``parallel/``: the tracks
axis, the (tracks, time) axis with halo exchange, several processes).
"""

from .config import DEFAULT_CONFIG, AnalysisConfig, NormalizationMethod, TemplateSet
from .errors import (
    AnalysisError,
    DecodingError,
    InvalidInput,
    NotImplementedYet,
    NumericalError,
    ProcessingError,
)
from .result import (
    AnalysisConfidence,
    AnalysisFlag,
    AnalysisMetadata,
    AnalysisResult,
    BeatGrid,
    Key,
    TempoCandidateDebug,
)

from . import tracing
from .analysis.pipeline import (
    SLICE_CONFIG,
    PipelineCaps,
    analyze_batch,
    analyze_batch_arrays,
)
from .analysis.decode import decode_results
from .analysis.timing import analyze_batch_timed, stage_timings
from .ops.downbeats import downbeat_mask
from .ops.hpcp import hpcp_bisect
from .ops.masked import window_median
from .ops.novelty import fused_novelty_features
from .ops.polyphase import polyphase_stage2
from .ops.stft import poly_block_dft, stft_magnitude
from .ops.viterbi import viterbi_decode

KERNELS = (polyphase_stage2, downbeat_mask, viterbi_decode, fused_novelty_features, window_median,
           hpcp_bisect, stft_magnitude, poly_block_dft)


def reset_launch_counts() -> None:
    """Set every kernel wrapper's launch count and every counter of
    ``tracing`` to 0, and drop the spans it recorded."""
    for fn in KERNELS:
        fn.launches = 0
    tracing.reset()
