"""Analysis orchestration: the batched ``analyze_batch`` pipeline,
confidence scoring, and host-side result decoding."""

from .pipeline import PipelineCaps, analyze_batch, analyze_batch_arrays
from .confidence import compute_confidence
from .decode import decode_results
from .timing import analyze_batch_timed, stage_timings
from .metadata import LegacyAnalysisMetadata
