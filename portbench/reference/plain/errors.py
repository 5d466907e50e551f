"""Error types (the port's copy of ``stratum_dsp_tpu/errors.py``; mirror of
reference ``src/error.rs:7-22``).

In the batched pipeline, per-track failures cannot abort the batch; they
degrade gracefully exactly like the reference's ``Result`` downgrades
(``lib.rs:894-899, 932-943, 1542-1551``): failed stages produce zeroed outputs
plus warning flags. These exceptions are raised only for host-side validation
errors (empty input, bad sample rate, bad config).
"""


class AnalysisError(Exception):
    """Base analysis error."""


class InvalidInput(AnalysisError):
    """Invalid input (empty samples, zero sample rate, bad params)."""


class ProcessingError(AnalysisError):
    """Processing failed (e.g. audio entirely silent after trimming)."""


class DecodingError(AnalysisError):
    """Audio decode failed."""


class NumericalError(AnalysisError):
    """Numerical instability encountered."""


class NotImplementedYet(AnalysisError):
    """Feature not implemented (reference: ``NotImplemented``)."""
