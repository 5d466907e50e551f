"""Stage-boundary observability: logging, wall timings, per-stage timing
(port of ``stratum_dsp_tpu/analysis/timing.py``).

Equivalent of the reference's per-stage ``log::debug`` lines and
``processing_time_ms`` stamping (lib.rs:91-92, 700-706, 1603;
tempogram.rs:720-755):

* ``analyze_batch_timed`` wraps the pipeline call with wall-clock timing (the
  wall ends after ``torch.cuda.synchronize()`` on a card), stamps
  ``processing_time_ms`` into the result dict, and logs a host-side batch
  summary (escalation/fallback/warning counts) at DEBUG: the batch analogue
  of the reference's per-decision stderr lines.
* ``stage_timings`` measures cumulative per-stage time by running the
  pipeline truncated at each ``debug_stop_after`` boundary. PyTorch runs
  eagerly and removes no dead code, so a prefix is timed by stopping there:
  nothing after the boundary is launched. Differences give per-stage costs.
"""

from __future__ import annotations

import logging
import time
from typing import Dict

import numpy as np
import torch

from .. import tracing
from ..config import AnalysisConfig
from .decode import to_host
from .pipeline import STAGES, PipelineCaps, analyze_batch

logger = logging.getLogger("stratum_dsp_tpu_torch")


def _wait(out: Dict[str, torch.Tensor]) -> None:
    """Return when every tensor of ``out`` is computed."""
    devices = {v.device for v in out.values() if v.device.type == "cuda"}
    for dev in devices:
        with tracing.host_read("timing.wait"):
            torch.cuda.synchronize(dev)


def analyze_batch_timed(samples, lengths, cfg: AnalysisConfig = AnalysisConfig(),
                        sample_rate: int = 44100, caps: PipelineCaps = PipelineCaps(), *,
                        device=None) -> Dict[str, torch.Tensor]:
    """The full pipeline + wall timing + batch-summary DEBUG log, on ``device``
    (the current CUDA device when None, as ``analyze_batch``).

    Adds ``processing_time_ms`` [B] (per-track share of the batch wall time,
    the batch analogue of lib.rs:91-92) to the result dict.
    """
    t0 = time.time()
    out = dict(analyze_batch(samples, lengths, cfg, sample_rate, caps, device=device))
    _wait(out)
    dt_ms = (time.time() - t0) * 1e3
    b = out["bpm"].shape[0]
    out["processing_time_ms"] = torch.full((b,), float(np.float32(dt_ms / max(b, 1))),
                                           dtype=torch.float32, device=out["bpm"].device)

    if logger.isEnabledFor(logging.DEBUG):
        counted = ("multi_res_triggered", "multi_res_used", "percussive_used", "ok",
                   "warn_low_grid_stability")
        n = {k: int(v.sum()) for k, v in to_host(out, keys=counted.__contains__).items()}
        logger.debug(
            "analyze_batch: b=%d ok=%d wall=%.1fms (%.2fms/track) "
            "multi_res triggered=%d used=%d percussive_used=%d "
            "low_stability=%d",
            b, n["ok"], dt_ms, dt_ms / max(b, 1), n["multi_res_triggered"], n["multi_res_used"],
            n["percussive_used"], n["warn_low_grid_stability"],
        )
    return out


def stage_timings(samples, lengths, cfg: AnalysisConfig = AnalysisConfig(),
                  sample_rate: int = 44100, caps: PipelineCaps = PipelineCaps(),
                  reps: int = 2, perturb: bool = True, *, device=None) -> Dict[str, float]:
    """Cumulative + per-stage wall seconds for each pipeline prefix.

    Returns ``{stage: cumulative_s, stage+"_delta": s_since_previous}`` for
    the stages of ``pipeline.STAGES`` (the last is ``"full"``): each prefix
    runs once untimed, then ``reps`` times, and the median counts.

    ``perturb`` is the JAX entry point's parameter, in its place, and does
    nothing here: it nudged the input so that a remote result cache could
    not serve a memoized answer, and no cache stands between PyTorch and the
    card. ``device`` is keyword-only.
    """
    del perturb
    out: Dict[str, float] = {}
    prev = 0.0
    for stage in STAGES:
        times = []
        for i in range(reps + 1):
            t0 = time.time()
            _wait(analyze_batch(samples, lengths, cfg, sample_rate, caps, device=device,
                                debug_stop_after=stage))
            if i:  # the first call warms up (allocator, kernel build, tables)
                times.append(time.time() - t0)
        cum = float(np.median(times))
        name = stage or "full"
        out[name] = cum
        out[name + "_delta"] = cum - prev
        prev = cum
        logger.info("stage %-10s cumulative %7.1f ms  delta %7.1f ms",
                    name, cum * 1e3, out[name + "_delta"] * 1e3)
    return out
