"""The plain reference the benchmark holds the port to, and its control.

``plain/`` is a frozen copy of the port's pipeline in plain PyTorch (see its
docstring). This module drives it as the benchmark needs: a batch in, the
result arrays on the host out; the JSON records the batch CLI would write
for a set of 16-bit WAV files, read here with Python's ``wave`` and padded
into the CLI's length buckets as the CLI did at the same commit; and
``lower_precision``, the control's arithmetic.

Nothing here imports ``stratum_dsp_tpu_torch``: the inputs are the
benchmark's own, and everything the pipeline derives from them is derived
again.
"""

from __future__ import annotations

import wave

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from .plain.analysis.decode import decode_results
from .plain.analysis.pipeline import PipelineCaps, analyze_batch
from .plain.config import AnalysisConfig

# the batch CLI's padded lengths (seconds): a track lands in the smallest
# that holds it, a longer one is cut to the last
# (stratum_dsp_tpu_torch/cli/analyze_batch.py:DEFAULT_BUCKETS at 83ec59a)
CLI_BUCKETS_S = (60.0, 120.0, 240.0, 420.0)


def analyze(samples: torch.Tensor, lengths: torch.Tensor, config: dict,
            sample_rate: int) -> dict:
    """The reference's result arrays for one batch, as numpy arrays: the
    pipeline under ``config`` (the ``analysis_config`` overrides and
    ``pipeline_caps`` of a configuration file) on the device the batch lies
    on."""
    cfg = AnalysisConfig.from_dict(config.get("analysis_config", {}))
    caps = PipelineCaps(**config.get("pipeline_caps", {}))
    out = analyze_batch(samples, lengths, cfg, sample_rate, caps, device=samples.device)
    return {k: v.cpu().numpy() for k, v in out.items()}


def read_wav(path: str) -> np.ndarray:
    """A 16-bit mono WAV's samples as float32, each value over 32768."""
    with wave.open(path, "rb") as w:
        if w.getsampwidth() != 2 or w.getnchannels() != 1:
            raise ValueError(f"{path}: the reference reads 16-bit mono WAVs only")
        raw = w.readframes(w.getnframes())
    return np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0


def bucket_samples(n: int, sample_rate: int) -> int:
    for b in CLI_BUCKETS_S:
        if n / sample_rate <= b:
            return int(b * sample_rate)
    return int(CLI_BUCKETS_S[-1] * sample_rate)


def file_records(paths, config: dict, sample_rate: int, device, answer=None) -> dict:
    """``{path: record}``: the batch CLI's JSON record of each file, less
    ``file``, from one reference batch a bucket (all of ``paths`` at once).
    ``answer(samples, lengths)`` stands in for the reference's pipeline
    (the control's arithmetic)."""
    if answer is None:
        def answer(samples, lengths):
            return analyze(samples, lengths, config, sample_rate)
    decoded = [read_wav(p) for p in paths]
    by_bucket: dict = {}
    for i, x in enumerate(decoded):
        by_bucket.setdefault(bucket_samples(len(x), sample_rate), []).append(i)
    records = {}
    for t, rows in sorted(by_bucket.items()):
        batch = np.zeros((len(rows), t), np.float32)
        lengths = np.zeros((len(rows),), np.int32)
        for k, i in enumerate(rows):
            x = decoded[i][:t]
            batch[k, :len(x)] = x
            lengths[k] = len(x)
        out = answer(torch.as_tensor(batch, device=device),
                     torch.as_tensor(lengths, device=device))
        for k, res in enumerate(decode_results(out, sample_rate)):
            records[paths[rows[k]]] = res.to_dict()
    return records


_MATMULS = {torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
            torch.ops.aten.addmm.default, torch.ops.aten.baddbmm.default}


class lower_precision(TorchDispatchMode):
    """The control's arithmetic: inside ``with lower_precision():`` every
    float32 matrix product takes bfloat16 operands and gives a bfloat16
    result (widened back to float32 for what follows), where the
    configuration states bfloat16-rounded operands at most and a float32
    result. The DFT operands the pipeline feeds are bfloat16 values already,
    which TF32 holds exactly, so TF32 would change nothing there; rounding
    the products is the next step down."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _MATMULS and any(isinstance(a, torch.Tensor) and a.dtype == torch.float32
                                    for a in args):
            low = [a.to(torch.bfloat16) if isinstance(a, torch.Tensor)
                   and a.dtype == torch.float32 else a for a in args]
            return func(*low, **kwargs).to(torch.float32)
        return func(*args, **kwargs)
