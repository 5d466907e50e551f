"""The least time an H100 could take for the work of two kernels, counted
from the tracks a window analysed, not from the launches that did it.

The arithmetic is a frozen copy of ``bound_ms`` beside the wrappers in
``stratum_dsp_tpu_torch/ops/novelty.py`` (kernel D, ``fused_novelty_features``)
and ``stratum_dsp_tpu_torch/ops/polyphase.py`` (kernel A, ``polyphase_stage2``)
at commit 83ec59a537072642745bea8c0fcfe37a5a357b67: bytes over the published
bandwidth against float32 operations over the published rate of the SIMT
units, the larger of the two. There the count is per launch, from the
launch's shape (padded chunks, halo frames); here each track's frames are
counted once, so the count holds whatever chunking or kernel does the work.
"""

from __future__ import annotations

# published peaks of one H100 SXM (NVIDIA's data sheet; at its 700 W limit)
H100_BYTES_PER_S = 3.35e12
H100_F32_OPS_PER_S = 67e12
NOVELTY_PCOLS = 128  # kernel D's packed output columns


def least_seconds(n_bytes: float, n_ops: float) -> float:
    return max(n_bytes / H100_BYTES_PER_S, n_ops / H100_F32_OPS_PER_S)


def novelty_work(frames, k: int, n_pack: int, sf_k: int, *, emit_stride2: bool,
                 emit_onset: bool, use_mel: bool) -> tuple:
    """``(bytes, ops)`` of kernel D over tracks of ``frames`` STFT frames
    each: every frame's ``k`` bins read once, the two frames of carry read
    once a track, the packed features written once; per bin the clamp and
    log1p, a ``2 sf_k + 1``-wide max filter, SuperFlux at one or two
    strides, energy and HFC, the onset flux, and per frame two operations a
    packed mel weight."""
    total = sum(frames)
    n_bytes = 4 * (total * k + len(frames) * 2 * k + total * NOVELTY_PCOLS)
    per_bin = 2 + 2 * sf_k + 5 * (2 if emit_stride2 else 1) + 6 + (6 if emit_onset else 0)
    n_ops = total * (k * per_bin + (2 * n_pack if use_mel else 0))
    return n_bytes, n_ops


def polyphase_work(frames, r: int, keep_bins: int) -> tuple:
    """``(bytes, ops)`` of kernel A over tracks of ``frames`` key STFT frames
    each: the bf16 block DFTs that feed an output read once (``frames + R -
    1`` rows, ``keep + 1`` columns of the re and im halves), the bf16
    magnitudes written once; the twiddle of those rows and columns (8), and
    per output the two ``R``-term sums, the mix and the magnitude."""
    n_bytes = n_ops = 0
    for f in frames:
        fed = (f + r - 1) * (keep_bins + 1)
        n_bytes += 2 * (2 * fed + f * keep_bins)
        n_ops += 8 * fed + f * keep_bins * (2 * (r - 1) + 21)
    return n_bytes, n_ops
