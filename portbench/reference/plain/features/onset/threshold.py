"""Adaptive median + MAD threshold (port of
``stratum_dsp_tpu/features/onset/threshold.py``, threshold.rs:30-72). A
utility of the package's surface; the pipeline does not call it. One global
threshold over the valid values: median + k * median(|values - median|), an
even count averaging the two middle elements. A windowed per-position variant
stands beside it.
"""

from __future__ import annotations

import torch

from ...ops import masked


def _masked_median(x: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Median over the valid entries of the last axis; an even count averages
    the middle two."""
    n = x.shape[-1]
    s = masked.masked_sort(x, valid)
    cnt = valid.sum(dim=-1)
    take = lambda i: torch.gather(s, -1, i.clamp(0, n - 1)[..., None])[..., 0]  # noqa: E731
    return 0.5 * (take((cnt - 1) // 2) + take(cnt // 2))


def adaptive_threshold_median_mad(x: torch.Tensor, valid: torch.Tensor,
                                  k: float = 1.5) -> torch.Tensor:
    """Global median + k * MAD over the valid entries: one value per leading
    batch element."""
    med = _masked_median(x, valid)
    mad = _masked_median((x - med[..., None]).abs(), valid)
    return med + k * mad


def adaptive_threshold_median_mad_windowed(x: torch.Tensor, window: int,
                                           k: float = 1.5) -> torch.Tensor:
    """Per-position variant over a centered window."""
    half = max(window, 1) // 2
    med = masked.median_filter_1d_select_nth(x, half)
    mad = masked.median_filter_1d_select_nth((x - med).abs(), half)
    return med + k * mad
