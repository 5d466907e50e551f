"""Masked-array helpers (port of ``stratum_dsp_tpu/ops/masked.py``).

Per-track quantities keep the JAX package's padded shapes with per-track
valid lengths/masks, so every result compares array by array with the
reference. All functions work on the last axis, the median filters on any
(``dim``); leading axes broadcast. The windowed median is a CUDA kernel on the
card (``csrc/window_median.cu``) with its plain version beside it.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from .. import tracing
from . import cuda_build

EPSILON = 1e-10


def rdiv(num: float, x: torch.Tensor) -> torch.Tensor:
    """``num / x`` as a true division. PyTorch's ``scalar / tensor`` is
    ``x.reciprocal() * scalar``, which rounds twice and differs from the
    reference's division in the last bit."""
    with tracing.host_read("masked.rdiv"):
        num = x.new_tensor(num)
    return torch.div(num, x)


def fma(a, b, c) -> torch.Tensor:
    """``a * b + c`` of f32 operands (python floats taken as f32) rounded
    once to f32. The reference's compiled XLA:CPU code contracts such
    multiply-adds into FMAs; where a decision rides on the last bit (grid
    positions, near-tied scores) the port rounds the same way. The product
    is exact in f64, so the f64 sum rounds like an FMA."""
    f64 = lambda x: x.double() if torch.is_tensor(x) else float(np.float32(x))  # noqa: E731
    return (f64(a) * f64(b) + f64(c)).to(torch.float32)


def cdiv(x: torch.Tensor, c: float) -> torch.Tensor:
    """``x / c`` for a constant ``c`` as the reference's compiled code (and
    CUDA PyTorch) computes it: multiplication by the f32 reciprocal. XLA
    rewrites division by a constant this way, so a true division would
    differ from the reference in the last bit."""
    return x * float(np.float32(1.0) / np.float32(c))


# The reference's compiled f32 sums, in the order XLA:CPU adds: a prefix sum
# (``jnp.cumsum``, a reduce-window) is rewritten into a scan of 16-wide blocks
# whose block totals are scanned the same way, recursively; a reduction over
# a long axis is rewritten into sums of 32-wide blocks whose totals are summed
# the same way. Each block is added left to right. Where a decision rides on
# the last bit of such a sum (a frame's RMS beside a peak-pick threshold, the
# time signature of a perfectly regular grid), the port adds in that order.
SCAN_BLOCK = 16
SUM_BLOCK = 32


def _sequential_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum along the last axis, added left to right."""
    acc = x[..., 0]
    for k in range(1, x.shape[-1]):
        acc = acc + x[..., k]
    return acc


def _sequential_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Prefix sums along the last axis, added left to right."""
    out = torch.empty_like(x)
    acc = out[..., 0] = x[..., 0]
    for k in range(1, x.shape[-1]):
        acc = out[..., k] = acc + x[..., k]
    return out


def scan_sum(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Inclusive prefix sums along ``dim`` in XLA:CPU's order for
    ``jnp.cumsum``."""
    x = x.movedim(dim, -1)
    n = x.shape[-1]
    if n <= SCAN_BLOCK:
        out = _sequential_cumsum(x)
    else:
        nb = -(-n // SCAN_BLOCK)
        inner = _sequential_cumsum(
            F.pad(x, (0, nb * SCAN_BLOCK - n)).reshape(*x.shape[:-1], nb, SCAN_BLOCK))
        before = F.pad(scan_sum(inner[..., -1])[..., :-1], (1, 0))
        out = (inner + before[..., None]).reshape(*x.shape[:-1], nb * SCAN_BLOCK)[..., :n]
    return out.movedim(-1, dim)


def tree_sum(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """The sum along ``dim`` in XLA:CPU's order for ``jnp.sum`` over an axis
    of 2^k - 1 or a multiple of 32 elements (the beat-slot and block widths
    the pipeline sums over)."""
    x = x.movedim(dim, -1)
    while x.shape[-1] > SUM_BLOCK:
        nb = -(-x.shape[-1] // SUM_BLOCK)
        x = _sequential_sum(F.pad(x, (0, nb * SUM_BLOCK - x.shape[-1]))
                            .reshape(*x.shape[:-1], nb, SUM_BLOCK))
    return _sequential_sum(x)


def sqrt_f32(x: torch.Tensor) -> torch.Tensor:
    """The f32 square root rounded as IEEE rounds it, as XLA and CUDA do:
    PyTorch's CPU kernel is one ulp off on ~0.7% of inputs, so the root is
    taken in f64 and rounded once."""
    return torch.sqrt(x.to(torch.float64)).to(torch.float32)


def length_mask(n: torch.Tensor, size: int) -> torch.Tensor:
    """Boolean mask [..., size] that is True for indices < n."""
    return torch.arange(size, device=n.device) < n[..., None]


def masked_max(x: torch.Tensor, mask: torch.Tensor, initial: float = 0.0) -> torch.Tensor:
    return torch.where(mask, x, initial).amax(dim=-1)


def masked_sum(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return torch.where(mask, x, 0.0).sum(dim=-1)


def masked_mean(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return masked_sum(x, mask) / mask.sum(dim=-1).clamp_min(1)


def normalize_by_max(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Divide by the masked max where it exceeds EPSILON (novelty.rs:935-942)."""
    mx = masked_max(x, mask)[..., None]
    return torch.where(mx > EPSILON, x / mx.clamp_min(EPSILON), x)


def _window_sums(x: torch.Tensor, half_left: int, half_right: int) -> torch.Tensor:
    """Sums over [i-half_left, i+half_right] clamped to the array bounds."""
    n = x.shape[-1]
    c0 = F.pad(torch.cumsum(x, dim=-1), (1, 0))  # c0[i] = sum of x[:i]
    idx = torch.arange(n, device=x.device)
    lo = (idx - half_left).clamp(0, n)
    hi = (idx + half_right + 1).clamp(0, n)
    return c0[..., hi] - c0[..., lo]


def moving_average(x: torch.Tensor, mask: torch.Tensor, window: int) -> torch.Tensor:
    """Centered moving average clamped to the valid region
    (novelty.rs:970-986)."""
    if window <= 1:
        return x
    half = window // 2
    sums = _window_sums(torch.where(mask, x, 0.0), half, half)
    cnts = _window_sums(mask.to(x.dtype), half, half)
    return torch.where(mask, sums / cnts.clamp_min(1.0), x)


def local_mean_subtract(x: torch.Tensor, mask: torch.Tensor, window: int) -> torch.Tensor:
    """max(0, x - centered moving mean) (novelty.rs:947-967)."""
    if window == 0:
        return x
    half = max(window, 1) // 2
    sums = _window_sums(torch.where(mask, x, 0.0), half, half)
    cnts = _window_sums(mask.to(x.dtype), half, half)
    out = (x - sums / cnts.clamp_min(1.0)).clamp_min(0.0)
    return torch.where(mask, out, x)


def max_pool_1d(x: torch.Tensor, radius: int) -> torch.Tensor:
    """Sliding max over [i-radius, i+radius] on the last axis, edge-clamped."""
    if radius <= 0:
        return x
    shape = x.shape
    flat = F.pad(x.reshape(-1, 1, shape[-1]), (radius, radius), value=float("-inf"))
    return F.max_pool1d(flat, 2 * radius + 1, stride=1).reshape(shape)


def windowed_any(x: torch.Tensor, left: int, right: int) -> torch.Tensor:
    """Boolean OR over the window [i-left, i+right] on the last axis."""
    shape = x.shape
    flat = F.pad(x.reshape(-1, 1, shape[-1]).to(torch.float32), (left, right))
    return F.max_pool1d(flat, left + right + 1, stride=1).reshape(shape) > 0.0


def masked_sort(x: torch.Tensor, mask: torch.Tensor, fill: float = float("inf")) -> torch.Tensor:
    """Ascending sort with invalid entries filled and pushed to the end."""
    return torch.sort(torch.where(mask, x, fill), dim=-1, stable=True).values


def masked_percentile_value(x: torch.Tensor, mask: torch.Tensor, pct: float) -> torch.Tensor:
    """Sorted valid values at floor(n_valid * pct), clamped to n_valid-1
    (spectral_flux.rs:163-170)."""
    s = masked_sort(x, mask)
    n_valid = mask.sum(dim=-1)
    idx = (n_valid.to(torch.float32) * pct).to(torch.int64)
    idx = torch.minimum(idx.clamp_min(0), (n_valid - 1).clamp_min(0))
    return torch.gather(s, -1, idx[..., None])[..., 0]


def masked_median(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Sorted valid values at n_valid // 2 (no even averaging, lib.rs:1257)."""
    s = masked_sort(x, mask)
    n_valid = mask.sum(dim=-1)
    idx = torch.minimum(n_valid // 2, (n_valid - 1).clamp_min(0))
    return torch.gather(s, -1, idx[..., None])[..., 0]


def valid_extent(valid: torch.Tensor) -> int:
    """Slots up to and including the last valid entry of any row (one host
    read): greedy walks stop there, since no later slot can be kept."""
    pos = torch.arange(1, valid.shape[-1] + 1, device=valid.device)
    if not valid.numel():
        return 0
    with tracing.host_read("masked.valid_extent"):
        return int(torch.where(valid, pos, 0).amax())


def greedy_dedup_sorted(values: torch.Tensor, valid: torch.Tensor, tol: float) -> torch.Tensor:
    """Keep entry i iff value[i] - value[last_kept] >= tol, over ascending
    values (tempogram.rs:561-570); a loop over slots. Returns the keep mask."""
    last = torch.full(values.shape[:-1], float("-inf"), dtype=values.dtype,
                      device=values.device)
    keep = torch.zeros_like(valid)
    for i in range(valid_extent(valid)):
        v = values[..., i]
        k = valid[..., i] & ((v - last) >= tol)
        last = torch.where(k, v, last)
        keep[..., i] = k
    return keep


def searchsorted_nearest(query: torch.Tensor, sorted_vals: torch.Tensor, n_valid: torch.Tensor,
                         big: float):
    """Nearest entry of each row's ascending ``sorted_vals`` (invalid entries
    sort last) to each query: returns (value, distance). Ties go to the
    lower neighbour; rows without a valid entry give distance ``big``."""
    k = sorted_vals.shape[-1]
    idx = torch.searchsorted(sorted_vals.contiguous(), query.contiguous())
    lo = (idx - 1).clamp(0, k - 1)
    hi = idx.clamp(0, k - 1)
    o_lo = torch.gather(sorted_vals, -1, lo)
    o_hi = torch.gather(sorted_vals, -1, hi)
    d_lo = torch.where(idx > 0, (query - o_lo).abs(), big)
    d_hi = torch.where(idx < n_valid[..., None], (query - o_hi).abs(), big)
    return torch.where(d_lo <= d_hi, o_lo, o_hi), torch.minimum(d_lo, d_hi)


# elements of the window stack (rows x positions x window) one sort of the
# plain version may hold; larger inputs go through it a slab of rows at a time
MEDIAN_SLAB_ELEMENTS = 1 << 28
# the widest half-width the kernel keeps in registers (kMaxRegisterHalf in
# csrc/window_median.cu); wider windows take its general path
MEDIAN_REGISTER_HALF = 32


def window_median_plain(x: torch.Tensor, n_valid, half: int, average_even: bool,
                        dim: int = -1) -> torch.Tensor:
    """Plain PyTorch version of ``window_median``: every window sorted with
    its out-of-range entries as +inf at the end, ``MEDIAN_SLAB_ELEMENTS``
    window elements at a time, so the result is a selection from ``x`` (or
    the mean of two) whatever the slab size. Another ``dim`` than the last is
    moved last first."""
    d = dim % x.dim()
    if d != x.dim() - 1:
        if n_valid is not None:
            nv = torch.as_tensor(n_valid, device=x.device).expand(x.shape[:d])
            n_valid = nv.reshape(nv.shape + (1,) * (x.dim() - d - 1))
        return window_median_plain(x.movedim(d, -1), n_valid, half,
                                   average_even).movedim(-1, d)
    n = x.shape[-1]
    flat = x.reshape(-1, n)
    if n_valid is None:
        nv = torch.full((flat.shape[0],), n, device=x.device)
    else:
        nv = torch.as_tensor(n_valid, device=x.device).expand(x.shape[:-1]).reshape(-1)
        nv = nv.clamp(max=n)
    idx = torch.arange(n, device=x.device)
    lo = (idx - half).clamp_min(0)
    out = torch.empty_like(flat)
    rows = max(1, MEDIAN_SLAB_ELEMENTS // (n * (2 * half + 1)))
    for r0 in range(0, flat.shape[0], rows):
        sl = slice(r0, r0 + rows)
        valid = idx < nv[sl, None]
        windows = F.pad(torch.where(valid, flat[sl], float("inf")), (half, half),
                        value=float("inf")).unfold(-1, 2 * half + 1, 1)
        s = windows.sort(dim=-1).values
        cnt = (torch.minimum(idx + half, nv[sl, None] - 1) - lo + 1).clamp_min(1)
        mid = cnt // 2
        med = torch.gather(s, -1, mid[..., None])[..., 0]
        if average_even:
            mid = torch.where(cnt % 2 == 0, mid - 1, mid)
            med = 0.5 * (med + torch.gather(s, -1, mid[..., None])[..., 0])
        out[sl] = torch.where(valid, med, flat[sl])
    return out.reshape(x.shape)


def window_median_shape(x: torch.Tensor, dim: int, half: int) -> tuple:
    """``(outer, n, inner)``: ``x`` as the kernel views it, the filtered axis
    ``dim`` in the middle. Raises ``ValueError`` on what the kernel does not
    take: another dtype than f32, a layout that is not contiguous, a
    negative half-width, an axis of 2^31 or more."""
    if x.dtype != torch.float32:
        raise ValueError(f"window_median kernel takes f32, got {x.dtype}")
    if x.dim() == 0 or not x.is_contiguous():
        raise ValueError(f"window_median kernel takes a contiguous tensor of one axis or more, "
                         f"got shape {tuple(x.shape)} with strides {x.stride()}")
    if half < 0:
        raise ValueError(f"window_median: half-width {half} < 0")
    d = dim % x.dim()
    shape = (math.prod(x.shape[:d]), x.shape[d], math.prod(x.shape[d + 1:]))
    if max(shape) >= 1 << 31:
        raise ValueError(f"window_median kernel takes axes below 2^31, got {shape}")
    return shape


def window_median_bound_ms(outer: int, n: int, inner: int, half: int) -> dict:
    """The least time an H100 could take for one call on ``[outer, n, inner]``.

    Bytes: every f32 cell read once and written once, 8 B a cell, over
    3.35 TB/s. Operations: a sliding median has to keep its window's order
    under one insert and one delete a cell, which takes at least
    2 * ceil(log2(2 * half + 1)) comparisons (two binary searches); over
    67 TFLOP/s that time is far below the bytes', so the bound is set by
    bytes."""
    cells = outer * n * inner
    return cuda_build.roofline(8 * cells, cells * 2 * math.ceil(math.log2(2 * half + 1)))


def window_median(x: torch.Tensor, n_valid, half: int, average_even: bool,
                  dim: int = -1) -> torch.Tensor:
    """Median of the window [i-half, i+half] along ``dim``, clipped to each
    row's valid range [0, n_valid), at every position i of that axis.
    ``n_valid`` broadcasts against ``x.shape[:dim]`` (None: the whole axis)
    and is clipped to the axis; entries at i >= n_valid come back unchanged.
    An even count averages the two middle values or, without
    ``average_even``, takes element count // 2.

    A CPU tensor takes the plain version; a CUDA tensor launches
    ``csrc/window_median.cu`` on ``x`` as it lies, or raises."""
    if x.device.type == "cpu":
        return window_median_plain(x, n_valid, half, average_even, dim)
    if x.device.type != "cuda":
        raise ValueError(f"window_median: unsupported device {x.device}")
    outer, n, inner = window_median_shape(x, dim, half)
    out = torch.empty_like(x)
    if not out.numel():
        return out
    nv = None
    if n_valid is not None:
        nv = torch.as_tensor(n_valid, device=x.device).expand(x.shape[:dim % x.dim()])
        nv = nv.reshape(-1).clamp(0, n).to(torch.int32).contiguous()
    lib = cuda_build.library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.stratum_window_median(x.data_ptr(), None if nv is None else nv.data_ptr(),
                                       out.data_ptr(), outer, n, inner, half, int(average_even),
                                       stream)
    cuda_build.check(rc, "window_median")
    tracing.count_launch(window_median)
    return out


window_median.launches = 0


def median_filter_1d(x: torch.Tensor, half: int, dim: int = -1) -> torch.Tensor:
    """Centered median filter along ``dim``, the window [i-half, i+half]
    clipped to the array; an even count averages the two middle values
    (hpss.rs:196-201)."""
    return window_median(x, None, half, True, dim)


def masked_median_filter_1d(x: torch.Tensor, n_valid: torch.Tensor, half: int,
                            dim: int = -1) -> torch.Tensor:
    """``median_filter_1d`` with the window clipped to each row's valid range
    [0, n_valid) (hpss.rs:179-243); ``n_valid`` broadcasts against
    ``x.shape[:dim]`` and entries at i >= n_valid come back unchanged."""
    return window_median(x, n_valid, half, True, dim)


def median_filter_1d_select_nth(x: torch.Tensor, half: int, dim: int = -1) -> torch.Tensor:
    """Median filter that takes the single element at index count // 2 of the
    clipped window, with no even-count averaging (``select_nth_unstable``,
    extractor.rs:1430-1438)."""
    return window_median(x, None, half, False, dim)


def masked_select_nth_filter_1d(x: torch.Tensor, n_valid: torch.Tensor, half: int,
                                dim: int = -1) -> torch.Tensor:
    """``median_filter_1d_select_nth`` with the window clipped to each row's
    valid range [0, n_valid) (smoothing.rs:37-94); ``n_valid`` broadcasts
    against ``x.shape[:dim]`` and entries at i >= n_valid come back
    unchanged."""
    return window_median(x, n_valid, half, False, dim)


def distance_to_nearest_true(mask: torch.Tensor, big: float = 1e9) -> torch.Tensor:
    """Distance in indices, along the last axis, from each position to the
    nearest True entry (f32); ``big`` in rows without one."""
    n = mask.shape[-1]
    idx = torch.arange(n, device=mask.device)
    last = torch.where(mask, idx, -1).cummax(dim=-1).values
    nxt = torch.where(mask, idx, 2 * n).flip(-1).cummin(dim=-1).values.flip(-1)
    fwd = torch.where(last >= 0, (idx - last).to(torch.float32), big)
    bwd = torch.where(nxt < 2 * n, (nxt - idx).to(torch.float32), big)
    return torch.minimum(fwd, bwd)


def top_k_masked(x: torch.Tensor, mask: torch.Tensor, k: int, fill: float = float("-inf")):
    """The k largest masked entries of the last axis as (values, indices),
    ties to the lowest index; slots beyond the valid entries hold ``fill``."""
    vals, idx = torch.sort(torch.where(mask, x, fill), dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]
